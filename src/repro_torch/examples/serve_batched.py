"""Serve a small model with batched requests, the port's counterpart of the
reference's ``examples/serve_batched.py``: prefill by decoding the prompt
(the cache fills token by token), then batched greedy generation with a KV
cache or recurrent state under the default serving plan.  Compares two
archs (dense KV cache against recurrent O(1) state) on the same harness,
at their smoke widths.

    python -m repro_torch.examples.serve_batched                # the card
    python -m repro_torch.examples.serve_batched --device cpu
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.launch.dryrun import default_plan
from repro_torch.models.model import init_cache, model_specs
from repro_torch.models.params import init_params
from repro_torch.serve.registry import serving_shape
from repro_torch.serve.step import make_decode_step


def generate(arch: str, batch: int = 4, prompt_len: int = 8,
             gen_len: int = 24, cache_len: int = 64, device="cuda"):
    """Greedy tokens (batch, gen_len) of ``arch``'s smoke config."""
    dev = resolve_device(device)
    cfg = get_arch(arch).smoke()
    plan = default_plan(cfg, serving_shape(batch, cache_len))
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(0),
                         dev)
    step = make_decode_step(cfg, plan, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=torch.Generator().manual_seed(1)
                            ).to(dev)
    caches = init_cache(cfg, batch, cache_len, dev)

    # prefill by decoding the prompt (the cache fills token by token)
    for pos in range(prompt_len):
        nxt, _, caches = step(params, caches, prompts[:, pos], pos)
    # batched greedy generation
    out = []
    t0 = time.perf_counter()
    tok = nxt
    for pos in range(prompt_len, prompt_len + gen_len):
        tok, _, caches = step(params, caches, tok, pos)
        out.append(tok)
    seqs = torch.stack(out, dim=1).cpu()       # waits for the last step
    dt = time.perf_counter() - t0
    print(f"[{arch}] {batch} seqs x {gen_len} tokens on {dev.type} "
          f"in {dt:.2f}s ({batch * gen_len / dt:.1f} tok/s)  "
          f"sample={seqs[0][:10].tolist()}")
    return seqs


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.serve_batched")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    print("dense KV-cache arch:")
    dense = generate("granite-8b", device=args.device)
    print("recurrent O(1)-state arch (no KV growth):")
    recurrent = generate("recurrentgemma-2b", device=args.device)
    return {"granite-8b": dense, "recurrentgemma-2b": recurrent}


if __name__ == "__main__":
    main()
