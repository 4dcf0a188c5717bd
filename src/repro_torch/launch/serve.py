"""Serving CLI: continuous-batching greedy decoding under a ComParX plan.

Thin CLI over :class:`repro_torch.serve.engine.ServeEngine` and
:class:`repro_torch.serve.registry.PlanRegistry`.  The plan resolves as
the reference's does: the ``--plan`` file (a plan fused by either package
loads unchanged) > a ``--registry-db`` lookup (keyed by the actual
``--batch``/``--cache-len`` serving shape, with the nearest-traffic-shape
fallback) > the built-in default plan.  Runs on the card unless
``--device cpu``.

Usage:
  python -m repro_torch.launch.serve --arch granite-8b
  python -m repro_torch.launch.serve --arch granite-8b --smoke --device cpu
  python -m repro_torch.launch.serve --arch chatglm3-6b
  python -m repro_torch.launch.serve --arch recurrentgemma-2b
  python -m repro_torch.launch.serve --arch xlstm-125m --smoke --device cpu
  python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b
  python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --smoke \
      --device cpu
  python -m repro_torch.launch.serve --arch stablelm-3b --smoke --batch 4 \
      --cache-len 64 --registry-db ${TMPDIR:-/tmp}/registry.db --device cpu

``--arch`` takes every arch of ``repro_torch.configs.ARCHS``: the dense
archs stablelm-3b, granite-8b, chatglm3-6b, starcoder2-3b,
phi-3-vision-4.2b and musicgen-large (the last two serve token prompts:
their stub frontends' ``embeds`` feed training and prefill only, as in
the reference), the recurrent archs recurrentgemma-2b and xlstm-125m,
and the MoE archs qwen3-moe-30b-a3b (57 GiB of bf16 weights: one H100
holds it) and kimi-k2-1t-a32b (1.03 T parameters: no single card holds
it).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import ARCHS, get_arch
from repro_torch.core.plan import Plan
from repro_torch.launch.dryrun import default_plan
from repro_torch.launch.mesh import destroy_group, launch_mesh
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.registry import PlanRegistry, serving_shape


def synthetic_requests(n: int, vocab: int, *, prompt_len: int,
                       tokens: int, seed: int):
    """Deterministic seeded request stream (varying prompts/lengths)."""
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        p = max(1, prompt_len + int(rng.randint(-1, 2)))
        prompt = tuple(int(t) for t in rng.randint(0, vocab, size=p))
        reqs.append(Request(rid=f"r{i}", prompt=prompt,
                            max_new_tokens=tokens))
    return reqs


def resolve_plan(cfg, shape, *, plan_path=None, registry_db=None):
    """--plan file > registry lookup (nearest shape) > default plan.
    Returns ``(plan, source)``: ``file:<path>``, ``registry`` (the exact
    serving shape), ``registry~<shape>`` (the nearest one) or
    ``default``."""
    if plan_path:
        return Plan.load(plan_path), f"file:{plan_path}"
    if registry_db:
        entry = PlanRegistry(registry_db).lookup(cfg, shape)
        if entry is None:
            raise SystemExit(
                f"[serve] no plan registered for {cfg.name} "
                f"{shape.kind}:{shape.seq_len}x{shape.global_batch} in "
                f"{registry_db}: run a sweep with registry= first "
                f"(python -m repro_torch.serve.registry)")
        src = "registry" if entry.exact else f"registry~{entry.shape}"
        return entry.plan, src
    return default_plan(cfg, shape), "default"


def serve(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True,
                    help="an arch of repro_torch.configs.ARCHS: "
                         + ", ".join(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="slot capacity (the batch of the decode step)")
    ap.add_argument("--tokens", type=int, default=32,
                    help="max new tokens per request")
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--plan", default=None, help="plan JSON file")
    ap.add_argument("--registry-db", default=None,
                    help="resolve the plan from this PlanRegistry DB")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=4)
    ap.add_argument("--max-active", type=int, default=None,
                    help="admission throttle (1 = sequential baseline)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)

    mesh = launch_mesh(args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    # the serving shape IS the CLI's deployment: --cache-len x --batch
    shape = serving_shape(args.batch, args.cache_len)
    plan, src = resolve_plan(cfg, shape, plan_path=args.plan,
                             registry_db=args.registry_db)
    print(f"[serve] arch={cfg.name} batch={args.batch} "
          f"cache={args.cache_len} plan={src} device={args.device}")

    engine = ServeEngine(cfg, plan, capacity=args.batch,
                         cache_len=args.cache_len, seed=args.seed,
                         device=args.device, mesh=mesh)
    reqs = synthetic_requests(args.requests, cfg.vocab_size,
                              prompt_len=args.prompt_len,
                              tokens=args.tokens, seed=args.seed)
    done = engine.run(reqs, max_active=args.max_active)
    for r in reqs:
        c = done[r.rid]
        print(f"[serve] {r.rid}: prompt={c.prompt_len} "
              f"-> {len(c.tokens)} tokens ({c.finish_reason}) "
              f"{c.tokens[:8]}{'...' if len(c.tokens) > 8 else ''}")
    print(f"[serve] {engine.stats.summary()}")
    return done


if __name__ == "__main__":
    try:
        serve()
    finally:
        destroy_group()     # the launcher's group, if launch_mesh joined one
