"""Quickstart: tune a model with ComParX and train with the fused plan, the
port's counterpart of the reference's ``examples/quickstart.py``.

Sweeps (provider x flags x clause) per segment of granite-8b at train
shape with the wall-clock executor, fuses the per-segment winners, prints
the report, the plan and the uniform baselines, then trains a few steps
with the fused plan and saves it.

    python -m repro_torch.examples.quickstart               # the card
    python -m repro_torch.examples.quickstart --smoke --device cpu

Without ``--smoke`` the model is granite-8b at full width cut to
``--layers`` layers (full depth with f32 AdamW state needs 99 GB), B=1,
S=4096, swept over remat {none, dots} x kernel {plain, cuda}.  With
``--smoke`` it is the reference's example: the smoke config and shape and
the reference's clause space (plain kernels only).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import torch

from repro_torch.configs import get_arch, get_shape
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.tuner import ComParTuner
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import LAUNCHES
from repro_torch.train.step import init_train_state, make_train_step

PROVIDERS = ["tensor_par", "fsdp"]
#: the reference example's space, kernel names mapped
SMOKE_SPACE = {"remat": ("none", "dots"), "kernel": ("plain",),
               "block_q": (16,), "block_k": (16,), "scan_unroll": (1,),
               "mlstm_chunk": (16,)}
SPACE = {"remat": ("none", "dots"), "kernel": ("plain", "cuda")}


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python -m "
                                 "repro_torch.examples.quickstart")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the reference example's smoke config and space")
    ap.add_argument("--layers", type=int, default=8,
                    help="granite-8b's depth, cut (without --smoke)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--plan-out", default=None,
                    help="where to save the plan (default: $TMPDIR)")
    return ap.parse_args(argv)


def main(argv=None):
    """Sweep, fuse, print, train, save.  Returns what it measured (the
    tuner, plan, report, baselines, losses, step times, kernel launches a
    step and the steps' peak memory), for callers that check it."""
    args = parse_args(sys.argv[1:] if argv is None else argv)

    # 1) an architecture and a shape
    if args.smoke:
        cfg = get_arch("granite-8b").smoke()
        shape = get_shape("train_4k").smoke()
        space = SMOKE_SPACE
    else:
        cfg = dataclasses.replace(get_arch("granite-8b"),
                                  num_layers=args.layers)
        shape = ShapeConfig("train-1x4096", 4096, 1, "train")
        space = SPACE
    print(f"arch={cfg.name}  d_model={cfg.d_model}  layers={cfg.num_layers}"
          f"  shape={shape.name} ({shape.global_batch}x{shape.seq_len})  "
          f"device={args.device}")

    # 2) the ComPar sweep: (provider x flags x clause) per segment, each
    #    unique program timed, the per-segment winners fused
    tuner = ComParTuner(cfg, shape, device=args.device,
                        executor="wallclock", project="quickstart")
    t0 = time.perf_counter()
    plan, report = tuner.sweep(providers=PROVIDERS, clause_space=space,
                               max_flags=1, backend="sequential")
    sweep_s = time.perf_counter() - t0
    print("\n--- sweep report ---")
    print(report.summary())
    print("\n--- fused plan (the ComPar output) ---")
    print(plan.describe())
    baselines = tuner.baselines()
    print("\nuniform baselines (predicted step seconds):")
    for prov, total in baselines.items():
        print(f"  {prov:12s} {total:.4f}s")
    print(f"  {'FUSED':12s} {plan.meta['predicted_total_s']:.4f}s")

    # 3) train a few steps with the fused plan
    params, opt = init_train_state(cfg, plan, torch.Generator().manual_seed(0),
                                   args.device)
    step = make_train_step(cfg, plan, device=args.device)
    data = SyntheticLM(cfg, shape, seed=0, device=args.device)
    print("\n--- training with the fused plan ---")
    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    before = dict(LAUNCHES)
    losses, times = [], []
    for s in range(args.steps):
        t1 = time.perf_counter()
        params, opt, metrics = step(params, opt, data.batch_at(s))
        losses.append(float(metrics["total_loss"]))    # waits for the step
        times.append(time.perf_counter() - t1)
        print(f"step {s}: loss={losses[-1]:.4f}  {times[-1] * 1e3:.1f} ms")
    launches = {k: (n - before[k]) / max(1, args.steps)
                for k, n in LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        print(f"peak memory {peak / 2**30:.2f} GiB")
    del params, opt
    path = args.plan_out or os.path.join(tempfile.gettempdir(),
                                         "quickstart_plan.json")
    plan.save(path)
    print(f"\nplan saved to {path}")
    return {"cfg": cfg, "shape": shape, "space": space, "tuner": tuner,
            "plan": plan, "report": report, "baselines": baselines,
            "sweep_s": sweep_s, "losses": losses, "step_s": times,
            "launches_per_step": launches, "peak_bytes": peak,
            "plan_path": path}


if __name__ == "__main__":
    main()
