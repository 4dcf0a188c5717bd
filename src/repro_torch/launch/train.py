"""Training entry point, as the reference's ``src/repro/launch/train.py``.

Wires together: config registry -> ComParX plan (``--plan`` file or the
built-in default) -> train step -> deterministic resumable data -> async
atomic checkpoints -> heartbeat.  Restart-from-latest is the default
(``--resume auto``): data is step-indexed, so a requeued job continues
exactly.  Runs on the card unless ``--device cpu``.

Usage:
  python -m repro_torch.launch.train --arch xlstm-125m --smoke --device cpu
  python -m repro_torch.launch.train --arch xlstm-125m --steps 200 \\
      --plan plan.json
  python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b --smoke \\
      --device cpu
  python -m repro_torch.launch.train --arch phi-3-vision-4.2b --smoke \\
      --device cpu

Every arch of ``repro_torch.configs.ARCHS`` trains, the MoE archs
included (their loss adds the routers' load-balancing loss), and the
stub-frontend archs (phi-3-vision-4.2b, musicgen-large) from their
pipeline's ``embeds``.
The plan is the ``--plan`` file or ``launch/dryrun.py``'s
``default_plan``, the reference's: MoE archs train by ``expert_par`` with
bf16 AdamW state.  qwen3-moe-30b-a3b at full depth does not fit one card
even so: train it cut in depth.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import ARCHS, get_arch, get_shape
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.plan import Plan
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.dryrun import default_plan
from repro_torch.launch.mesh import destroy_group, launch_mesh
from repro_torch.train.step import (init_train_state, make_train_step,
                                    place_batch)


class Heartbeat:
    """Watchdog hook: on a pod, each host posts a heartbeat and the
    launcher requeues stragglers; standalone it records step latencies."""

    def __init__(self, warn_factor: float = 3.0):
        self.warn_factor = warn_factor
        self.history = []

    def beat(self, step: int, dt: float):
        self.history.append(dt)
        med = float(np.median(self.history[-20:]))
        if len(self.history) > 5 and dt > self.warn_factor * med:
            print(f"[heartbeat] step {step}: straggler suspected "
                  f"({dt:.2f}s vs median {med:.2f}s)")


def train(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True,
                    help="an arch of repro_torch.configs.ARCHS: "
                         + ", ".join(ARCHS))
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + shape (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--plan", default=None, help="plan JSON file")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="auto", choices=["auto", "never"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=0,
                    help="override global batch")
    ap.add_argument("--seq", type=int, default=0, help="override seq len")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mesh = launch_mesh(dev)
    cfg = get_arch(args.arch)
    shape = get_shape(args.shape)
    if args.smoke:
        cfg, shape = cfg.smoke(), shape.smoke()
    if args.batch or args.seq:
        shape = ShapeConfig(shape.name + "-cli", args.seq or shape.seq_len,
                            args.batch or shape.global_batch, shape.kind)

    plan = Plan.load(args.plan) if args.plan else default_plan(cfg, shape)
    print(f"[train] arch={cfg.name} shape={shape.name} "
          f"(B={shape.global_batch}, S={shape.seq_len}) device={dev} "
          f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape)) if mesh else None}")
    print("[train] plan: " + ", ".join(sorted(
        {c.label() for c in plan.segments.values()}))
        + f"; knobs {vars(plan.knobs)}")

    step_fn = make_train_step(cfg, plan, device=dev, mesh=mesh,
                              peak_lr=args.lr, warmup=args.warmup)
    params, opt = init_train_state(
        cfg, plan, torch.Generator().manual_seed(args.seed), dev, mesh=mesh)
    data = SyntheticLM(cfg, shape, seed=args.seed, device=dev)
    store = CheckpointStore(args.ckpt_dir or os.path.join(
        tempfile.gettempdir(), f"repro_torch_ckpt_{cfg.name}"), keep=3)
    start = 0
    if args.resume == "auto" and store.latest_step() is not None:
        start, state, extra = store.restore({"params": params, "opt": opt})
        params, opt = state["params"], state["opt"]
        data.restore(extra["data"])
        print(f"[train] resumed from step {start}")

    hb = Heartbeat()
    losses = []
    for step in range(start, args.steps):
        batch = place_batch(data.batch_at(step), cfg, plan, mesh)
        data.state.step = step + 1
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(float(metrics["total_loss"]))   # waits for the step
        dt = time.perf_counter() - t0
        hb.beat(step, dt)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d} loss={losses[-1]:.4f} "
                  f"grad_norm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} {dt * 1e3:.0f}ms")
        if (step + 1) % args.ckpt_every == 0 or step == args.steps - 1:
            store.save_async(step + 1, {"params": params, "opt": opt},
                             extra={"data": data.snapshot(),
                                    "plan": plan.to_json()})
    store.wait()
    if losses:
        print(f"[train] final loss {losses[-1]:.4f} "
              f"(start {losses[0]:.4f}); checkpoints: {store.steps()}")
    else:
        print(f"[train] nothing to do (resumed at step {start} "
              f">= {args.steps}); checkpoints: {store.steps()}")
    return losses


if __name__ == "__main__":
    try:
        train()
    finally:
        destroy_group()     # the launcher's group, if launch_mesh joined one
