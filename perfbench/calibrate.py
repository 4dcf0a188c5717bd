"""Readings that the limits of ``correct`` are set from, many seeds in one
process (no measured window: the training numbers compare the first
steps).

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12 \\
        [--control-seeds 21,22,23] [--fault-seeds 31,32,33] [--plan <name>]

For each ``--seeds`` seed: the program's first steps (the cell's train
step under its plan, or ``--plan``) against the reference; in a sweep
cell, one cold sweep's counts and its programs' gradients against the
reference's.  For each ``--control-seeds`` seed: the control, the
reference computed with every product in float8 (the step below the
configuration's bfloat16), in the program's place.  For each
``--fault-seeds`` seed: the program with half of each batch left out of
the loss (in a sweep, of each segment's objective).  One JSON line per
reading on standard output.  Runs on a CUDA card only.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def half_batch():
    """The program's loss over the first half of the tokens only (the mean
    taken over the rest): a fault."""
    import repro_torch.train.step as S
    xent = S.softmax_xent

    def half(logits, targets, **kw):
        n = targets.numel() // 2
        return xent(logits.reshape(-1, logits.shape[-1])[:n],
                    targets.reshape(-1)[:n], **kw)
    S.softmax_xent = half
    try:
        yield
    finally:
        S.softmax_xent = xent


@contextlib.contextmanager
def half_segment():
    """Each segment program's objective over the first half of the
    positions only: a fault (the head's scalar loss is left whole)."""
    import repro_torch.core.timer as T
    with_bwd = T._with_bwd

    def half(fn, argnums=(0,), scalar=False):
        if scalar:
            return with_bwd(fn, argnums, scalar)
        return with_bwd(lambda *a: (lambda y: y[:, :y.shape[1] // 2])(fn(*a)),
                        argnums, scalar)
    T._with_bwd = half
    try:
        yield
    finally:
        T._with_bwd = with_bwd


def sweep_readings(ctx, kind: str, plan_json=None) -> dict:
    from perfbench.entries import sweep as E
    from perfbench.entries.train import arch_config
    from perfbench.harness import verdict
    cell, t0 = ctx.cell, time.perf_counter()
    watch, counts = E.Watch(ctx), {}
    if kind == "control":
        names = {"embed": "embed", "g0": "stack", "head": "head"}
        got = E.reference_segments(ctx, watch, names, "fp8")
        gaps = verdict.segment_gaps(
            [{"segment": n, "read": r} for n, r in got.items()],
            E.reference_segments(ctx, watch, names))
    else:
        with (half_segment() if kind == "half_batch"
              else contextlib.nullcontext()), E.patched_executor(watch):
            s = E._sweep(ctx, arch_config(cell.arch),
                         E.sweep_shape(cell.traffic), watch)
        counts = E.check_sweep(s, cell.traffic)
        gaps = E.segment_gaps([s], watch, ctx)
    return {"kind": kind, "seed": ctx.seed, "counts": counts,
            "gaps": {k: g["value"] for k, g in gaps.items()},
            "at": {k: g["at"] for k, g in gaps.items()},
            "seconds": time.perf_counter() - t0}


def readings(ctx, kind: str, plan_json: dict) -> dict:
    from perfbench.entries.train import Program, reference_readings
    from perfbench.harness import verdict
    cell = ctx.cell
    t0 = time.perf_counter()
    if kind == "control":
        got = reference_readings(ctx, cell.arch, cell.traffic, "fp8")
    else:
        with (half_batch() if kind == "half_batch"
              else contextlib.nullcontext()):
            prog = Program(ctx, cell.arch, plan_json, cell.traffic)
            try:
                got = prog.first_steps(cell.traffic["check_steps"])
            finally:
                prog.close()
    ref = reference_readings(ctx, cell.arch, cell.traffic)
    gaps = verdict.training_gaps(got, ref)
    return {"kind": kind, "seed": ctx.seed,
            "gaps": {k: g["value"] for k, g in gaps.items()},
            "at": {k: g["at"] for k, g in gaps.items()},
            "losses": got["losses"], "ref_losses": ref["losses"],
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--plan", default=None)
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    sys.path[:0] = [str(CHECKOUT / "src"), str(CHECKOUT)]
    from types import SimpleNamespace

    from perfbench.harness import cell as C
    from perfbench.harness.runner import card, log
    import torch
    if not torch.cuda.is_available():
        log("no CUDA card")
        return 2
    cell = C.load_cell(args.workload)
    plan = cell.plan
    if args.plan:
        plan = json.loads((C.ROOT / "plans" / f"{args.plan}.json")
                          .read_text())["plan"]
    log(f"{args.workload} on {torch.cuda.get_device_name()}, {card()}")
    seeds = lambda s: [int(x) for x in s.split(",") if x]   # noqa: E731
    for kind, arg in (("program", args.seeds),
                      ("control", args.control_seeds),
                      ("half_batch", args.fault_seeds)):
        for seed in seeds(arg):
            ctx = SimpleNamespace(torch=torch, cell=cell, seed=seed,
                                  seconds=0, trace=False,
                                  device=torch.device("cuda"), t0=T0, log=log)
            read = sweep_readings if cell.traffic["entry"] == "sweep" \
                else readings
            line = read(ctx, kind, plan)
            line["plan"] = args.plan or cell.traffic.get("plan")
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
