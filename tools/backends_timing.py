"""Card readings behind the scoring backends' timings (stablelm-3b at full
width cut to 8 layers, train, B=2 at S=2048: the cell of ``chip_smoke.py``'s
``backends`` phase).

``--part tile``: each stack program of the JSON example's card spec (remat
{none, dots} x kernel x microbatches {1, 2} at ``--block-q``), scored
in-process by the wall-clock executor: status, error, median ms and peak
GiB.  Run it against an older source tree (``PYTHONPATH=<tree>/src``) with
``--kernels plain`` to read what that tree's plain attention needs.

``--part bias``: the same programs timed in turns in this process and in a
warm process-backend worker (A B B A rounds), each a median of
``--repeats`` calls, plus one call's host enqueue time beside its CUDA-event
time (a device that waits on the host shows them equal).  Whether the
worker's medians sit apart from the in-process ones by more than each
mode's own round-to-round spread is the question it answers.

    python tools/backends_timing.py --part tile [--block-q 16]
    python tools/backends_timing.py --part bias [--rounds 4] [--repeats 5]

Needs a card; prints one JSON object a line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time

ARCH, LAYERS, B, S = "stablelm-3b", 8, 2, 2048
#: the programs whose process and in-process medians read furthest apart
#: (dots) and a control (none)
BIAS_PROGRAMS = (("dots", "plain", 1), ("dots", "cuda", 2),
                 ("dots", "plain", 2), ("none", "plain", 1))


def _cell():
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    cfg = dataclasses.replace(get_arch(ARCH), num_layers=LAYERS)
    return cfg, ShapeConfig(f"train-{B}x{S}", S, B, "train")


def _stack(cfg):
    from repro_torch.core.segment import fragment
    return next(s for s in fragment(cfg) if s.kind == "stack")


def _combo(remat, kernel, block_q):
    from repro_torch.core.combinator import Combination
    from repro_torch.models.context import SegmentClause
    clause = SegmentClause(remat=remat, kernel=kernel)
    if block_q:
        clause = dataclasses.replace(clause, block_q=block_q)
    return Combination("fsdp", frozenset(), clause)


def part_tile(args, torch):
    from repro_torch.core.combinator import GlobalKnobs
    from repro_torch.core.executor import CombinationFailed, WallClockExecutor
    cfg, shape = _cell()
    seg = _stack(cfg)
    ex = WallClockExecutor("cuda", repeats=args.repeats, timeout_s=600)
    for remat in ("none", "dots"):
        for kernel in args.kernels.split(","):
            for mb in (1, 2):
                t0 = time.perf_counter()
                row = {"part": "tile", "block_q": args.block_q,
                       "remat": remat, "kernel": kernel, "microbatches": mb}
                try:
                    t = ex.score_segment(cfg, shape, seg,
                                         _combo(remat, kernel, args.block_q),
                                         knobs=GlobalKnobs(microbatches=mb))
                    row.update(status="done",
                               median_ms=t.detail["wall_s"] * 1e3,
                               repeats_ms=[x * 1e3 for x in
                                           t.detail["repeats_s"]],
                               peak_gib=t.detail["peak_bytes"] / 2**30)
                except CombinationFailed as e:
                    row.update(status="failed", error=str(e)[:400],
                               transient=e.transient)
                row["wall_s"] = time.perf_counter() - t0
                print(json.dumps(row), flush=True)


def _host_vs_device(torch, cfg, shape, seg, combo, knobs):
    """One call after a warm-up: seconds to enqueue it on the host, and
    its CUDA-event time."""
    from repro_torch.core.timer import segment_program
    fn, fargs = segment_program(cfg, shape, seg, combo, device="cuda",
                                knobs=knobs)
    fn(*fargs)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn(*fargs)
    end.record()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    del out, fn, fargs
    return host * 1e3, start.elapsed_time(end)


def part_bias(args, torch):
    from repro_torch.core.backends import JobSpec, ProcessBackend
    from repro_torch.core.combinator import GlobalKnobs
    from repro_torch.core.executor import WallClockExecutor
    cfg, shape = _cell()
    seg = _stack(cfg)
    ex = WallClockExecutor("cuda", repeats=args.repeats, timeout_s=600)
    backend = ProcessBackend(ex, cfg, shape, workers=1, timeout_s=600)
    medians = {p: {"process": [], "inproc": []} for p in BIAS_PROGRAMS}
    try:
        for rnd in range(args.rounds):
            order = ("inproc", "process") if rnd % 2 == 0 else \
                ("process", "inproc")
            for mode in order + order[::-1]:
                for p in BIAS_PROGRAMS:
                    remat, kernel, mb = p
                    combo = _combo(remat, kernel, 0)
                    knobs = GlobalKnobs(microbatches=mb)
                    if mode == "inproc":
                        t = ex.score_segment(cfg, shape, seg, combo,
                                             knobs=knobs)
                        times = t.detail["repeats_s"]
                    else:
                        out, = backend.run([JobSpec(
                            f"{remat}/{kernel}/{mb}/{rnd}", seg, combo,
                            segments=(seg.name,), knobs=knobs)])
                        if out.status != "done":
                            raise RuntimeError(f"worker: {out.to_json()}")
                        times = out.cost["detail"]["repeats_s"]
                    med = statistics.median(times) * 1e3
                    medians[p][mode].append(med)
                    print(json.dumps({
                        "part": "bias", "round": rnd, "mode": mode,
                        "program": "/".join(map(str, p)), "median_ms": med,
                        "repeats_ms": [x * 1e3 for x in times]}), flush=True)
    finally:
        backend.close()
    for p in BIAS_PROGRAMS:
        remat, kernel, mb = p
        host, dev = _host_vs_device(torch, cfg, shape, seg,
                                    _combo(remat, kernel, 0),
                                    GlobalKnobs(microbatches=mb))
        m = medians[p]
        print(json.dumps({
            "part": "bias-summary", "program": "/".join(map(str, p)),
            **{f"{k}_ms": {"median": statistics.median(v), "min": min(v),
                           "max": max(v)} for k, v in m.items()},
            "process_over_inproc": statistics.median(m["process"])
            / statistics.median(m["inproc"]),
            "host_enqueue_ms": host, "event_ms": dev}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python tools/backends_timing.py")
    ap.add_argument("--part", choices=("tile", "bias"), required=True)
    ap.add_argument("--block-q", dest="block_q", type=int, default=16)
    ap.add_argument("--kernels", default="plain,cuda")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    (part_tile if args.part == "tile" else part_bias)(args, torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
