"""The program's own spans and counters (``repro_torch.runtime.trace``),
seen from the benchmark: read into per-layer numbers, and joined with the
harness's spans to name what the host was doing in each idle gap.

No metric of ``BENCHMARK.json`` reads these yet (``program_trace.py``
runs a cell with them).  Where the program has no tracer, as an older
``src/`` has not, :func:`tracer` is None and every reader reads None.

Numbers, each None where no span or counter of its kind was recorded:

- ``fwd_ms.train``, ``bwd_ms.train``: device ms of ``train.forward``,
  ``train.backward`` per ``train.step``;
- ``fa_bwd_ms.train``: device ms of ``kernels.flash_attention.bwd`` per
  step; ``fa_bwd_roofline.train``: the least time of one such call
  (:func:`flash_attention_bwd` from the shapes, whatever implements it)
  over its mean device ms, %;
- ``mallocs_per_step.train``: the allocator's device allocations per
  counted ``train.step``;
- ``timed_share.sweep``: host seconds in ``score.timed`` over those in
  ``sweep``, %;
- ``build_ms.sweep``, ``release_ms.sweep``: mean host ms of
  ``score.build`` (which holds the harness's weight draw: ``Watch``
  wraps ``segment_program``) and ``score.release`` per scored program;
- ``mallocs_per_job.sweep``: device allocations per ``score.job``.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional

from perfbench.harness import work
from perfbench.harness.inputs import head_dim

MALLOCS = "alloc.device_mallocs"


def tracer():
    """``repro_torch.runtime.trace``, or None where the program has none."""
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    return trace


def _named(spans: List[dict], name: str) -> List[dict]:
    return [s for s in spans if s["name"] == name]


def _per(spans, name: str, per: int, key) -> Optional[float]:
    vals = [key(s) for s in _named(spans, name)]
    vals = [v for v in vals if v is not None]
    return sum(vals) / per if vals and per else None


def _device_ms(s):
    return s["device_ms"]


def _host_ms(s):
    return (s["t1_ns"] - s["t0_ns"]) / 1e6


def _mallocs(s):
    return s["counters"].get(MALLOCS)


def flash_attention_bwd(batch: int, heads: int, kv_heads: int, seq: int,
                        dim: int, window: int, dtype: str):
    """(FLOPs, bytes) of one causal flash-attention backward: twice the
    forward's products (dS and dP, dV and dQ, dK; no recomputation, as
    ``work.train_step_flops`` counts it); q, k, v and dO read once and dq,
    dk, dv written once."""
    flops, _ = work.flash_attention_fwd(batch, heads, kv_heads, seq, dim,
                                        window, dtype)
    elems = batch * seq * dim * (3 * heads + 4 * kv_heads)
    return 2 * flops, elems * work.DTYPE_BYTES[dtype]


def train_numbers(spans: List[dict], arch: dict, batch: int,
                  seq: int) -> Dict[str, Optional[float]]:
    steps = len(_named(spans, "train.step"))
    fa = [s["device_ms"] for s in _named(spans, "kernels.flash_attention.bwd")
          if s["device_ms"] is not None]
    roofline = None
    if fa:
        flops, nbytes = flash_attention_bwd(
            batch, arch["num_heads"], arch["num_kv_heads"], seq,
            head_dim(arch), arch["window_size"], arch["dtype"])
        least, _ = work.bound_s(nbytes, flops, arch["dtype"])
        roofline = 100.0 * least / (sum(fa) / len(fa) / 1e3)
    counted = [s for s in _named(spans, "train.step")
               if _mallocs(s) is not None]
    return {
        "fwd_ms.train": _per(spans, "train.forward", steps, _device_ms),
        "bwd_ms.train": _per(spans, "train.backward", steps, _device_ms),
        "fa_bwd_ms.train": _per(spans, "kernels.flash_attention.bwd", steps,
                                _device_ms),
        "fa_bwd_roofline.train": roofline,
        "mallocs_per_step.train": _per(counted, "train.step", len(counted),
                                       _mallocs)}


def sweep_numbers(spans: List[dict]) -> Dict[str, Optional[float]]:
    sweep_ms = _per(spans, "sweep", 1, _host_ms)
    timed_ms = _per(spans, "score.timed", 1, _host_ms) or 0.0
    jobs = len(_named(spans, "score.job"))
    counted = [s for s in _named(spans, "score.job")
               if _mallocs(s) is not None]
    return {
        "timed_share.sweep": 100.0 * timed_ms / sweep_ms if sweep_ms
        else None,
        "build_ms.sweep": _per(spans, "score.build", jobs, _host_ms),
        "release_ms.sweep": _per(spans, "score.release", jobs, _host_ms),
        "mallocs_per_job.sweep": _per(counted, "score.job", len(counted),
                                      _mallocs)}


def totals(spans: List[dict]) -> Dict[str, dict]:
    """name -> {"n", "host_s", "device_ms"} summed over the spans."""
    out = defaultdict(lambda: {"n": 0, "host_s": 0.0, "device_ms": None})
    for s in spans:
        t = out[s["name"]]
        t["n"] += 1
        t["host_s"] += _host_ms(s) / 1e3
        if s["device_ms"] is not None:
            t["device_ms"] = (t["device_ms"] or 0.0) + s["device_ms"]
    return dict(out)


class Labeller:
    """The innermost span open at a time (the latest started of those
    holding it), of the harness's spans (``Spans.host``: name, t0, t1) and
    the program's (:func:`tracer`'s export), or ``host``."""

    def __init__(self, harness=(), program=()):
        spans = [(t0, t1, name) for name, t0, t1 in harness]
        spans += [(s["t0_ns"], s["t1_ns"], s["name"]) for s in program]
        spans.sort(key=lambda s: (s[0], -s[1]))    # outer before inner
        self._spans = spans
        self._starts = [s[0] for s in spans]
        self.bounds = sorted({t for s in spans for t in s[:2]})

    def label(self, t_ns: int) -> str:
        for i in range(bisect.bisect_right(self._starts, t_ns) - 1, -1, -1):
            if t_ns < self._spans[i][1]:
                return self._spans[i][2]
        return "host"


def idle_by_label(busy, t0: int, t1: int, labeller) -> Dict[str, float]:
    """Seconds of [t0, t1) outside the merged ``busy`` intervals (ns), each
    piece of a gap under the innermost span open over it."""
    gaps, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, min(s, t1)))
        prev = max(prev, e)
        if prev >= t1:
            break
    if t1 > prev:
        gaps.append((prev, t1))
    out, bounds = defaultdict(float), labeller.bounds
    for s, e in gaps:
        i = bisect.bisect_right(bounds, s)
        cuts = [s] + bounds[i:bisect.bisect_left(bounds, e, i)] + [e]
        for a, b in zip(cuts, cuts[1:]):
            out[labeller.label(a)] += (b - a) / 1e9
    return dict(out)
