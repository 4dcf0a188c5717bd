"""Spans around calls into the program, and the device trace of a window.

A span is a pair of CUDA events (device time of what the call queued,
read after a synchronize: ``chip_smoke.py``'s ``cuda_ms`` arithmetic) and
a pair of host-clock stamps (what the host was doing, which labels the
device's idle gaps).  The device trace is ``torch.profiler`` with CUDA
activity only: the device's own events (kernels, copies, sets), whose
time is device time (``chip_smoke.py``'s ``device_events``), with no CPU
op events, so a window of many steps stays cheap to read.
"""
from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple


class Spans:
    """Named spans; ``wrap`` times every call of a function."""

    def __init__(self, torch, device_timing: bool = True):
        self.torch = torch
        self.device_timing = device_timing
        self._events = defaultdict(list)
        self.host: List[Tuple[str, int, int]] = []      # name, t0, t1 (ns)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        if self.device_timing:
            start = self.torch.cuda.Event(enable_timing=True)
            start.record()
        try:
            yield
        finally:
            if self.device_timing:
                end = self.torch.cuda.Event(enable_timing=True)
                end.record()
                self._events[name].append((start, end))
            self.host.append((name, t0, time.time_ns()))

    def clear(self):
        """Forget every span so far (those of the set-up)."""
        self._events.clear()
        self.host.clear()

    def wrap(self, fn, name: str):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return timed

    def device_ms(self) -> Dict[str, List[float]]:
        """name -> the CUDA-event time of each span, in ms (synchronizes)."""
        if self.device_timing:
            self.torch.cuda.synchronize()
        return {name: [s.elapsed_time(e) for s, e in evs]
                for name, evs in self._events.items()}

    def host_s(self) -> Dict[str, float]:
        """name -> summed host-clock seconds."""
        out = defaultdict(float)
        for name, t0, t1 in self.host:
            out[name] += (t1 - t0) / 1e9
        return dict(out)

    def label(self, t_ns: int) -> str:
        """The innermost span open at ``t_ns`` (the latest started), or
        ``host``: what the host was doing then."""
        best = None
        for name, t0, t1 in self.host:
            if t0 <= t_ns < t1 and (best is None or t0 > best[1]):
                best = (name, t0)
        return best[0] if best else "host"


def no_span(name: str):
    return contextlib.nullcontext()


def timed_window(torch, seconds: float, body, traced: bool, spans=None):
    """Call ``body`` until ``seconds`` have passed; returns (the seconds
    from the start to the end of the last call, the device trace of the
    window or None)."""
    def loop():
        t0 = time.perf_counter()
        while True:
            body()
            if time.perf_counter() - t0 >= seconds:
                return time.perf_counter() - t0
    if not traced:
        return loop(), None
    with device_trace(torch, spans) as trace:
        window_s = loop()
    return window_s, trace


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


@contextlib.contextmanager
def device_trace(torch, spans: Optional[Spans] = None):
    """Trace the device over the ``with`` body; the yielded dict is filled
    on exit (after a synchronize) with ``window_s``, ``busy_s``, ``ops``
    {name: [count, seconds]}, ``kernels`` (kernel events, no copies or
    sets) and ``gaps`` [[label, seconds]] longest first.  The device's
    stamps are on the host's wall clock; where they are not, it raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out: dict = {}
    prof = profile(activities=[ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    prof.start()
    t0 = time.time_ns()
    try:
        yield out
        torch.cuda.synchronize()
    finally:
        t1 = time.time_ns()
        prof.stop()
    evs = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    if not evs:
        raise RuntimeError("torch.profiler recorded no device event")
    # the profiler stamps device events on the host's wall clock
    inside = sum(t0 - 10**9 <= s <= t1 + 10**9 for _, s, _ in evs)
    if inside < 0.9 * len(evs):
        raise RuntimeError(f"{len(evs) - inside} of {len(evs)} device events "
                           f"lie outside the traced window on the host clock")
    ops = defaultdict(lambda: [0, 0.0])
    spans_ns = []
    for name, s, e in evs:
        ops[name][0] += 1
        ops[name][1] += (e - s) / 1e9
        spans_ns.append((max(s, t0), min(e, t1)))
    busy = _union([(s, e) for s, e in spans_ns if e > s])
    gaps, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    out.update(
        window_s=(t1 - t0) / 1e9,
        busy_s=sum(e - s for s, e in busy) / 1e9,
        ops={k: v for k, v in ops.items()},
        kernels={k: v for k, v in ops.items() if is_kernel(k)},
        gaps=[[spans.label(s) if spans else "host", (e - s) / 1e9]
              for s, e in gaps[:10]])


def kernel_name(key: str) -> str:
    """A demangled kernel name without namespaces, return type and
    argument list (``chip_smoke.py``'s ``_kernel_name``)."""
    name = key.replace("(anonymous namespace)::", "").split("(", 1)[0]
    return name.removeprefix("void ").strip()


def breakdown(trace: dict) -> dict:
    """The ten device operations that took most time and the ten longest
    idle gaps, by what the host was doing."""
    top = sorted(trace["ops"].items(), key=lambda kv: kv[1][1], reverse=True)
    return {"device_ops": [[kernel_name(k)[:120], v[1]] for k, v in top[:10]],
            "idle_gaps": [list(g) for g in trace["gaps"][:10]]}
