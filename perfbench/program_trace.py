"""Run one cell as ``run.py`` does, with the program's own tracer on
through the window, and add what it recorded to the result line.

    python3 perfbench/program_trace.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

The last line on standard output is ``run.py``'s result with one more
key, ``program``: ``numbers`` (``harness/program.py``'s per-layer numbers
of the cell's entry), ``totals`` (each program span's count, host seconds
and device ms over the window), ``harness`` (the same of the harness's
own spans, to hold the program's against) and, with ``--trace 1``,
``idle_by_label`` (the window's idle seconds, each piece of a gap under
the innermost span open over it, the harness's or the program's); the
result's ``breakdown.idle_gaps`` are labelled by the innermost span open
at each gap's start, of both kinds.  Training traces with
device timing, the sweep on the host clock alone.  With ``--trace 0`` the
end-to-end metrics are those of a window with the tracer on: against
``run.py``'s on the same seed they are its cost.  Where the program has
no tracer the run is ``run.py``'s and ``program`` is null.
"""
import time

T0 = time.perf_counter()            # set-up is counted from here

import contextlib  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


class _Labels:
    """The labeller ``timed_window`` hands ``device_trace``: built at its
    first call, when the window is over, from both kinds of span."""

    def __init__(self, program, spans, trace):
        self.args, self.labeller = (program, spans, trace), None

    def get(self):
        if self.labeller is None:
            program, spans, trace = self.args
            self.labeller = program.Labeller(spans.host if spans else (),
                                             trace.export())
        return self.labeller

    def label(self, t_ns: int) -> str:
        return self.get().label(t_ns)


@contextlib.contextmanager
def _kept_profiler(torch, kept: list):
    """``torch.profiler.profile`` keeping each profiler started, with its
    start and stop on ``time.time_ns()``."""
    base = torch.profiler.profile

    class Kept(base):
        def start(self):
            super().start()
            self.t0 = time.time_ns()
            kept.append(self)

        def stop(self):
            self.t1 = time.time_ns()
            super().stop()
    torch.profiler.profile = Kept
    try:
        yield
    finally:
        torch.profiler.profile = base


def _idle(prof, labeller, program) -> dict:
    from torch.autograd import DeviceType

    from perfbench.harness.trace import _union
    t0, t1 = prof.t0, prof.t1
    evs = [(e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    busy = _union([(max(s, t0), min(e, t1)) for s, e in evs
                   if min(e, t1) > max(s, t0)])
    return program.idle_by_label(busy, t0, t1, labeller)


def _window(timed_window, program, trace, seen: dict, device: bool):
    def window(torch, seconds, body, traced, spans=None):
        trace.clear()
        trace.enable(device_timing=device and torch.cuda.is_available())
        labels, kept = _Labels(program, spans, trace), []
        try:
            with _kept_profiler(torch, kept):
                out = timed_window(torch, seconds, body, traced,
                                   labels if traced else spans)
        finally:
            trace.disable()
        seen["spans"] = trace.export()
        trace.clear()
        if spans is not None:
            seen["harness"] = {
                "host_s": spans.host_s(),
                "device_ms": {k: sum(v) for k, v in
                              spans.device_ms().items()}}
        if kept:
            seen["idle_by_label"] = _idle(kept[-1], labels.get(), program)
        return out
    return window


@contextlib.contextmanager
def installed(seen: dict):
    """Each entry's window under the program's tracer, and the runner's
    result with ``program`` added; as they were on exit."""
    from perfbench.entries import sweep, train
    from perfbench.harness import program, runner
    trace = program.tracer()
    saved = (train.timed_window, sweep.timed_window, runner.execute)
    execute = runner.execute

    def traced_execute(cell, **kw):
        seen.clear()
        result = execute(cell, **kw)
        spans, checks = seen.get("spans"), result.pop("checks")
        result["program"] = None
        if spans is not None:
            t = cell.traffic
            numbers = program.train_numbers(
                spans, cell.arch, t["batch"], t["seq"]) \
                if t["entry"] == "train" else program.sweep_numbers(spans)
            result["program"] = {
                "numbers": numbers, "totals": program.totals(spans),
                "harness": seen.get("harness"),
                "idle_by_label": seen.get("idle_by_label")}
        result["checks"] = checks
        return result
    if trace is not None:
        train.timed_window = _window(saved[0], program, trace, seen, True)
        sweep.timed_window = _window(saved[1], program, trace, seen, False)
    runner.execute = traced_execute
    try:
        yield
    finally:
        train.timed_window, sweep.timed_window, runner.execute = saved


def main(argv=None) -> int:
    sys.path[:0] = [str(CHECKOUT / "src"), str(CHECKOUT)]
    from perfbench import run
    run.T0 = T0
    with installed({}):
        return run.main(argv)


if __name__ == "__main__":
    sys.exit(main())
