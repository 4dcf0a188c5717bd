"""Cold ComPar sweeps: ``repro_torch.core.tuner.ComParTuner.sweep`` with
the wall-clock executor, each sweep on a fresh in-memory ``SweepDB`` (no
score cache, no registry), repeated through the window.

Set-up runs one sweep (every program's kernels and shapes warm).  The
window runs sweeps until ``--seconds`` have passed; ``plan_s`` is the
seconds from the window's start to the end of the last sweep over the
number of sweeps.

The executor's programs are watched from outside (:class:`Watch`): each
gets the harness's weights, drawn from the seed, through
``segment_program``'s ``params`` (in place of its own draw) and the
harness's input copied over its own (the same shapes), counts its calls,
and keeps a sample of what its last timed call returned.  Checked after
the window, for every sweep: every row done; each segment's plan the
least total time of its rows; every
scored program built at the traffic's shape, called once to warm up and
``repeats`` times timed, its rows carrying ``repeats`` timings; each
program's gradients against the reference's from the same inputs.  Then
the last sweep's plan trains its first steps from the seed, held to the
reference as the ``train`` entry holds a step.
"""
from __future__ import annotations

import contextlib
import gc
import math
import time

from perfbench.entries.train import (Program, arch_config, flat,
                                     reference_readings)
from perfbench.harness import inputs, verdict
from perfbench.harness.trace import Spans, no_span, timed_window
from perfbench.reference import segments as ref_segments
from perfbench.reference.fusion import best_per_segment


def _sq_sum(t, chunk=1 << 25):
    """The sum of squares of ``t`` in f32, as a device scalar (no wait)."""
    return sum(c.float().square().sum() for c in t.detach().reshape(-1)
               .split(chunk))


class Watch:
    """The executor's programs, seen from outside: ``build`` wraps
    ``segment_program`` and ``measure`` wraps ``WallClockExecutor._measure``.
    ``jobs`` holds one record per program built: segment, shape, whether
    its input had the traffic's shape, calls, the last timed call's
    gradients read as {path: (sum of squares, sample)} (device tensors
    until :meth:`fetch`), and ``watch_s``, the seconds the watch's own
    work took (the draws, the copy and the reading, each waited for).
    """

    def __init__(self, ctx):
        self.ctx, self.t, self.arch = ctx, ctx.cell.traffic, ctx.cell.arch
        self.leaves = {leaf[0]: leaf for leaf in inputs.layout(self.arch)}
        self.jobs = []
        self._index = {}

    def input_of(self, kind: str):
        """The segment's input, from the seed: uniform tokens (B, S) for
        the embedding, else a residual stream (B, S, d)."""
        torch, dev = self.ctx.torch, self.ctx.device
        B, S, a = self.t["batch"], self.t["seq"], self.arch
        if kind == "embed":
            g = torch.Generator(device=dev)
            g.manual_seed(inputs.sub_seed(self.ctx.seed, "segment/tokens"))
            return torch.randint(0, a["vocab_size"], (B, S), generator=g,
                                 device=dev)
        leaf = ("segment/x", (B, S, a["d_model"]), "normal",
                a["d_model"] ** -0.5)
        return inputs.draw_leaf(torch, leaf, self.ctx.seed, dev,
                                getattr(torch, a["dtype"]))

    def weight(self, path: str):
        return inputs.draw_leaf(self.ctx.torch, self.leaves[path],
                                self.ctx.seed, self.ctx.device,
                                getattr(self.ctx.torch, self.arch["dtype"]))

    def segment_paths(self, name: str, kind: str) -> list:
        """The layout's leaves that segment ``name`` holds."""
        if kind == "embed":
            return ["embed/tok"]
        if kind == "head":
            return [p for p in self.leaves if p.startswith("head/")] + \
                (["embed/tok"] if self.arch["tie_embeddings"] else [])
        return [p for p in self.leaves if p.startswith(name + "/")]

    def params_of(self, cfg, seg) -> dict:
        """The segment's weights from the seed, as the tree the program's
        ``segment_program(params=...)`` takes (every path and shape
        checked against the program's)."""
        from repro_torch.models.model import model_specs
        specs = model_specs(cfg)
        keys = {"embed": ["embed"], "stack": [seg.name],
                "head": ["head"] + (["embed"] if cfg.tie_embeddings else [])}
        weights = {p: self.weight(p)
                   for p in self.segment_paths(seg.name, seg.kind)}
        tree = inputs.as_tree(weights, {k: specs[k] for k in keys[seg.kind]})
        return tree[seg.name] if seg.kind == "stack" else tree

    def _sync(self):
        if self.ctx.device.type == "cuda":
            self.ctx.torch.cuda.synchronize()

    def build(self, segment_program):
        def built(cfg, shape, seg, combo, **kw):
            t0 = time.perf_counter()
            job = {"segment": seg.name, "kind": seg.kind,
                   "shape": [shape.global_batch, shape.seq_len, shape.kind],
                   "calls": 0, "out": None, "read": None}
            self.jobs.append(job)
            params = self.params_of(cfg, seg)
            self._sync()
            job["watch_s"] = time.perf_counter() - t0
            fn, args = segment_program(cfg, shape, seg, combo,
                                       **dict(kw, params=params))
            del params
            t0 = time.perf_counter()
            want = self.input_of(seg.kind)
            job["input_as_set"] = tuple(args[1].shape) == tuple(want.shape)
            if job["input_as_set"]:
                with self.ctx.torch.no_grad():
                    args[1].copy_(want)
            del want
            self._sync()
            job["watch_s"] += time.perf_counter() - t0
            last = 1 + self.t["repeats"]

            def counted(*a):
                out = fn(*a)
                job["calls"] += 1
                if job["calls"] == last:
                    job["out"] = out
                return out
            return counted, args
        return built

    def measure(self, measure):
        def run(executor, *a, **kw):
            try:
                return measure(executor, *a, **kw)
            finally:
                job = self.jobs[-1] if self.jobs else None
                if job is not None and job["out"] is not None:
                    t0 = time.perf_counter()
                    job["read"] = self._read(job)
                    job["out"] = None
                    self._sync()
                    job["watch_s"] += time.perf_counter() - t0
        return run

    def _sample_at(self, path: str, numel: int):
        key = (path, numel)
        if key not in self._index:
            self._index[key] = inputs.sample_index(
                self.ctx.torch, self.ctx.seed, "segment/" + path,
                numel).to(self.ctx.device)
        return self._index[key]

    def read(self, grads: dict) -> dict:
        """{path: (sum of squares, sample)} of gradients by path."""
        return {p: (_sq_sum(g), g.detach().reshape(-1)[
            self._sample_at(p, g.numel())].float()) for p, g in grads.items()}

    def _read(self, job):
        out = job["out"]
        if not isinstance(out, tuple) or not out:
            return {}
        grads = flat(out[0], job["segment"] if job["kind"] == "stack" else "")
        if len(out) > 1:
            grads["x"] = out[1]
        return self.read(grads)

    @staticmethod
    def fetch(read: dict) -> dict:
        """A reading's device tensors as (norm, CPU sample)."""
        return {p: (math.sqrt(float(s)), x.cpu()) for p, (s, x) in
                read.items()}


def _sweep(ctx, cfg, shape, watch) -> dict:
    """One cold sweep; its rows, plan, report and jobs, as plain data."""
    from repro_torch.core.db import SweepDB
    from repro_torch.core.tuner import ComParTuner
    t = ctx.cell.traffic
    first = len(watch.jobs)
    tuner = ComParTuner(cfg, shape, device=ctx.device, db=SweepDB(":memory:"),
                        executor="wallclock", project="perfbench")
    try:
        plan, rep = tuner.sweep(providers=list(t["providers"]),
                                clause_space={k: tuple(v) for k, v in
                                              t["clause_space"].items()},
                                max_flags=t["max_flags"],
                                backend=t["backend"])
        rows = []
        for r in tuner.db.results(tuner.project):
            cost = r["cost"] or {}
            rows.append({"segment": r["segment"], "status": r["status"],
                         "cid": r["cid"],
                         "total_s": cost.get("total_s", float("nan")),
                         "n_repeats": len((cost.get("detail") or {})
                                          .get("repeats_s") or ())})
    finally:
        tuner.close()
    return {"plan": plan.to_json(), "rows": rows,
            "n_combinations": rep.n_combinations, "n_scored": rep.n_scored,
            "n_done": rep.n_done, "n_failed": rep.n_failed,
            "chosen": {s: c.cid for s, c in plan.segments.items()},
            "jobs": watch.jobs[first:]}


def check_sweep(s: dict, traffic: dict) -> dict:
    """Exact counts: rows not done; segments whose chosen row is not the
    least; jobs not as the traffic sets them (built at another shape,
    called other than once and ``repeats`` times, unread, or other than
    the report's scored programs) and done rows with other than
    ``repeats`` timings."""
    not_done = sum(r["status"] != "done" for r in s["rows"])
    not_done += max(0, s["n_combinations"] - len(s["rows"]))
    best = best_per_segment(s["rows"])
    chosen = {}
    for r in s["rows"]:
        if r["status"] == "done" and r["cid"] == s["chosen"].get(r["segment"]):
            chosen[r["segment"]] = min(chosen.get(r["segment"], float("inf")),
                                       r["total_s"])
    wrong = sum(chosen.get(seg, float("inf")) != b for seg, b in best.items())
    wrong += len(set(s["chosen"]) - set(best))
    B, S, n = traffic["batch"], traffic["seq"], traffic["repeats"]
    jobs = abs(len(s["jobs"]) - s["n_scored"])
    for j in s["jobs"]:
        jobs += (j["shape"] != [B, S, "train"] or not j["input_as_set"]
                 or j["calls"] != 1 + n or not j["read"])
    jobs += sum(r["status"] == "done" and r["n_repeats"] != n
                for r in s["rows"])
    return {"rows_not_done": not_done, "plan_not_least": wrong,
            "jobs_not_as_set": jobs}


def reference_segments(ctx, watch, names: dict,
                       precision: str = "float32") -> dict:
    """segment name -> the reference's reading of its gradients, from the
    inputs the watch handed the programs.  ``names``: name -> kind."""
    torch, out = ctx.torch, {}
    for name, kind in names.items():
        weights = {p: watch.weight(p) for p in watch.segment_paths(name, kind)}
        grads = ref_segments.segment_grads(ctx.cell.arch, kind, weights,
                                           watch.input_of(kind), precision)
        del weights
        out[name] = watch.fetch(watch.read(grads))
        del grads
        gc.collect()
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def segment_gaps(sweeps, watch, ctx, precision: str = "float32") -> dict:
    """The gradients of every read job of ``sweeps`` against the
    reference's (``verdict.segment_gaps``)."""
    jobs = [dict(j, read=watch.fetch(j["read"])) for s in sweeps
            for j in s["jobs"] if j["read"]]
    names = {j["segment"]: j["kind"] for j in jobs}
    return verdict.segment_gaps(jobs, reference_segments(ctx, watch, names,
                                                         precision))


@contextlib.contextmanager
def patched_executor(watch, scored=None):
    """The executor's builder and measurement wrapped by ``watch``, and
    ``scored`` (a wrapper's maker) around ``score_segment``, for one run."""
    import repro_torch.core.executor as E
    W = E.WallClockExecutor
    saved = (E.segment_program, W._measure, W.score_segment)
    E.segment_program = watch.build(saved[0])
    W._measure = watch.measure(saved[1])
    if scored is not None:
        W.score_segment = scored(saved[2])
    try:
        yield
    finally:
        E.segment_program, W._measure, W.score_segment = saved


def sweep_shape(traffic: dict):
    from repro_torch.configs.base import ShapeConfig
    return ShapeConfig(f"train-{traffic['batch']}x{traffic['seq']}",
                       traffic["seq"], traffic["batch"], "train")


def run(ctx) -> dict:
    torch, cell = ctx.torch, ctx.cell
    arch, t = cell.arch, cell.traffic
    cuda = ctx.device.type == "cuda"
    cfg, shape = arch_config(arch), sweep_shape(t)
    spans = Spans(torch, device_timing=False) if ctx.trace else None
    watch = Watch(ctx)
    # the executor resets the peak counter at each job's start: read each
    # job's peak as it returns
    peaks = [0]

    def scored(score):
        def job(*a, **kw):
            try:
                return score(*a, **kw)
            finally:
                if cuda:
                    peaks.append(torch.cuda.max_memory_allocated())
        return job if spans is None else spans.wrap(job, "score_segment")
    with patched_executor(watch, scored):
        _sweep(ctx, cfg, shape, watch)                     # warm-up
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        peaks[:] = [0]
        watch.jobs.clear()
        if spans is not None:
            spans.clear()
        setup_s = time.perf_counter() - ctx.t0
        ctx.log(f"set-up {setup_s:.2f} s")
        sweeps = []
        span = spans.span if spans is not None else no_span

        def sweep():
            t0 = time.perf_counter()
            with span("sweep"):
                sweeps.append(_sweep(ctx, cfg, shape, watch))
            sweeps[-1]["seconds"] = time.perf_counter() - t0
        window_s, trace = timed_window(torch, ctx.seconds, sweep,
                                       ctx.trace and cuda, spans)
        peak = max(peaks + [torch.cuda.max_memory_allocated()]) if cuda \
            else 0
    n = len(sweeps)
    own = [round(sum(j["watch_s"] for j in s["jobs"]), 3) for s in sweeps]
    ctx.log(f"window {window_s:.3f} s, {n} sweeps of "
            f"{[round(s['seconds'], 3) for s in sweeps]} s (the watch's "
            f"{own} s), plans {[sorted(s['chosen'].items()) for s in sweeps]}")
    counts = {"rows_not_done": 0, "plan_not_least": 0, "jobs_not_as_set": 0}
    for s in sweeps:
        for k, v in check_sweep(s, t).items():
            counts[k] += v
    gaps = {k: {"value": float(v), "at": "sweeps"} for k, v in counts.items()}
    gaps.update(segment_gaps(sweeps, watch, ctx))
    for s in sweeps:
        s.pop("jobs")
    # the last plan's first steps, from the seed's weights and rows
    prog = Program(ctx, arch, sweeps[-1]["plan"], t)
    try:
        first = prog.first_steps(t["check_steps"])
    finally:
        prog.close()
    ref = reference_readings(ctx, arch, t)
    gaps.update(verdict.training_gaps(first, ref))
    for name, g in gaps.items():
        ctx.log(f"{name} at {g['at']}")
    readings = {"sweeps": sweeps, "window_s": window_s, "trace": trace,
                "spans_host_s": spans.host_s() if spans else {}}
    rows = sum(len(s["rows"]) for s in sweeps)
    return {"setup_s": setup_s, "e2e": {"plan_s": window_s / n},
            "readings": readings, "attempted": rows,
            "failed": sum(s["n_failed"] for s in sweeps),
            "memory_peak_bytes": peak, "trace": trace, "gaps": gaps}
