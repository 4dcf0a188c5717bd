"""Executors: score one combination on one segment, as the reference's
``src/repro/core/executor.py``.

* :class:`WallClockExecutor` — ComPar's empirical loop: run the segment's
  program and take the median time.  On a CUDA device each call is timed
  by a pair of CUDA events on the current stream; on the CPU by
  ``time.perf_counter``.
* :class:`DryRunExecutor` — no device at all: the program runs on fake
  tensors (``FakeTensorMode``) while :class:`OpCounter` counts its flops
  (``FlopCounterMode``) and the bytes each operator reads and writes, the
  hand-written kernels' ops among them (``kernels/ops.py``).  The
  roofline terms divide those by an H100's peak rates.  It stands where
  the reference reads flops and bytes from XLA's compiled HLO.

A per-combination ``deadline`` makes a straggler a recorded failure.
"""
from __future__ import annotations

import gc
import math
import platform
import signal
import statistics
import threading
import time
import weakref
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.combinator import Combination, GlobalKnobs
from repro_torch.core.cost_model import (H100, CostTerms, Hardware,
                                         combo_lower_bound,
                                         terms_from_analysis)
from repro_torch.core.segment import Segment
from repro_torch.core.timer import segment_program
from repro_torch.device import resolve_device
from repro_torch.runtime import trace


class CombinationFailed(Exception):
    """A combination could not be scored.

    ``transient`` marks outcomes that depend on load or the time budget
    (deadline overruns): retryable, and never cached.  Deterministic
    failures (an op that raises, a program that does not fit the card)
    are cached like scores.
    """

    def __init__(self, msg: str = "", *, transient: bool = False):
        super().__init__(msg)
        self.transient = transient


@contextmanager
def deadline(seconds: Optional[float]):
    """Straggler guard.

    On the main thread: SIGALRM, which interrupts the job.  Off the main
    thread ``signal`` is unavailable, so the block runs to completion and
    is then failed if it overran its thread's CPU time (a soft deadline).
    """
    if not seconds:
        yield
        return

    if threading.current_thread() is not threading.main_thread():
        t0 = time.thread_time()
        yield
        if time.thread_time() - t0 > seconds:
            raise CombinationFailed(f"deadline {seconds}s exceeded (soft)",
                                    transient=True)
        return

    def handler(signum, frame):
        raise CombinationFailed(f"deadline {seconds}s exceeded",
                                transient=True)

    old = signal.signal(signal.SIGALRM, handler)
    signal.setitimer(signal.ITIMER_REAL, float(seconds))
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, old)


def _failure(e: BaseException) -> CombinationFailed:
    """A fresh CombinationFailed for ``e``, holding no traceback (whose
    frames would keep the job's tensors alive)."""
    if isinstance(e, CombinationFailed):
        return CombinationFailed(str(e), transient=e.transient)
    msg = str(e).strip().splitlines()[0] if str(e).strip() else ""
    return CombinationFailed(f"{type(e).__name__}: {msg}")


# --- the dry run's op accounting ------------------------------------------------

#: the namespaces of ``torch.distributed``'s collective operators
_COLLECTIVES = {"_c10d_functional", "c10d", "c10d_functional"}

#: ops that move no data: factories that leave memory unwritten
_NO_DATA = {"empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided", "lift_fresh"}


def _sdpa_flops(func, args) -> float:
    """Flops of a ``_scaled_dot_product*`` op that ``FlopCounterMode`` has
    no formula for (the CPU's ``_for_cpu`` variants): the forward's two
    products, 4 B H Sq Sk D; the backward's five, 2.5 times that."""
    q, k = args[0], args[1]
    fwd = 4.0 * math.prod(q.shape[:-1]) * k.shape[-2] * q.shape[-1]
    return 2.5 * fwd if "backward" in func.overloadpacket.__name__ else fwd


def _touched_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a tensor covers (a broadcast dim,
    stride 0, is read once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def _group_size(args) -> int:
    """The size of the process group a collective runs over: its group
    name is its last string argument."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in reversed(args):
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except Exception:
                continue
    return 1


class OpCounter(TorchDispatchMode):
    """Counts a program's work as it runs (on fake tensors, in the dry
    run): flops by ``torch.utils.flop_counter.FlopCounterMode`` (every
    ``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolution and
    ``_scaled_dot_product_*`` op, and the hand-written kernels' ops by the
    formulas ``kernels/ops.py`` registers), bytes as each operator's
    inputs read and outputs written once (views and uninitialised
    allocations move nothing).  A kernel op counts as one operator: its
    inputs and outputs, flash-decode's whole cache with them.

    Each operator is kept as a ``runtime.hlo.OpRecord``; a collective
    (``_c10d_functional``) is charged the bytes it moves per device, its
    result's bytes at the reference's ring factor for its group's size
    (``runtime.hlo._collective_moved``).  ``analysis()`` gives the
    reference's ``analyze_hlo`` keys.  The counter also tracks the bytes
    of the storages the program allocates while they live: ``peak_live``
    is their peak (each rank's local shards under a mesh)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self._flops = FlopCounterMode(display=False)
        self.extra_flops = 0.0
        self.bytes = 0
        self.coll_bytes = 0.0
        self.records = []
        self.live = 0
        self.peak_live = 0
        self._seen = set()

    def __enter__(self):
        self._flops.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self._flops.__exit__(*exc)

    @property
    def flops(self) -> float:
        return self._flops.get_total_flops() + self.extra_flops

    def flops_by_op(self) -> Dict[str, float]:
        """Flops of each counted operator, by its name (``mm``,
        ``flash_attention``, ...)."""
        return {op.__name__.split(".")[-1]: float(n) for op, n in
                self._flops.get_flop_counts().get("Global", {}).items()}

    def analysis(self) -> Dict[str, float]:
        """``runtime.hlo.analyze_ops`` of the stream: ``flops``,
        ``bytes``, ``collective``, ``coll_<kind>``."""
        from repro_torch.runtime.hlo import analyze_ops
        return analyze_ops(self.records, self.flops)

    def _track(self, out, args):
        """Count the storages ``out`` allocates until they die."""
        ins = {id(t) for t in pytree_leaves(args)
               if isinstance(t, torch.Tensor)}
        for t in pytree_leaves(out):
            if not isinstance(t, torch.Tensor) or id(t) in ins:
                continue
            try:
                st = t.untyped_storage()
            except Exception:       # a wrapper subclass without storage
                continue
            key = id(st)
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen.add(key)
            self.live += n
            self.peak_live = max(self.peak_live, self.live)
            weakref.finalize(st, self._free, key, n)

    def _free(self, key, n):
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry
        from repro_torch.runtime.hlo import OpRecord, collective_kind
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if name.startswith("_scaled_dot_product") and \
                func.overloadpacket not in flop_registry:
            self.extra_flops += _sdpa_flops(func, args)
        full = f"{func.namespace}.{name}"
        if func.namespace in _COLLECTIVES:
            kind = collective_kind(name)
            if kind is not None:
                rec = OpRecord(full, 0, kind, sum(
                    _touched_bytes(t) for t in pytree_leaves(out)
                    if isinstance(t, torch.Tensor)), _group_size(args))
                self.coll_bytes += rec.moved
                self.records.append(rec)
        elif not (func.namespace == "prim" or getattr(func, "is_view", False)
                  or name in _NO_DATA):
            n = sum(_touched_bytes(t) for t in pytree_leaves((args, kwargs,
                                                                out))
                    if isinstance(t, torch.Tensor))
            self.bytes += n
            self.records.append(OpRecord(full, n))
        if not getattr(func, "is_view", False):
            self._track(out, (args, kwargs))
        return out


def _job_mesh(executor, mesh):
    """The mesh a job builds under: its own point (a ``DeviceMesh``, or a
    ``MeshSpec`` materialized here) or the executor's fixed one."""
    from repro_torch.core.meshspec import live_mesh
    return executor.mesh if mesh is None else live_mesh(mesh)


class DryRunExecutor:
    """Analytic scoring: flops and bytes of the segment's program on fake
    tensors (no device memory), over ``hw``'s peak rates.

    Under a mesh the program runs on DTensors over fake tensors, so the
    counter sees each rank's local operators: the counts are one
    device's, and each collective is charged the bytes it moves at the
    reference's ring factor for its group (``runtime.hlo``).  A mesh
    needs its process group (``MeshSpec.to_mesh``), as the reference's dry
    run needs its devices: a real one, or a fake one of at least its size
    (``launch.mesh.fake_group``)."""

    #: analytic scoring: concurrent workers don't perturb each other
    parallel_safe = True

    def __init__(self, hw: Hardware = H100,
                 timeout_s: Optional[float] = 300, mesh=None):
        self.hw = hw
        self.timeout_s = timeout_s
        self.mesh = mesh

    @property
    def n_chips(self) -> int:
        from repro_torch.launch.mesh import mesh_chips
        return mesh_chips(self.mesh)

    @property
    def cache_tag(self) -> str:
        """Score-cache identity: scores of another executor or hardware
        model are never served."""
        return f"dryrun:{self.hw.name}"

    def count(self, cfg: ArchConfig, shape: ShapeConfig, seg: Segment,
              combo: Combination,
              knobs: Optional[GlobalKnobs] = None,
              mesh=None) -> OpCounter:
        """Run the segment's program on fake tensors under an OpCounter."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        mesh = _job_mesh(self, mesh)
        with FakeTensorMode(allow_non_fake_inputs=True):
            fn, args = segment_program(
                cfg, shape, seg, combo, knobs=knobs, mesh=mesh,
                device=mesh.device_type if mesh is not None else "cpu")
            with OpCounter() as counter:
                fn(*args)
        return counter

    def score_segment(self, cfg: ArchConfig, shape: ShapeConfig,
                      seg: Segment, combo: Combination,
                      knobs: Optional[GlobalKnobs] = None,
                      mesh=None) -> CostTerms:
        err = None
        try:
            with deadline(self.timeout_s):
                counter = self.count(cfg, shape, seg, combo, knobs, mesh)
        except Exception as e:      # the program fails = invalid combination
            err = _failure(e)
        if err is not None:
            raise err
        # the counts are one device's: no division by the chip count
        return terms_from_analysis(counter.flops, counter.bytes,
                                   counter.coll_bytes, 1, self.hw)


class WallClockExecutor:
    """Empirical timing on one device: ComPar's measurement loop.

    The program is built once, called once to warm up, then timed over
    ``repeats`` calls; the score is the median.  A combination that does
    not fit the card (``torch.cuda.OutOfMemoryError``) is a recorded
    failure, as a compiler failing on a benchmark is in ComPar.  Every
    tensor of a job is released before the next one starts.
    """

    #: concurrent timed runs contend on the device and corrupt medians
    parallel_safe = False

    def __init__(self, device="cuda", repeats: int = 5,
                 timeout_s: Optional[float] = 120, mesh=None):
        self.device = resolve_device(device)
        self.repeats = repeats
        self.timeout_s = timeout_s
        self.mesh = mesh

    @property
    def n_chips(self) -> int:
        from repro_torch.launch.mesh import mesh_chips
        return mesh_chips(self.mesh)

    @property
    def cache_tag(self) -> str:
        # measured times are the hardware's: medians from different cards
        # (or hosts) never share a score-cache row
        name = torch.cuda.get_device_name(self.device) \
            if self.device.type == "cuda" else platform.machine()
        return f"wallclock:r{self.repeats}:{self.device.type}:{name}"

    def _measure(self, cfg, shape, seg, combo, knobs, mesh):
        cuda = self.device.type == "cuda"
        with trace.span("score.build"):
            fn, args = segment_program(cfg, shape, seg, combo,
                                       device=self.device, knobs=knobs,
                                       mesh=mesh)
        # lend: a program's backward opens spans on autograd's device thread
        with trace.span("score.warmup", lend=True):
            out = fn(*args)
            if cuda:
                torch.cuda.synchronize(self.device)
            del out
        times, events = [], []
        with trace.span("score.timed", lend=True):
            for _ in range(self.repeats):
                if cuda:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    out = fn(*args)
                    end.record()
                    events.append((start, end))
                else:
                    t0 = time.perf_counter()
                    out = fn(*args)
                    times.append(time.perf_counter() - t0)
                del out
            if cuda:
                torch.cuda.synchronize(self.device)
                times = [s.elapsed_time(e) / 1e3 for s, e in events]
        return times

    def score_segment(self, cfg: ArchConfig, shape: ShapeConfig,
                      seg: Segment, combo: Combination,
                      knobs: Optional[GlobalKnobs] = None,
                      mesh=None) -> CostTerms:
        from repro_torch.launch.mesh import FakeGroupError, is_fake_group
        if is_fake_group():
            raise FakeGroupError("the wall clock cannot time on a fake "
                                 "process group: its collectives move "
                                 "nothing (use the dry run)")
        mesh = _job_mesh(self, mesh)
        cuda = self.device.type == "cuda"
        with trace.span("score.job", counted=True, segment=seg.name,
                        cid=combo.cid):
            if cuda:
                torch.cuda.synchronize(self.device)
                torch.cuda.reset_peak_memory_stats(self.device)
            err = None
            try:
                with deadline(self.timeout_s):
                    times = self._measure(cfg, shape, seg, combo, knobs,
                                          mesh)
            except Exception as e:
                err = _failure(e)
            peak = 0
            with trace.span("score.release"):
                # the job's tensors die with _measure's frame (the failure
                # keeps no traceback): hand their blocks back before the
                # next job
                with trace.span("score.gc"):
                    gc.collect()
                with trace.span("score.free"):
                    if cuda:
                        torch.cuda.synchronize(self.device)
                        peak = torch.cuda.max_memory_allocated(self.device)
                        torch.cuda.empty_cache()
        if err is not None:
            raise err
        wall = statistics.median(times)
        t = CostTerms(compute_s=wall, bytes_per_device=float(peak))
        t.detail.update({"wall_s": wall, "repeats_s": times,
                         "peak_bytes": float(peak)})
        return t


class SleepExecutor:
    """Deterministic straggler: sleeps ``sleep_s`` per job *without* arming
    the deadline, the stand-in for a hung native call that SIGALRM cannot
    interrupt.  Exercises the process backend's hard (kill-based) timeout
    in tests; never used in real sweeps.

    With a ``device`` it stands in for a wall-clock executor timing on
    that device (``parallel_safe`` False); with a ``log`` path it appends
    each job's start and end (``time.time()``) to that file.  The scoring
    server's one-timing-per-device rule is tested with both."""

    n_chips = 1

    def __init__(self, sleep_s: float = 3600.0,
                 timeout_s: Optional[float] = None,
                 device: Optional[str] = None, log: Optional[str] = None):
        self.sleep_s = sleep_s
        self.timeout_s = timeout_s
        self.device = device
        self.log = log
        self.parallel_safe = device is None

    @property
    def cache_tag(self) -> str:
        return f"sleep:{self.sleep_s}"

    def score_segment(self, cfg: ArchConfig, shape: ShapeConfig,
                      seg: Segment, combo: Combination,
                      knobs: Optional[GlobalKnobs] = None,
                      mesh=None) -> CostTerms:
        start = time.time()
        time.sleep(self.sleep_s)
        if self.log is not None:
            with open(self.log, "a") as f:
                f.write(f"{start!r} {time.time()!r}\n")
        return CostTerms(compute_s=self.sleep_s)


class CrashExecutor:
    """Kills its own process on every job, the stand-in for a dying
    worker: exercises the process backend's crash detection and its
    requeue-once-then-fail policy in tests; never used in real sweeps."""

    parallel_safe = True
    n_chips = 1

    def __init__(self, timeout_s: Optional[float] = None):
        self.timeout_s = timeout_s

    @property
    def cache_tag(self) -> str:
        return "crash"

    def score_segment(self, cfg: ArchConfig, shape: ShapeConfig,
                      seg: Segment, combo: Combination,
                      knobs: Optional[GlobalKnobs] = None,
                      mesh=None) -> CostTerms:
        import os
        os._exit(13)


# --- the sweep runner -----------------------------------------------------------

# One unique program to score; ``segments`` lists the incumbent scopes of
# every (segment, combination) row that shares it.  The dataclass lives in
# backends.base, where the Scheduler builds it.
from repro_torch.core.backends.base import JobSpec as SweepJob  # noqa: E402


@dataclass
class JobResult:
    job: SweepJob
    status: str                       # done | failed | pruned
    cost: Optional[CostTerms] = None
    error: str = ""
    transient: bool = False           # deadline: retryable, uncacheable


class ParallelSweepRunner:
    """Score unique (segment, combination) programs, in-thread or on a
    thread pool.

    * ``workers=1`` is a plain in-thread loop, so the hard (SIGALRM)
      deadline applies on the main thread.
    * With ``prune=True`` a job whose analytic lower bound exceeds the
      incumbent best of every member scope is skipped as ``pruned``
      (exact: bound <= score).  Jobs run cheapest-bound-first.
    """

    def __init__(self, executor, cfg: ArchConfig, shape: ShapeConfig, *,
                 workers: int = 1, prune: bool = False,
                 prune_margin: float = 0.1):
        from repro_torch.core.backends.base import IncumbentTracker
        self.executor = executor
        self.cfg = cfg
        self.shape = shape
        self.workers = max(1, int(workers))
        self.prune = prune
        self.prune_margin = prune_margin
        self.tracker = IncumbentTracker(prune, prune_margin)

    def _run_job(self, job: SweepJob) -> JobResult:
        if self.tracker.pruned(job):
            return JobResult(job, "pruned",
                             error=f"lower bound {job.bound_s:.3e}s > "
                                   f"incumbent best")
        kw = {}
        if job.mesh is not None:
            # a swept point: materialize it here (memoized per process) and
            # build under it instead of the executor's own mesh
            from repro_torch.core.meshspec import (MeshUnsatisfiable,
                                                   cached_mesh)
            try:
                kw["mesh"] = cached_mesh(job.mesh)
            except MeshUnsatisfiable as e:
                # environment-dependent, not a verdict on the combination
                return JobResult(job, "failed", error=str(e), transient=True)
        try:
            cost = self.executor.score_segment(
                self.cfg, self.shape, job.seg, job.combo, knobs=job.knobs,
                **kw)
        except CombinationFailed as e:
            return JobResult(job, "failed", error=str(e),
                             transient=getattr(e, "transient", False))
        except Exception as e:
            # a scorer's own bug fails the row, not the sweep
            return JobResult(job, "failed", error=f"{type(e).__name__}: {e}")
        self.tracker.observe(job.segments, cost.total_s)
        return JobResult(job, "done", cost=cost)

    def run(self, jobs: Sequence[SweepJob],
            incumbents: Optional[Dict[str, float]] = None
            ) -> Iterator[JobResult]:
        """Yield a :class:`JobResult` per job as each completes.
        ``incumbents``: scope -> best known total_s, to seed pruning."""
        self.tracker.seed(incumbents)
        hw = getattr(self.executor, "hw", H100)
        for job in jobs:
            if job.bound_s <= 0.0:      # Scheduler-built jobs arrive bounded
                job.bound_s = combo_lower_bound(
                    self.cfg, self.shape, job.seg, job.combo, 1, hw,
                    knobs=job.knobs)
        ordered = sorted(jobs, key=lambda j: (j.bound_s, j.key))

        if self.workers == 1:
            for job in ordered:
                yield self._run_job(job)
            return

        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            pending = {pool.submit(self._run_job, j) for j in ordered}
            while pending:
                finished, pending = wait(pending,
                                         return_when=FIRST_COMPLETED)
                for fut in finished:
                    yield fut.result()

