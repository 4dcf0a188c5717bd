"""Process backend: score unique programs in spawned worker processes, as
the reference's ``src/repro/core/backends/process.py``.

Thread workers share one interpreter, and their off-main-thread deadline
is *soft*: a hung program still occupies its thread forever.  Spawned
workers give two layers of deadline:

* **in-worker hard deadline**: jobs run on the worker process's main
  thread, so the executor's SIGALRM deadline interrupts a hung program
  between Python calls (the worker reports a transient failure and stays
  warm);
* **parent-side kill**: the backstop for hangs SIGALRM cannot reach
  (native code that never returns to the interpreter): a worker busy past
  ``timeout_s * (1 + kill_grace)`` is terminated, its job requeued once
  onto another worker, and on a second loss recorded as a **transient**
  failure.  The sweep can never hang on one combination.

Worker lifecycle: workers are warm (one torch import, executor and CUDA
context per process, reused across jobs AND across ``run()`` calls; only
``close()`` tears the pool down), crash-detected (an exiting worker fails
its job through the same requeue-once-then-fail policy) and replaced
lazily while work remains.  Each worker holds a read-only view of the
score cache (``ScoreCacheReader`` on the WAL DB), so groups another sweep
scored mid-run are served without running.

On a card each worker owns its own CUDA context and loads the kernel
libraries that ``kernels/build.py`` left in ``build/torch_ext/`` (a cold
build would land in the first job's deadline).  The parent never forks
itself (see :func:`_resolve_ctx`), so its own CUDA context never reaches a
worker.  Killing a worker ends its context, and the card gets its
memory back.

Launch counts (``kernels.LAUNCHES``) are per process: each worker returns
its totals on the acknowledgement of its shutdown message, and
:attr:`ProcessBackend.launches` sums them over the workers that shut down
cleanly (a port-only addition; ``JobOutcome``'s wire fields stay the
reference's).

Everything crosses the process boundary as the JSON wire format of
``backends.base`` (JobSpec / JobOutcome + arch/shape registry specs), the
form the scoring server (``server.py``) speaks too.
"""
from __future__ import annotations

import logging
import multiprocessing as mp
import multiprocessing.connection
import shutil
import tempfile
import time
from collections import deque
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from repro_torch.core.backends.base import (DONE, FAILED, PRUNED,
                                            IncumbentTracker, JobOutcome,
                                            JobSpec, RetryPolicy,
                                            ScoringBackend,
                                            executor_from_spec,
                                            executor_to_spec)

log = logging.getLogger("repro_torch.backends.process")

_POLL_S = 0.05          # parent event-loop tick
_SPAWN_TIMEOUT_S = 120  # budget for a worker to import torch and report ready
_SHUTDOWN_S = 5.0       # a worker's grace to acknowledge shutdown and exit

#: set once the forkserver has been asked to preload torch (the request is
#: sticky for the life of the forkserver process)
_FORKSERVER_PRELOADED = False


def _resolve_ctx(start_method: str):
    """Resolve a start-method name to a multiprocessing context.

    ``"auto"`` prefers **forkserver** with torch preloaded into the server
    process: the stdlib forkserver is a fresh interpreter (started by
    exec, never forked from the caller) that imports the preload list
    once, and every worker then *forks* from that warm interpreter.
    Importing torch initialises no CUDA, so no worker inherits a CUDA
    context, whatever the caller holds: the caller's context is never
    forked ("Cannot re-initialize CUDA in forked subprocess").  Platforms
    without forkserver take ``"spawn"``.  Explicit method names pass
    through unchanged.
    """
    global _FORKSERVER_PRELOADED
    if start_method != "auto":
        return mp.get_context(start_method)
    if "forkserver" not in mp.get_all_start_methods():
        return mp.get_context("spawn")
    ctx = mp.get_context("forkserver")
    if not _FORKSERVER_PRELOADED:
        try:
            ctx.set_forkserver_preload(["torch"])
            _FORKSERVER_PRELOADED = True
        except Exception as e:     # pragma: no cover - stdlib quirk
            log.debug("forkserver preload unavailable: %s", e)
    return ctx


# --- worker side -------------------------------------------------------------

def _score_one(executor, cfg, shape, spec: JobSpec, cache, shape_key: str,
               mesh_key: str) -> JobOutcome:
    from repro_torch.core.executor import CombinationFailed
    env = spec.mesh_key or mesh_key
    if cache is not None and spec.signature:
        hit = cache.get(spec.signature, shape_key, env, spec.eff_cid)
        if hit is not None and hit["status"] in (DONE, FAILED):
            return JobOutcome(spec.key, hit["status"], cost=hit["cost"],
                              error=hit["error"], cached=True)
    kw = {}
    if spec.mesh is not None:
        # the swept point: THIS worker materializes it for itself
        # (memoized across its jobs)
        from repro_torch.core.meshspec import MeshUnsatisfiable, cached_mesh
        try:
            kw["mesh"] = cached_mesh(spec.mesh)
        except MeshUnsatisfiable as e:
            # environment-dependent (another process group may satisfy
            # it): transient, so retryable and never cached
            return JobOutcome(spec.key, FAILED, error=str(e), transient=True,
                              kind="mesh")
    try:
        cost = executor.score_segment(cfg, shape, spec.seg, spec.combo,
                                      knobs=spec.knobs, **kw)
    except CombinationFailed as e:
        transient = getattr(e, "transient", False)
        return JobOutcome(spec.key, FAILED, error=str(e),
                          transient=transient,
                          kind="deadline" if transient else "")
    except Exception as e:
        # a scorer's own bug fails the row, not the worker
        return JobOutcome(spec.key, FAILED,
                          error=f"{type(e).__name__}: {e}")
    return JobOutcome(spec.key, DONE, cost=cost.as_dict())


def _worker_main(conn, init: Dict):
    """Worker process entry point: build cfg/shape/executor once (warm
    reuse), then serve JobSpec JSON until a ``None`` shutdown message,
    answered with this process's kernel launch totals.  On its way out it
    destroys the world-size-1 group a swept mesh point made; the group's
    store lies in the pool's directory, which the parent removes.

    A worker that cannot build its executor (a wall-clock spec on a host
    whose CUDA it cannot reach) still reports ready and fails every job it
    is given, transient (never cached), kind ``"crash"``: it never scores
    them anywhere else."""
    from repro_torch.configs.registry import arch_from_spec, shape_from_spec
    from repro_torch.core.db import ScoreCacheReader
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.launch import mesh as M
    cache = None
    M.STORE_ROOT = init.get("tmp_dir")
    try:
        cfg = arch_from_spec(init["arch"])
        shape = shape_from_spec(init["shape"])
        # allow_test: a local worker trusts its parent process (the
        # fault-injection executors exist for the backend's own tests)
        executor = executor_from_spec(init["executor"], allow_test=True)
        cache = ScoreCacheReader(init["db_path"]) \
            if init.get("db_path") else None
        broken = ""
    except Exception as e:
        broken = f"worker setup failed: {type(e).__name__}: {e}"
    conn.send({"ready": True})
    try:
        while True:
            msg = conn.recv()
            if msg is None:
                conn.send({"launches": dict(LAUNCHES)})
                return
            spec = JobSpec.from_json(msg)
            if broken:
                out = JobOutcome(spec.key, FAILED, error=broken,
                                 transient=True, kind="crash")
            else:
                out = _score_one(executor, cfg, shape, spec, cache,
                                 init.get("shape_key", ""),
                                 init.get("mesh_key", ""))
            conn.send(out.to_json())
    except (EOFError, BrokenPipeError, KeyboardInterrupt):
        return
    finally:
        if cache is not None:
            cache.close()
        # the group (and its store) a swept mesh point made in this worker
        M.destroy_group()


# --- parent side -------------------------------------------------------------

class _Worker:
    __slots__ = ("proc", "conn", "job", "started", "spawned", "ready", "wid")

    def __init__(self, proc, conn, wid: int):
        self.proc = proc
        self.conn = conn
        self.wid = wid
        self.job: Optional[JobSpec] = None
        self.started: float = 0.0
        self.spawned: float = time.monotonic()
        self.ready = False


class ProcessBackend(ScoringBackend):
    """Score jobs on a pool of spawned worker processes with hard
    preemptive per-job timeouts and requeue-once-then-fail recovery."""

    name = "process"
    #: dispatches per job before a loss becomes a transient failure
    max_attempts = 2
    #: parent kills at timeout_s * (1 + grace): the worker's in-process
    #: SIGALRM fires at timeout_s and reports gracefully (keeping the
    #: worker warm); the parent kill is the backstop for native hangs
    kill_grace = 0.2

    def __init__(self, executor, cfg, shape, *, workers: int = 2,
                 prune: bool = False, prune_margin: float = 0.1,
                 timeout_s: Optional[float] = None,
                 db_path: Optional[str] = None,
                 shape_key: str = "", mesh_key: str = "",
                 start_method: str = "auto",
                 retry: Optional[RetryPolicy] = None,
                 fault_plan=None):
        from repro_torch.configs.registry import arch_to_spec, shape_to_spec
        self.workers = max(1, int(workers))
        self.timeout_s = timeout_s
        if retry is not None:
            self.max_attempts = max(1, retry.max_attempts)
        #: FaultPlan consulted at "process.kill_worker" after each
        #: dispatch (tests only; None in production = one branch per job)
        self.fault_plan = fault_plan
        self.prune = prune
        self.prune_margin = prune_margin
        self.tracker = IncumbentTracker(prune, prune_margin)
        self._ctx = _resolve_ctx(start_method)
        self._pool: List[_Worker] = []
        self._next_wid = 0
        self._deaths = 0            # workers lost (crash or kill)
        #: (job key, worker id) per successful dispatch of the last run:
        #: the observable record of the requeue-diversification policy
        self.dispatch_log: List[Tuple[str, int]] = []
        #: seconds from each worker's start to its ready message
        self.spawn_s: List[float] = []
        #: kernel launches (``kernels.LAUNCHES``) summed over the workers
        #: that acknowledged their shutdown
        self.launches: Dict[str, int] = {}
        self._init = {
            "executor": executor_to_spec(executor),
            "arch": arch_to_spec(cfg),
            "shape": shape_to_spec(shape),
            "db_path": db_path if db_path and db_path != ":memory:" else None,
            "shape_key": shape_key,
            "mesh_key": mesh_key,
            # the workers' group stores, made with the first worker and
            # removed on close(), so that a worker killed mid-job leaves
            # none behind
            "tmp_dir": None,
        }

    # ------------------------------------------------------------------
    def _spawn(self) -> _Worker:
        if self._init["tmp_dir"] is None:
            self._init["tmp_dir"] = tempfile.mkdtemp(
                prefix="repro_torch_workers_")
        parent, child = self._ctx.Pipe(duplex=True)
        proc = self._ctx.Process(target=_worker_main,
                                 args=(child, self._init), daemon=True)
        proc.start()
        child.close()
        w = _Worker(proc, parent, self._next_wid)
        self._next_wid += 1
        self._pool.append(w)
        return w

    def _kill(self, w: _Worker):
        if w in self._pool:
            self._pool.remove(w)
        try:
            w.proc.terminate()
            w.proc.join(timeout=5)
            if w.proc.is_alive():
                w.proc.kill()
                w.proc.join(timeout=5)
        finally:
            try:
                w.conn.close()
            except OSError:
                pass
        self._deaths += 1

    def warmup(self, timeout_s: float = _SPAWN_TIMEOUT_S):
        """Spawn the full pool and block until every worker reports ready
        (torch imported, executor built).  Optional (``run`` spawns
        lazily), but keeps worker start-up out of timing windows."""
        while len(self._pool) < self.workers:
            self._spawn()
        t0 = time.monotonic()
        while any(not w.ready for w in self._pool):
            if time.monotonic() - t0 > timeout_s:
                self.close()        # don't leak the healthy workers
                raise RuntimeError("process-backend worker failed to start "
                                   f"within {timeout_s}s")
            for w in list(self._pool):
                if not w.ready and not w.proc.is_alive():
                    wid, code = w.wid, w.proc.exitcode
                    self.close()
                    raise RuntimeError(
                        f"worker {wid} died during startup (exit {code})")
            self._drain_messages(block_s=_POLL_S)

    # ------------------------------------------------------------------
    def _drain_messages(self, block_s: float = _POLL_S) -> List[JobOutcome]:
        """Receive ready-pings and outcomes from every live worker."""
        outcomes: List[JobOutcome] = []
        conns = {w.conn: w for w in self._pool}
        if not conns:
            time.sleep(block_s)
            return outcomes
        for conn in mp.connection.wait(list(conns), timeout=block_s):
            w = conns[conn]
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                continue        # death handled by the liveness check
            if isinstance(msg, dict) and msg.get("ready"):
                w.ready = True
                self.spawn_s.append(time.monotonic() - w.spawned)
                continue
            out = JobOutcome.from_json(msg)
            if out.status == DONE and out.cost and w.job is not None:
                from repro_torch.core.cost_model import CostTerms
                self.tracker.observe(w.job.segments,
                                     CostTerms.from_dict(out.cost).total_s)
            w.job = None
            outcomes.append(out)
        return outcomes

    def _lose(self, w: _Worker, reason: str, queue, attempts, excluded,
              kind: str = "crash") -> Optional[JobOutcome]:
        """A busy worker died or was killed: requeue its job until the
        retry policy's ``max_attempts`` is burned, then fail it as
        transient.  The lost worker's id joins the job's excluded set, so
        the retry goes to a different worker."""
        job = w.job
        self._kill(w)
        excluded.setdefault(job.key, set()).add(w.wid)
        attempts[job.key] = attempts.get(job.key, 0) + 1
        if attempts[job.key] >= self.max_attempts:
            log.warning("job %s lost %d times (%s): transient failure",
                        job.key, attempts[job.key], reason)
            return JobOutcome(job.key, FAILED, error=f"{reason}; requeue "
                              "limit reached", transient=True,
                              attempts=attempts[job.key], kind=kind)
        log.warning("job %s lost (%s): requeued", job.key, reason)
        queue.appendleft(job)
        return None

    def _next_job(self, w: _Worker, queue, excluded: Dict[str, Set[int]],
                  attempts: Dict[str, int]
                  ) -> Tuple[Optional[JobSpec], List[JobOutcome]]:
        """Pop the first job dispatchable to ``w``: pruned jobs are
        settled on the spot (returned for yielding); jobs excluded on
        ``w`` (they died in its hands once) stay queued for another
        worker."""
        pruned: List[JobOutcome] = []
        skipped: List[JobSpec] = []
        job = None
        while queue:
            j = queue.popleft()
            if self.tracker.pruned(j):
                pruned.append(JobOutcome(
                    j.key, PRUNED,
                    error=f"lower bound {j.bound_s:.3e}s > incumbent best",
                    attempts=attempts.get(j.key, 0) + 1))
                continue
            if w.wid in excluded.get(j.key, ()):
                skipped.append(j)
                continue
            job = j
            break
        for j in reversed(skipped):
            queue.appendleft(j)
        return job, pruned

    def _dispatch(self, w: _Worker, job: JobSpec, queue) -> bool:
        """Send ``job`` to ``w``; on a dead pipe the job goes back to the
        queue attempt-free (it never started) and the worker is culled."""
        try:
            w.conn.send(job.to_json())
        except (OSError, ValueError):
            queue.appendleft(job)
            self._kill(w)
            return False
        w.job = job
        w.started = time.monotonic()
        self.dispatch_log.append((job.key, w.wid))
        if self.fault_plan is not None and \
                self.fault_plan.fires("process.kill_worker") is not None:
            # chaos: the worker dies holding the job it just accepted; the
            # liveness check sees the crash and requeues per policy
            log.warning("fault injection: killing worker %d holding %s",
                        w.wid, job.key)
            w.proc.terminate()
        return True

    # ------------------------------------------------------------------
    def run(self, jobs: Sequence[JobSpec],
            incumbents: Optional[Dict[str, float]] = None
            ) -> Iterator[JobOutcome]:
        """Score ``jobs``; the worker pool survives the call.

        Successive ``run()`` calls reuse the warm workers (torch imported,
        executor built, CUDA context up), which keeps an outer knob axis
        and repeated sweeps through a cached tuner engine from paying the
        spawn per call.  Incumbents do NOT carry over: each run gets a
        fresh tracker seeded only from its own ``incumbents``.
        """
        # a previous run that ended in an error or an abandoned generator
        # can leave dead workers in the pool: cull them first
        for w in list(self._pool):
            if not w.proc.is_alive():
                self._kill(w)
        self.tracker = IncumbentTracker(self.prune, self.prune_margin)
        self.tracker.seed(incumbents)
        self._deaths = 0
        self.dispatch_log = []
        queue = deque(jobs)
        attempts: Dict[str, int] = {}
        excluded: Dict[str, Set[int]] = {}
        death_budget = 2 * self.workers + self.max_attempts * len(queue) + 4
        try:
            while queue or any(w.job is not None for w in self._pool):
                # keep the pool at strength while work remains
                busy = sum(1 for w in self._pool if w.job is not None)
                need = min(self.workers, busy + len(queue))
                while len(self._pool) < need:
                    self._spawn()

                # dispatch to ready idle workers, oldest-spawned first
                # (pruning at dispatch time); a requeued job skips the
                # workers in its excluded set
                idle = [w for w in self._pool if w.job is None and w.ready]
                idle.sort(key=lambda w: (w.spawned, w.wid))
                dispatched = False
                for w in idle:
                    job, pruned_outs = self._next_job(w, queue, excluded,
                                                      attempts)
                    for out in pruned_outs:
                        yield out
                    if job is None:
                        continue
                    if self._dispatch(w, job, queue):
                        dispatched = True
                if (queue and not dispatched
                        and not any(w.job is not None for w in self._pool)
                        and any(w.job is None and w.ready and w in self._pool
                                for w in idle)):
                    # every idle worker is excluded for every queued job and
                    # nothing is in flight: exclusion degrades to a
                    # dispatch, never to a stalled sweep
                    w = next(w for w in idle
                             if w.job is None and w.ready and w in self._pool)
                    self._dispatch(w, queue.popleft(), queue)

                for out in self._drain_messages():
                    out.attempts = attempts.get(out.key, 0) + 1
                    yield out

                now = time.monotonic()
                kill_after = self.timeout_s * (1.0 + self.kill_grace) \
                    if self.timeout_s else None
                for w in list(self._pool):
                    if w.job is None:
                        if not w.proc.is_alive():
                            self._kill(w)       # idle death: just cull
                        elif not w.ready and \
                                now - w.spawned > _SPAWN_TIMEOUT_S:
                            log.warning("worker %d hung during startup; "
                                        "killed", w.wid)
                            self._kill(w)
                        continue
                    if kill_after and now - w.started > kill_after:
                        out = self._lose(
                            w, f"hard deadline {self.timeout_s}s exceeded "
                               f"(worker {w.wid} killed)", queue, attempts,
                            excluded, kind="deadline")
                        if out is not None:
                            yield out
                    elif not w.proc.is_alive():
                        out = self._lose(
                            w, f"worker {w.wid} crashed "
                               f"(exit {w.proc.exitcode})", queue, attempts,
                            excluded, kind="crash")
                        if out is not None:
                            yield out
                if self._deaths > death_budget:
                    raise RuntimeError(
                        f"process backend lost {self._deaths} workers; "
                        "giving up instead of respawning forever")
        finally:
            # keep the pool warm for the next run(); but if the caller
            # abandoned the generator mid-run (break / error), workers
            # still holding jobs would poison the next call: cull them
            for w in [w for w in self._pool if w.job is not None]:
                self._kill(w)

    # ------------------------------------------------------------------
    def close(self):
        """Shut the pool down: each idle worker acknowledges with its
        launch totals (summed into :attr:`launches`) and exits; one that
        does not within the grace is terminated."""
        asked = []
        for w in list(self._pool):
            try:
                if w.ready and w.job is None and w.proc.is_alive():
                    w.conn.send(None)           # graceful shutdown
                    asked.append(w)
            except (OSError, BrokenPipeError):
                pass
        deadline = time.monotonic() + _SHUTDOWN_S
        for w in asked:
            try:
                if w.conn.poll(max(0.0, deadline - time.monotonic())):
                    msg = w.conn.recv()
                    for k, n in (msg.get("launches") or {}).items():
                        self.launches[k] = self.launches.get(k, 0) + n
            except (EOFError, OSError):
                pass
        for w in list(self._pool):
            w.proc.join(timeout=max(0.0, deadline - time.monotonic()))
            if w.proc.is_alive():
                w.proc.terminate()
                w.proc.join(timeout=2)
            try:
                w.conn.close()
            except OSError:
                pass
        self._pool = []
        if self._init["tmp_dir"] is not None:
            shutil.rmtree(self._init["tmp_dir"], ignore_errors=True)
            self._init["tmp_dir"] = None
