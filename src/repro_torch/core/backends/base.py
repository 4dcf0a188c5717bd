"""Scoring-backend types and shared machinery, as the reference's
``src/repro/core/backends/base.py``.

The sweep pipeline is three composable stages:

    Scheduler  ->  ScoringBackend  ->  Recorder

The Scheduler turns registered (segment, combination) rows into unique
:class:`JobSpec` programs; a ScoringBackend scores them and yields one
:class:`JobOutcome` per job; the Recorder fans outcomes back out to
member rows and writes them in batched transactions.

``JobSpec`` / ``JobOutcome`` are the reference's *serializable* wire
format: pure-JSON ``to_json``/``from_json`` on both, arch and shape
rebuilt from the config registry by name (``repro_torch.configs.registry.
arch_from_spec``), the executor by :func:`executor_from_spec`.  The process
workers (``process.py``) and the scoring server (``server.py``) speak it.
A job's ``mesh`` is a :class:`~repro_torch.core.meshspec.MeshSpec` (the
swept point) that whichever process scores the job materializes for
itself; an executor spec carries its fixed mesh the same way.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional, Sequence, Tuple

from repro_torch.core.meshspec import MeshSpec
from repro_torch.core.combinator import Combination, GlobalKnobs
from repro_torch.core.segment import Segment

#: version of the JSON wire format: JobSpec/JobOutcome payloads, the
#: process-worker init message and the scoring server's HTTP envelope all
#: carry it.  The reference's v3 (failure ``kind`` and ``fallback`` on
#: JobOutcome); a server rejects payloads of another version rather than
#: score and cache a misdecoded spec under the wrong key.
WIRE_VERSION = 3


class WireVersionError(ValueError):
    """A wire payload was produced by an incompatible format version."""


class DeviceUnsatisfiable(ValueError):
    """A wall-clock executor spec names a device this host does not have:
    the port's counterpart of the reference's ``MeshUnsatisfiable``.  The
    scoring server answers HTTP 400 at submit; such a spec is never scored
    on another device."""


def check_wire_version(payload: Dict):
    """Validate an envelope's ``v`` field against :data:`WIRE_VERSION`."""
    v = payload.get("v")
    if v != WIRE_VERSION:
        raise WireVersionError(
            f"wire format version mismatch: payload has v={v!r}, "
            f"this end speaks v={WIRE_VERSION}")


#: structured outcome taxonomy (replaces string-matched statuses)
DONE = "done"          # compiled + analyzed; cost attached
FAILED = "failed"      # could not be scored; ``transient`` says whether
                       # the failure is deterministic (cacheable) or a
                       # deadline/crash (retryable, never cached)
PRUNED = "pruned"      # skipped by the exact lower-bound prune
STATUSES = (DONE, FAILED, PRUNED)


@dataclass
class JobSpec:
    """One *unique* program to score (the process/remote wire format).

    ``knobs`` is the GlobalKnobs point the program is built under (None
    = score without knob effects, the pre-knob behavior for hand-built
    jobs).  ``segments`` lists the incumbent *scopes* whose rows share
    this program — Scheduler-built jobs use ``"<knob kid>/<segment>"``
    keys (``"<mesh mid>/<knob kid>/<segment>"`` when the mesh is swept)
    so pruning compares against the right point's incumbents;
    the tracker treats them as opaque strings.  ``signature``/``eff_cid``
    are the group's persistent-cache key components, shipped so a worker
    can consult the shared score cache itself.

    ``slack_s`` is the boundary-cost pruning allowance: when fusion
    charges layout-transition costs (``boundary_costs=True``), a
    combination may lose the per-segment comparison yet still win the
    Viterbi chain by avoiding reshards, so the exact prune condition
    loosens to ``bound > incumbent * (1 + margin) + slack_s`` where
    ``slack_s`` is (n_segments - 1) times the largest possible single
    boundary cost (``fusion.max_boundary_cost_s``) — the most any
    chain total can sit above the sum of its per-segment minima.
    ``0.0`` (the default, and the value under per-segment-argmin
    fusion) restores the strict check.  Wire-tolerant: absent on old
    payloads -> 0.0, which only prunes *less*, never wrongly.

    ``mesh`` is the swept topology point the program is built under, a
    :class:`~repro_torch.core.meshspec.MeshSpec` that the scoring process
    materializes (``meshspec.cached_mesh``); ``None`` = the executor's own
    fixed mesh.  ``mesh_key`` is the score-cache environment column of
    the job's point (``""`` = the init message's), shipped, not
    re-derived.  The field layout is the runner's ``SweepJob``, so the
    thread backend feeds specs straight into ``ParallelSweepRunner``.
    """
    key: str
    seg: Segment
    combo: Combination
    segments: Tuple[str, ...] = ()
    bound_s: float = 0.0
    signature: str = ""
    eff_cid: str = ""
    knobs: Optional[GlobalKnobs] = None
    mesh: Optional[MeshSpec] = None
    mesh_key: str = ""
    slack_s: float = 0.0

    def to_json(self) -> Dict:
        return {"key": self.key, "seg": self.seg.to_json(),
                "combo": self.combo.to_json(),
                "segments": list(self.segments), "bound_s": self.bound_s,
                "signature": self.signature, "eff_cid": self.eff_cid,
                "knobs": self.knobs.to_json()
                if self.knobs is not None else None,
                "mesh": self.mesh.to_json()
                if self.mesh is not None else None,
                "mesh_key": self.mesh_key, "slack_s": self.slack_s}

    @classmethod
    def from_json(cls, d: Dict) -> "JobSpec":
        return cls(d["key"], Segment.from_json(d["seg"]),
                   Combination.from_json(d["combo"]),
                   tuple(d.get("segments") or ()),
                   float(d.get("bound_s", 0.0)),
                   d.get("signature", ""), d.get("eff_cid", ""),
                   GlobalKnobs.from_json(d["knobs"])
                   if d.get("knobs") else None,
                   MeshSpec.from_json(d["mesh"])
                   if d.get("mesh") else None,
                   d.get("mesh_key", ""),
                   float(d.get("slack_s", 0.0)))


@dataclass
class JobOutcome:
    """The result of scoring one JobSpec.

    ``transient`` marks deadline overruns and worker crashes: outcomes
    that depend on machine load, the time budget, or worker health — a
    retry with a bigger budget must be possible, so transient failures
    are never cached.  ``cached`` marks outcomes a worker served from the
    persistent score cache (no compile happened).  ``attempts`` counts
    dispatches, >1 after a requeue.

    ``kind`` buckets failures for the SweepReport's per-kind counts:
    "deadline" (budget overrun), "crash" (worker died twice holding the
    job), "mesh" (this host can't satisfy the swept mesh point),
    "unreachable" (remote server gone past the retry budget), "server"
    (remote server failed the batch).  ``""`` on success or when the
    producing backend predates the taxonomy — the Recorder then falls
    back to "transient"/"deterministic".  ``fallback`` marks outcomes
    re-scored by a local backend after the remote budget ran out.
    """
    key: str
    status: str                      # DONE | FAILED | PRUNED
    cost: Optional[Dict] = None      # CostTerms.as_dict()
    error: str = ""
    transient: bool = False
    cached: bool = False
    attempts: int = 1
    kind: str = ""
    fallback: bool = False

    def to_json(self) -> Dict:
        return {"key": self.key, "status": self.status, "cost": self.cost,
                "error": self.error, "transient": self.transient,
                "cached": self.cached, "attempts": self.attempts,
                "kind": self.kind, "fallback": self.fallback}

    @classmethod
    def from_json(cls, d: Dict) -> "JobOutcome":
        return cls(d["key"], d["status"], d.get("cost"),
                   d.get("error", ""), bool(d.get("transient", False)),
                   bool(d.get("cached", False)), int(d.get("attempts", 1)),
                   d.get("kind", ""), bool(d.get("fallback", False)))


@dataclass
class JobGroup:
    """All pending (segment, row-cid) rows that share one program.

    ``knobs`` is the representative knob point the program is built
    under (any member's point projects to the same program, by the
    effective-cid grouping).  ``scopes`` are the ``"<knob kid>/<segment>"``
    incumbent keys of every member — the per-knob-point pruning scope
    (mesh-qualified when the mesh is swept).  ``mesh`` is the swept mesh
    point (``None`` = unswept, the executor's fixed mesh) and
    ``mesh_key`` its score-cache environment column (``""`` = the
    pipeline default) — the Recorder banks this group's score under it.
    """
    seg: Segment
    combo: Combination
    signature: str
    eff_cid: str
    members: list = field(default_factory=list)   # [(segment, row_cid), ...]
    knobs: Optional[GlobalKnobs] = None
    scopes: set = field(default_factory=set)
    mesh: Optional[MeshSpec] = None
    mesh_key: str = ""


@dataclass(frozen=True)
class RetryPolicy:
    """One retry contract shared across the pipeline's recovery layers.

    * remote ``_request``: retry transport/5xx failures for up to
      ``budget_s`` seconds, pausing ``pause_s(attempt)`` between tries —
      exponential from ``base_s`` capped at ``cap_s``, with up to
      ``jitter`` (a fraction of the pause) shaved off at random so N
      clients recovering from one server restart don't re-poll in
      lockstep.
    * process requeue: a job whose worker dies is re-dispatched until it
      has been attempted ``max_attempts`` times.
    * scheduler: transient FAILED outcomes are re-dispatched for
      ``sweep_retries`` extra rounds before the sweep concludes.

    Frozen (hashable): tuner engine caching keys process pools by their
    kwargs, and this rides along.
    """
    budget_s: float = 30.0       # per-request wall-clock retry budget
    base_s: float = 0.25         # first backoff pause
    cap_s: float = 2.0           # backoff pause ceiling
    jitter: float = 0.5          # fraction of the pause randomly shaved
    max_attempts: int = 2        # process-backend dispatches per job
    sweep_retries: int = 1       # scheduler-level transient retry rounds

    def pause_s(self, attempt: int, rng=None) -> float:
        """Backoff pause before retry ``attempt`` (0-based), jittered."""
        import random as _random
        p = min(self.cap_s, self.base_s * (2.0 ** attempt))
        if not self.jitter:
            return p
        r = (rng if rng is not None else _random).random()
        return p * (1.0 - self.jitter * r)


class IncumbentTracker:
    """Thread-safe per-scope incumbent bests + the exact prune check.

    A job is pruned only when its analytic lower bound exceeds the
    incumbent best of *every* member scope by ``prune_margin`` — since
    bound <= true score, a pruned job can never be any scope's argmin.
    Scope keys are opaque strings; Scheduler-built jobs use
    ``"<knob kid>/<segment>"`` so an incumbent from one knob point never
    prunes another point's rows (each knob point needs its own
    per-segment argmin for the joint solve to stay exact).

    ``job.slack_s`` (boundary-cost fusion) is added on the incumbent
    side of the check: if the pruned combination's bound still exceeds
    every scope's best plus the largest possible total boundary-cost
    divergence of a chain, no Viterbi path through it can beat the
    chain built from the per-segment bests — so the joint argmin is
    unchanged.  Proof sketch: any chain through combo c on segment s
    costs >= bound(c) + sum of the other segments' true minima; the
    optimal chain costs <= sum of all per-segment minima +
    (n_segments - 1) * max_boundary_cost.
    """

    def __init__(self, prune: bool = False, prune_margin: float = 0.1):
        self.prune = prune
        self.prune_margin = prune_margin
        self._lock = threading.Lock()
        self._best: Dict[str, float] = {}

    def seed(self, incumbents: Optional[Dict[str, float]]):
        if not incumbents:
            return
        with self._lock:
            for s, v in incumbents.items():
                cur = self._best.get(s)
                if cur is None or v < cur:
                    self._best[s] = v

    def observe(self, segments: Sequence[str], total_s: float):
        with self._lock:
            for s in segments:
                cur = self._best.get(s)
                if cur is None or total_s < cur:
                    self._best[s] = total_s

    def pruned(self, job: JobSpec) -> bool:
        if not self.prune or job.bound_s <= 0.0 or not job.segments:
            return False
        with self._lock:
            return all(
                s in self._best and
                job.bound_s > (self._best[s] * (1.0 + self.prune_margin)
                               + job.slack_s)
                for s in job.segments)


class ScoringBackend:
    """Interface: score JobSpecs, yield JobOutcomes as they complete."""

    name = "?"

    def run(self, jobs: Sequence[JobSpec],
            incumbents: Optional[Dict[str, float]] = None
            ) -> Iterator[JobOutcome]:
        raise NotImplementedError

    def close(self):
        """Release workers/resources; idempotent."""


def executor_to_spec(executor) -> Dict:
    """Serialize an executor for reconstruction in the scoring process.

    The dry run carries its whole ``Hardware`` (a calibrated view from
    ``hardware_from_profile`` included): ``cache_tag`` embeds its name, so
    a worker must score with the parent's model.  The wall clock carries
    its device.  A fixed mesh travels as its MeshSpec's JSON; device
    handles never cross the wire."""
    import dataclasses

    from repro_torch.core.executor import (CrashExecutor, DryRunExecutor,
                                           SleepExecutor, WallClockExecutor)
    mesh = getattr(executor, "mesh", None)
    mesh_spec = MeshSpec.from_mesh(mesh).to_json() if mesh is not None \
        else None
    if isinstance(executor, DryRunExecutor):
        return {"kind": "dryrun", "timeout_s": executor.timeout_s,
                "hw": dataclasses.asdict(executor.hw), "mesh": mesh_spec}
    if isinstance(executor, WallClockExecutor):
        return {"kind": "wallclock", "timeout_s": executor.timeout_s,
                "repeats": executor.repeats,
                "device": str(executor.device), "mesh": mesh_spec}
    if isinstance(executor, SleepExecutor):
        return {"kind": "sleep", "sleep_s": executor.sleep_s,
                "timeout_s": executor.timeout_s, "device": executor.device,
                "log": executor.log}
    if isinstance(executor, CrashExecutor):
        return {"kind": "crash", "timeout_s": executor.timeout_s}
    raise TypeError(f"no wire spec for executor {type(executor).__name__} "
                    f"(process backend supports dryrun/wallclock)")


def executor_from_spec(spec: Dict, *, allow_test: bool = False):
    """Rebuild an executor in the scoring process.

    A fixed mesh is materialized here (``MeshUnsatisfiable`` if this
    process cannot).  A wall-clock spec whose device this host lacks
    raises :class:`DeviceUnsatisfiable`; the server answers both with HTTP
    400: such a spec is never scored elsewhere.

    ``allow_test`` admits the fault-injection executors (sleep/crash).
    Local process workers pass True: they trust their parent.  The scoring
    server deserializing *client* specs keeps the default: ``{"kind":
    "crash"}`` from a client would otherwise kill every worker."""
    from repro_torch.core.cost_model import H100, Hardware
    from repro_torch.core.meshspec import cached_mesh
    from repro_torch.core.executor import (CrashExecutor, DryRunExecutor,
                                           SleepExecutor, WallClockExecutor)
    kind = spec["kind"]
    mesh = cached_mesh(MeshSpec.from_json(spec["mesh"])) \
        if spec.get("mesh") else None
    if kind == "dryrun":
        hw = Hardware(**spec["hw"]) if spec.get("hw") else H100
        return DryRunExecutor(hw, timeout_s=spec.get("timeout_s"), mesh=mesh)
    if kind == "wallclock":
        try:
            return WallClockExecutor(spec.get("device", "cuda"),
                                     repeats=spec.get("repeats", 5),
                                     timeout_s=spec.get("timeout_s"),
                                     mesh=mesh)
        except RuntimeError as e:          # resolve_device: no such device
            raise DeviceUnsatisfiable(str(e)) from None
    if allow_test and kind == "sleep":
        return SleepExecutor(sleep_s=spec.get("sleep_s", 3600.0),
                             timeout_s=spec.get("timeout_s"),
                             device=spec.get("device"), log=spec.get("log"))
    if allow_test and kind == "crash":
        return CrashExecutor(timeout_s=spec.get("timeout_s"))
    raise ValueError(f"unknown executor kind {kind!r}")
