"""ComParX tuner: the paper's end-to-end workflow (Fig. 1), as the
reference's ``src/repro/core/tuner.py``.

Fragmentor -> Combinator (-> DB register) -> Executor per (combination,
knob point) (-> DB record, Continue-mode resumable) -> black-box
validation -> Optimal Plan Generator -> fused Plan whose ``knobs`` are the
joint argmin over the swept GlobalKnobs grid.

The sweep runs the three-stage pipeline of ``repro_torch.core.backends``:
the **Scheduler** groups rows that build the same program, resolves whole
groups from the persistent ``score_cache`` and orders the rest
cheapest-lower-bound-first; the **ScoringBackend** scores the unique
programs: ``thread`` (soft off-main-thread deadline), ``sequential`` (one
worker, no pool), ``process`` (spawned workers with a hard kill-based
timeout and requeue-once-then-fail; the pool stays warm across sweeps
until :meth:`ComParTuner.close`) or ``remote`` (ship jobs to a sweep
scoring server, ``sweep(remote_url=...)``, which resolves them against ITS
shared score cache first); the **Recorder** fans outcomes back out to the
rows and writes them in batches.

Beside it, as in the reference: the kernel autotuner
(``sweep(kernel_space=)``, ``kernels/autotune.py``), the static analyzer
(``static_checks``, ``analysis/``), the calibrated machine model
(``ComParTuner(machine=)``, ``core/machine.py``) and the plan registry
(``ComParTuner(registry=)``, ``serve/registry.py``).

A mesh (a ``DeviceMesh`` or a ``MeshSpec``) applies the providers' rules
to every program, and ``mesh_space`` sweeps topology points as the
reference's second outer axis; a point is materialized by whichever
process scores it, against its own process group.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.backends import (RetryPolicy, Recorder, Scheduler,
                                       drive, env_key, make_backend,
                                       shape_key)
from repro_torch.core.combinator import (DEFAULT_CLAUSE_SPACE, Combination,
                                         GlobalKnobs, SweepSpec,
                                         enumerate_combinations, global_grid,
                                         paper_combination_count, port_space,
                                         row_cid,
                                         swept_knob_fields)
from repro_torch.core.cost_model import H100, CostTerms, combo_lower_bound
from repro_torch.core.db import SweepDB
from repro_torch.core.executor import DryRunExecutor, WallClockExecutor
from repro_torch.core.fusion import best_uniform, fuse_joint
from repro_torch.core.meshspec import (MeshSpec, as_mesh_point,
                                       default_mesh_space, live_mesh)
from repro_torch.core.plan import Plan
from repro_torch.core.providers import all_providers, get_provider
from repro_torch.core.segment import Segment, fragment
from repro_torch.device import resolve_device
from repro_torch.runtime import trace
from repro_torch.runtime.sharding import mesh_axis_sizes

log = logging.getLogger("repro_torch.tuner")

@dataclass
class SweepReport:
    project: str
    n_combinations: int     # realized registered rows (incl. the knob axis)
    n_done: int = 0
    n_failed: int = 0
    n_invalid: int = 0
    n_pruned: int = 0       # rows skipped by the exact lower-bound prune
    n_scored: int = 0       # programs that actually ran and were scored
    n_cached: int = 0       # rows served from the persistent score cache
    n_shared: int = 0       # rows that shared an in-run score
    n_transient: int = 0    # rows failed by deadline/crash (retryable)
    n_static: int = 0       # rows rejected by the static analyzer before
                            # dispatch (static_checks="strict")
    n_inapplicable: int = 0  # (segment, combination) pairs dropped because
                             # the provider is inapplicable to the segment
    n_knob_points: int = 1  # GlobalKnobs points swept (the RTL axis)
    n_mesh_points: int = 1  # mesh/topology points swept (the mesh axis)
    paper_count: int = 0    # the paper's formula, an upper bound
    elapsed_s: float = 0.0
    #: degraded-mode accounting: a sweep that limped home must say so
    n_fallback_local: int = 0       # rows re-scored locally after the
                                    # remote retry budget ran out
    n_transient_retried: int = 0    # extra dispatches spent on transient
                                    # recovery (requeues + retry rounds)
    #: failure-kind histogram over FAILED rows ("deadline", "crash",
    #: "mesh", "unreachable", "server", "deterministic", "transient")
    failure_kinds: Dict[str, int] = field(default_factory=dict)
    #: per-rule histogram over statically diagnosed rows (strict and warn
    #: modes; one count per row per distinct rule): see
    #: repro_torch.analysis for the rule ids
    static_rules: Dict[str, int] = field(default_factory=dict)
    #: the winning knob point's per-segment valid rows
    per_segment: Dict[str, List[Tuple[Combination, CostTerms]]] = \
        field(default_factory=dict)
    #: knobs.key() -> fused predicted total, every fusable knob point
    per_knob_total_s: Dict[str, float] = field(default_factory=dict)
    #: mesh.key() -> fused predicted total, every fusable mesh point
    per_mesh_total_s: Dict[str, float] = field(default_factory=dict)
    #: segment kind -> {"n", "mean", "max"} of bound/measured over done
    #: rows (a ratio > 1 means the certificate broke: audit_soundness)
    bound_tightness: Dict[str, Dict[str, float]] = field(default_factory=dict)
    #: the inner kernel sweep's observability (``sweep(kernel_space=...)``):
    #: variants enumerated/timed/cache-hit/failed, top_k, per-op best
    #: schedule, per-segment kept counts.  None = no kernel axis.
    kernel_tuning: Optional[Dict] = None

    def summary(self) -> str:
        s = (f"project={self.project} knob_points={self.n_knob_points} "
             f"mesh_points={self.n_mesh_points} "
             f"done={self.n_done} failed={self.n_failed} "
             f"invalid={self.n_invalid} pruned={self.n_pruned} "
             f"scored={self.n_scored} cached={self.n_cached} "
             f"shared={self.n_shared} transient={self.n_transient} "
             f"realized={self.n_combinations} "
             f"paper_formula_upper_bound={self.paper_count} "
             f"elapsed={self.elapsed_s:.1f}s")
        if self.n_static or self.static_rules:
            s += f" static={self.n_static}"
            if self.static_rules:
                rules = ",".join(f"{k}:{v}" for k, v in
                                 sorted(self.static_rules.items()))
                s += f"[{rules}]"
        if self.n_inapplicable:
            s += f" inapplicable={self.n_inapplicable}"
        if self.n_transient_retried:
            s += f" transient_retried={self.n_transient_retried}"
        if self.n_fallback_local:
            s += f" fallback_local={self.n_fallback_local}"
        if self.failure_kinds:
            kinds = ",".join(f"{k}:{v}" for k, v in
                             sorted(self.failure_kinds.items()))
            s += f" failure_kinds={kinds}"
        if self.bound_tightness:
            tight = ",".join(
                f"{k}:mean={v['mean']:.2f}/max={v['max']:.2f}(n={v['n']})"
                for k, v in sorted(self.bound_tightness.items()))
            s += f" bound_tightness={tight}"
        if self.kernel_tuning:
            kt = self.kernel_tuning
            s += (f" kernel_tuning=variants:{kt['n_variants']},"
                  f"timed:{kt['n_timed']},cached:{kt['n_cached']},"
                  f"failed:{kt['n_failed']},top_k:{kt['top_k']}")
        return s


@dataclass(frozen=True)
class BackendOptions:
    """``sweep()``'s scoring-backend kwargs as one typed value; a bundle
    plus a non-default bare twin raises."""
    backend: str = "thread"
    workers: int = 1
    remote_url: Optional[str] = None
    remote_token: Optional[str] = None
    fallback: Optional[str] = None
    retry: Optional[object] = None          # backends.RetryPolicy
    transient_retries: Optional[int] = None


@dataclass(frozen=True)
class SearchOptions:
    """``sweep()``'s search-strategy kwargs as one typed value; same
    conflict contract as :class:`BackendOptions`."""
    prune: bool = False
    prune_margin: float = 0.1
    static_checks: str = "warn"
    kernel_space: Optional[object] = None   # "auto" | {field: values}
    kernel_top_k: int = 2
    use_cache: bool = True
    share_scores: bool = True
    record_batch: int = 64


def _unbundle(bundle, bare: Dict[str, Tuple], kind: str) -> List:
    """Explode a kwarg bundle, refusing non-default bare twins."""
    clash = [k for k, (v, d) in bare.items() if v is not d and v != d]
    if clash:
        raise ValueError(
            f"{kind} conflicts with bare kwarg(s) {sorted(clash)}: pass "
            f"the value inside the bundle or drop the bundle")
    return [getattr(bundle, f) for f in bundle.__dataclass_fields__]


class ComParTuner:
    """Sweep (provider x flags x clause) per segment of ``cfg`` at
    ``shape``, score, record, fuse.

    ``executor``: ``"dryrun"`` (flops and bytes on fake tensors, over an
    H100's peak rates; no device) or ``"wallclock"`` (medians measured on
    ``device``, ``"cuda"`` unless the caller asks for ``"cpu"``).

    ``machine``: the dry run's hardware model: ``None`` (the H100 data
    sheet's constants), ``"auto"`` (calibrate ``device`` or load its
    cached profile from the DB's ``machine_cache``), a ``MachineProfile``
    or a ``Hardware``.  The calibrated view's name lands in the
    executor's ``cache_tag``, so calibrated and constant scores never
    share cache rows; bounds divide by the same view, so pruning stays
    exact.  The wall clock measures, so it ignores ``machine`` (logged).

    ``registry``: where the fused plan of every ``sweep()`` is registered
    for the serving side: ``None``/``False`` (off), ``True`` (a
    ``PlanRegistry`` in this tuner's DB), a ``PlanRegistry``, or a DB
    path.
    """

    def __init__(self, cfg: ArchConfig, shape: ShapeConfig, *,
                 device="cuda", db: Optional[SweepDB] = None,
                 project: Optional[str] = None, mode: str = "new",
                 executor: str = "dryrun", validate: bool = False,
                 timeout_s: Optional[float] = 300, mesh=None,
                 machine=None, registry=None):
        self.cfg = cfg
        # a MeshSpec (or its dict shorthand) is taken wherever a live
        # mesh is: materialized here, once, against this process's group
        self.mesh = live_mesh(mesh)
        self.shape = shape
        self.device = resolve_device(device)
        self.db = db or SweepDB(":memory:")
        name = project or f"{cfg.name}-{shape.name}"
        self.project = self.db.open_project(
            name, mode, {"arch": cfg.name, "shape": shape.name})
        if executor == "dryrun":
            hw = H100
            if machine is not None:
                from repro_torch.core.machine import resolve_machine
                hw = resolve_machine(machine, self.db, device=self.device)
            self.executor = DryRunExecutor(hw, timeout_s=timeout_s,
                                           mesh=self.mesh)
        elif executor == "wallclock":
            if machine is not None:
                log.warning("machine= ignored: wallclock scores are "
                            "measured, not modeled")
            self.executor = WallClockExecutor(self.device,
                                              timeout_s=timeout_s,
                                              mesh=self.mesh)
        else:
            raise ValueError(f"executor={executor!r}; expected 'dryrun' or "
                             f"'wallclock'")
        self.registry = None
        if registry is not None and registry is not False:
            from repro_torch.serve.registry import PlanRegistry
            if registry is True:
                self.registry = PlanRegistry(self.db)
            elif hasattr(registry, "register") and hasattr(registry,
                                                           "lookup"):
                # duck-typed, not isinstance: `python -m` runs modules
                # under __main__, which forks the class object
                self.registry = registry
            else:
                self.registry = PlanRegistry(registry)
        self.validate = validate
        #: the latest sweep's kernel-autotuner verdict (None = no kernel
        #: axis): bounds are recomputed with the floors the Scheduler used
        self._kernel_tuning = None
        #: cached ScoringBackends (warm process pools): see _engine()
        self._engines: Dict[Tuple, object] = {}

    # ------------------------------------------------------------------
    @trace.traced("sweep")
    def sweep(self, providers: Optional[Sequence[str]] = None,
              clause_space=None, *,
              spec: Optional[SweepSpec] = None,
              budget: Optional[int] = None,
              knobs: GlobalKnobs = GlobalKnobs(),
              global_space: Optional[Dict[str, Tuple]] = None,
              mesh_space: Optional[Sequence] = None,
              boundary_costs: bool = False,
              max_flags: Optional[int] = None,
              backend="thread",
              search: Optional[SearchOptions] = None,
              workers: int = 1,
              remote_url: Optional[str] = None,
              remote_token: Optional[str] = None,
              fallback: Optional[str] = None,
              retry=None,
              transient_retries: Optional[int] = None,
              kernel_space=None, kernel_top_k: int = 2,
              static_checks: str = "warn",
              prune: bool = False, prune_margin: float = 0.1,
              use_cache: bool = True, share_scores: bool = True,
              record_batch: int = 64) -> Tuple[Plan, SweepReport]:
        """Run the sweep; returns ``(plan, report)``.  The kwargs are the
        reference's:

        ``spec``          a :class:`SweepSpec` carrying the providers and
                          the clause and knob grids as one value
                          (conflicts with the bare kwargs it covers)
        ``search`` / ``backend``  :class:`SearchOptions` /
                          :class:`BackendOptions` bundles of the kwargs
                          below (a bundle plus a non-default twin raises)
        ``global_space``  GlobalKnobs grid swept as the outer axis; the
                          plan's ``knobs`` are the joint argmin.  Default
                          ``None`` = the single point ``knobs``.
        ``boundary_costs``  fuse by Viterbi over boundary costs (all 0
                          meshless: the argmin's plan)
        ``backend``       ``"thread"`` (default) | ``"sequential"`` |
                          ``"process"`` | ``"remote"``; ``workers``
                          threads or spawned processes (1 for the wall
                          clock, whose timings would contend)
        ``remote_url``    sweep scoring server URL (``backends/server.py``);
                          implies ``backend="remote"``
        ``remote_token``  shared-secret bearer token of a ``--token``
                          scoring server
        ``fallback``      local backend name (``thread`` | ``sequential``
                          | ``process``) re-scoring, in the same run, the
                          jobs the remote backend failed transiently;
                          counted in ``SweepReport.n_fallback_local``
        ``retry`` / ``transient_retries``  the unified ``RetryPolicy``
                          (remote budget, process requeues) and in-sweep
                          retry rounds of transient failures
        ``kernel_space``  the hierarchical kernel axis: ``"auto"`` (the
                          built-in tile/variant grid) or a
                          ``{field: values}`` grid over ``kernel``/
                          ``block_q``/``block_k``/``mlstm_chunk``.  The
                          autotuner times every (op, schedule) variant in
                          isolation first (``kernel_cache``-resolved), then
                          the outer cross-product carries only the
                          ``kernel_top_k`` cheapest schedules per segment.
                          Its fields override the same fields of
                          ``clause_space``.  ``None`` = no inner sweep.
        ``kernel_top_k``  surviving schedules per segment (``>= len(grid)``
                          keeps everything)
        ``static_checks`` the static analyzer (``repro_torch.analysis``):
                          ``"warn"`` (default: lint every point, count
                          the rules in ``SweepReport.static_rules``,
                          dispatch everything), ``"strict"`` (also settle
                          error-diagnosed rows as ``"static"`` before they
                          become jobs: every dropped point provably fails)
                          or ``"off"``
        ``prune``         exact lower-bound pruning (dry run only)
        ``use_cache``     the persistent structural score cache
        ``share_scores``  one program per structurally identical group
        ``record_batch``  DB rows per write transaction

        ``mesh_space``    topology points swept as a second outer axis: a
                          list of ``MeshSpec`` | ``None`` (the local point)
                          | ``{"data": 2}`` dicts, or ``"auto"``
                          (``default_mesh_space()``).  Each point has its
                          own rows; the plan's ``mesh`` is chosen by the
                          joint argmin.  ``None`` = the mesh is not swept.
        """
        t0 = time.time()
        if isinstance(backend, BackendOptions):
            (backend, workers, remote_url, remote_token, fallback, retry,
             transient_retries) = _unbundle(
                backend,
                {"workers": (workers, 1), "remote_url": (remote_url, None),
                 "remote_token": (remote_token, None),
                 "fallback": (fallback, None), "retry": (retry, None),
                 "transient_retries": (transient_retries, None)},
                "BackendOptions")
        if search is not None:
            if not isinstance(search, SearchOptions):
                raise ValueError(f"search= takes a SearchOptions, got "
                                 f"{type(search).__name__}")
            (prune, prune_margin, static_checks, kernel_space,
             kernel_top_k, use_cache, share_scores, record_batch) = \
                _unbundle(
                    search,
                    {"prune": (prune, False),
                     "prune_margin": (prune_margin, 0.1),
                     "static_checks": (static_checks, "warn"),
                     "kernel_space": (kernel_space, None),
                     "kernel_top_k": (kernel_top_k, 2),
                     "use_cache": (use_cache, True),
                     "share_scores": (share_scores, True),
                     "record_batch": (record_batch, 64)},
                    "SearchOptions")
        if spec is not None:
            if not isinstance(spec, SweepSpec):
                raise ValueError(f"spec= takes a SweepSpec, got "
                                 f"{type(spec).__name__}")
            clash = [k for k, v in
                     {"providers": providers, "clause_space": clause_space,
                      "global_space": global_space,
                      "kernel_space": kernel_space}.items()
                     if v is not None]
            if clash:
                raise ValueError(
                    f"spec= conflicts with bare kwarg(s) {sorted(clash)}: "
                    f"the SweepSpec already carries those axes")
            providers = list(spec.providers) or None
            clause_space = spec.clauses
            global_space = spec.globals
            mesh_space = list(spec.meshes) if spec.meshes is not None \
                else None
            kernel_space = spec.kernel_space
        if isinstance(mesh_space, str):
            if mesh_space != "auto":
                raise ValueError(f"mesh_space={mesh_space!r}: the only "
                                 f"string value is 'auto'")
            mesh_space = default_mesh_space()
        mesh_swept = mesh_space is not None
        mpoints: Optional[List[MeshSpec]] = None
        if mesh_swept:
            # normalize + dedupe by content: the same topology listed
            # twice would register colliding rows
            mpoints, seen = [], set()
            for m in mesh_space:
                mp = as_mesh_point(m)
                if mp.mid not in seen:
                    seen.add(mp.mid)
                    mpoints.append(mp)
            if not mpoints:
                raise ValueError("mesh_space is empty")
            if self.mesh is not None:
                log.info("mesh_space sweeps its own points; the fixed "
                         "constructor mesh is not implicitly included")
        if remote_url is not None:
            backend = "remote"
        if backend == "remote" and not remote_url:
            raise ValueError("backend='remote' needs remote_url "
                             "(the sweep scoring server URL)")
        if fallback is not None and backend != "remote":
            raise ValueError("fallback= is the remote backend's degraded "
                             "mode; it needs remote_url/backend='remote'")
        if workers > 1 and not self.executor.parallel_safe:
            log.warning("workers=%d -> 1: %s timings would contend on the "
                        "device", workers, type(self.executor).__name__)
            workers = 1
        if prune and not hasattr(self.executor, "hw"):
            # the bound is in the hardware model's units; against measured
            # seconds the certificate (bound <= score) does not hold
            log.warning("prune disabled: %s has no hardware model",
                        type(self.executor).__name__)
            prune = False
        points = global_grid(global_space) if global_space is not None \
            else [knobs]
        providers = list(providers or all_providers())
        segs = fragment(self.cfg)

        # the hierarchical kernel axis: the inner (op, schedule) sweep
        # first, then the OUTER space over the merged grid, each segment
        # filtered to its top-k surviving schedules.  Filtering keeps the
        # enumeration order, so kernel_top_k >= len(grid) registers rows
        # as an exhaustive clause sweep would.
        tuning = None
        space = clause_space
        if kernel_space is not None:
            from repro_torch.kernels.autotune import (DEFAULT_KERNEL_SPACE,
                                                      tune_segments)
            if isinstance(kernel_space, str):
                if kernel_space != "auto":
                    raise ValueError(f"kernel_space={kernel_space!r}: the "
                                     f"only string value is 'auto'")
                kernel_space = DEFAULT_KERNEL_SPACE
            space = dict(clause_space or DEFAULT_CLAUSE_SPACE)
            space.update({k: tuple(v) for k, v in kernel_space.items()})
            space = port_space(space)
            tuning = tune_segments(self.db, self.cfg, self.shape, segs,
                                   space, self.executor,
                                   top_k=kernel_top_k, use_cache=use_cache)
        self._kernel_tuning = tuning

        combos = enumerate_combinations(providers, space,
                                        budget=budget, max_flags=max_flags)
        rep = SweepReport(
            self.project, n_combinations=0, n_knob_points=len(points),
            n_mesh_points=len(mpoints) if mesh_swept else 1,
            paper_count=paper_combination_count(
                [len(get_provider(p).flags) for p in providers],
                n_rtl=len(swept_knob_fields(global_space)),
                n_d=len(space or {}) or 6))
        if tuning is not None:
            rep.kernel_tuning = tuning.report

        # Combinator: register every (segment, combination, knob point) in
        # one transaction; inapplicable (provider, segment) pairs are
        # counted, not silently dropped
        per_seg_combos: Dict[str, List[Combination]] = {}
        for seg in segs:
            kept: List[Combination] = []
            for c in combos:
                if not get_provider(c.provider).applicable(self.cfg, seg):
                    rep.n_inapplicable += 1
                    continue
                if tuning is not None and not tuning.keeps(seg.name,
                                                           c.clause):
                    continue
                kept.append(c)
            per_seg_combos[seg.name] = kept
        reg = [(seg.name, c, kn, mp)
               for mp in (mpoints if mesh_swept else [None])
               for kn in points for seg in segs
               for c in per_seg_combos[seg.name]]
        rep.n_combinations = len(reg)
        self.db.register_many(self.project, reg)

        self._execute(segs, per_seg_combos, points, rep, backend=backend,
                      mesh_points=mpoints,
                      boundary_slack=prune and boundary_costs,
                      kernel_tuning=tuning, static_checks=static_checks,
                      workers=workers, remote_url=remote_url,
                      remote_token=remote_token, fallback=fallback,
                      retry=retry,
                      transient_retries=transient_retries, prune=prune,
                      prune_margin=prune_margin, use_cache=use_cache,
                      share_scores=share_scores, record_batch=record_batch)

        # collect valid results per (mesh point, knob point, segment)
        by_rid = {(r["segment"], r["cid"]): r
                  for r in self.db.results(self.project)}

        def knob_table(mp):
            per_knob: Dict[str, Dict[str, List[Tuple[Combination,
                                                     CostTerms]]]] = {}
            for kn in points:
                table = per_knob.setdefault(kn.kid, {})
                for seg in segs:
                    good = table.setdefault(seg.name, [])
                    for c in per_seg_combos[seg.name]:
                        r = by_rid.get((seg.name, row_cid(c, kn, mp)))
                        if r is not None and r["status"] == "done" \
                                and r["cost"]:
                            good.append((c, CostTerms.from_dict(r["cost"])))
            return per_knob

        counts = self.db.done_count(self.project)
        rep.n_done = counts.get("done", 0)
        rep.n_failed = counts.get("failed", 0)
        rep.n_invalid = counts.get("invalid", 0)
        rep.n_pruned = counts.get("pruned", 0)
        rep.n_static = counts.get("static", 0)
        rep.bound_tightness, violations = self._bound_tightness()
        if violations and hasattr(self.executor, "hw"):
            log.warning("bound soundness violated on %d done row(s): %s",
                        len(violations), violations[:3])

        if mesh_swept:
            per_mesh = {mp.mid: knob_table(mp) for mp in mpoints}
            plan = fuse_joint(self.cfg, self.shape, None, per_mesh, points,
                              boundary_costs=boundary_costs,
                              mesh_points=mpoints)
            rep.per_segment = per_mesh[plan.mesh.mid][plan.knobs.kid]
            rep.per_mesh_total_s = dict(plan.meta["per_mesh_total_s"])
        else:
            per_knob = knob_table(None)
            plan = fuse_joint(self.cfg, self.shape, self.mesh, per_knob,
                              points, boundary_costs=boundary_costs)
            rep.per_segment = per_knob[plan.knobs.kid]
        plan.meta["project"] = self.project
        rep.per_knob_total_s = dict(plan.meta["per_knob_total_s"])
        rep.elapsed_s = time.time() - t0
        if self.registry is not None:
            # plans are keyed by what they were tuned for: the chosen mesh
            # when the mesh was swept, the fixed one else
            self.registry.register(
                self.cfg, self.shape, plan, report=rep,
                mesh=plan.mesh if plan.mesh is not None else self.mesh,
                cache_tag=self.executor.cache_tag)
        log.info(rep.summary())
        return plan, rep

    # ------------------------------------------------------------------
    def _bound_tightness(self):
        """Recompute ``combo_lower_bound`` for every ``done`` row of this
        project against its recorded score: a per-segment-kind ``{"n",
        "mean", "max"}`` table of bound/measured and the rows where the
        bound exceeded the score (which the certificate says are none)."""
        hw = getattr(self.executor, "hw", H100)
        fixed_chips = getattr(self.executor, "n_chips", 1)
        fixed_axes = mesh_axis_sizes(self.mesh) or None
        segs = {s.name: s for s in fragment(self.cfg)}
        stats: Dict[str, Dict[str, float]] = {}
        violations = []
        for r in self.db.results(self.project):
            if r["status"] != "done" or not r["cost"]:
                continue
            seg = segs.get(r["segment"])
            if seg is None:
                continue
            # rows of a sweep without the kernel axis (same project) project
            # to unmeasured schedules -> floor 0.0
            kflops = self._kernel_tuning.floor_flops(
                r["segment"], r["combo"].clause) \
                if self._kernel_tuning is not None else 0.0
            mesh = r["mesh"]
            bound = combo_lower_bound(
                self.cfg, self.shape, seg, r["combo"],
                mesh.n_devices if mesh is not None else fixed_chips, hw,
                knobs=r["knobs"],
                mesh_axes=mesh.axis_sizes() if mesh is not None
                else fixed_axes, kernel_flops=kflops)
            total = CostTerms.from_dict(r["cost"]).total_s
            if total <= 0.0:
                continue
            ratio = bound / total
            st = stats.setdefault(seg.kind, {"n": 0, "sum": 0.0, "max": 0.0})
            st["n"] += 1
            st["sum"] += ratio
            st["max"] = max(st["max"], ratio)
            if bound > total * (1.0 + 1e-9):
                violations.append((r["segment"], r["cid"], bound, total))
        table = {k: {"n": int(v["n"]), "mean": v["sum"] / v["n"],
                     "max": v["max"]} for k, v in stats.items() if v["n"]}
        return table, violations

    def audit_soundness(self) -> Dict[str, Dict[str, float]]:
        """Assert ``combo_lower_bound <= score`` on every ``done`` row of
        this project; returns the per-kind tightness table.

        With the dry run this checks the pruning certificate (bound and
        score share ``executor.hw``).  Wall-clock scores are seconds on a
        real card, not the model's units, so there only the table is
        returned."""
        table, violations = self._bound_tightness()
        if violations and hasattr(self.executor, "hw"):
            lines = "; ".join(
                f"{seg}/{cid}: bound={b:.3e} > measured={t:.3e}"
                for seg, cid, b, t in violations[:10])
            raise AssertionError(
                f"combo_lower_bound overshoots {len(violations)} done "
                f"row(s) — pruning certificate broken: {lines}")
        return table

    # ------------------------------------------------------------------
    def _execute(self, segs: Sequence[Segment],
                 per_seg_combos: Dict[str, List[Combination]],
                 knob_points: Sequence[GlobalKnobs],
                 rep: SweepReport, *, backend: str, workers: int,
                 mesh_points: Optional[Sequence[MeshSpec]] = None,
                 boundary_slack: bool = False,
                 kernel_tuning=None, static_checks: str = "off",
                 remote_url: Optional[str], remote_token: Optional[str],
                 fallback: Optional[str], retry,
                 transient_retries: Optional[int], prune: bool,
                 prune_margin: float, use_cache: bool,
                 share_scores: bool, record_batch: int):
        """Score everything not already settled (Continue mode):
        Scheduler -> ScoringBackend -> Recorder, with bounded transient
        retry rounds (``scheduler.drive``)."""
        # ONE key pair for the whole pipeline: the Recorder writes cache
        # entries under the keys the Scheduler reads
        # a swept mesh point overrides mk per job (JobSpec.mesh_key)
        sk, mk = shape_key(self.shape), env_key(self.mesh, self.executor)
        scheduler = Scheduler(
            self.db, self.project, self.cfg, self.shape, self.mesh,
            self.executor, validate=self.validate,
            share_scores=share_scores, use_cache=use_cache,
            shape_key=sk, mesh_key=mk, boundary_slack=boundary_slack,
            kernel_tuning=kernel_tuning, static_checks=static_checks,
            # the mesh rule asks THIS process: valid for every backend
            # but the remote one
            static_devices=backend != "remote")
        recorder = Recorder(
            self.db, self.project, rep, shape_key=sk, mesh_key=mk,
            use_cache=use_cache, batch=record_batch)
        work = scheduler.build(segs, per_seg_combos, recorder,
                               knob_points=knob_points,
                               mesh_points=mesh_points)
        engine, transient_engine = self._engine(
            backend, workers=workers, remote_url=remote_url,
            remote_token=remote_token, fallback=fallback, retry=retry,
            prune=prune, prune_margin=prune_margin, use_cache=use_cache,
            shape_key=sk, mesh_key=mk)
        policy = retry if retry is not None else RetryPolicy()
        rounds = policy.sweep_retries if transient_retries is None \
            else transient_retries
        try:
            drive(engine, work, recorder, transient_retries=rounds)
        finally:
            # flush BEFORE closing: results already scored must land in
            # the DB even if the engine's teardown throws, and a failing
            # close must never eat the recorder flush (or vice versa)
            try:
                recorder.flush()
            finally:
                if transient_engine:
                    engine.close()

    # ------------------------------------------------------------------
    def _engine(self, backend: str, *, workers: int,
                remote_url: Optional[str], remote_token: Optional[str],
                fallback: Optional[str], retry, prune: bool,
                prune_margin: float, use_cache: bool,
                shape_key: str, mesh_key: str):
        """Build a ScoringBackend; cache process backends for warm-worker
        reuse.

        A process pool pays a torch import and a CUDA context per spawned
        worker, so it is kept alive across ``sweep()`` calls on one tuner
        (same engine parameters) and only torn down by :meth:`close`.
        Thread/sequential/remote backends hold no local resources (the
        remote backend's warm pool lives server-side) and are built per
        sweep.  Returns ``(engine, transient)``; transient engines are
        closed by the caller after the run.  A cached engine that survived
        an aborted sweep culls its dead workers on reuse
        (``ProcessBackend.run``)."""
        kw = dict(
            workers=workers, prune=prune, prune_margin=prune_margin,
            timeout_s=getattr(self.executor, "timeout_s", None),
            # workers get a read-only cache view only when the cache is
            # on: use_cache=False must force real runs everywhere
            db_path=self.db.path if use_cache else None,
            shape_key=shape_key, mesh_key=mesh_key, remote_url=remote_url,
            token=remote_token, retry=retry, fallback=fallback)
        if backend != "process":
            return make_backend(backend, self.executor, self.cfg,
                                self.shape, **kw), True
        key = (backend,) + tuple(sorted(kw.items()))
        engine = self._engines.get(key)
        if engine is None:
            engine = make_backend(backend, self.executor, self.cfg,
                                  self.shape, **kw)
            self._engines[key] = engine
        return engine, False

    def close(self):
        """Release cached scoring backends (warm process-worker pools).
        Idempotent and exception-safe: one backend's failing teardown
        never leaks the others' worker pools.  Also runs on GC and via
        the context-manager exit."""
        engines, self._engines = self._engines, {}
        first_err = None
        for engine in engines.values():
            try:
                engine.close()
            except Exception as e:           # keep releasing the rest
                log.warning("engine close failed: %s", e)
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err

    def __enter__(self) -> "ComParTuner":
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # ------------------------------------------------------------------
    def baselines(self, knobs: GlobalKnobs = GlobalKnobs(), *,
                  global_space: Optional[Dict[str, Tuple]] = None):
        """Per-provider best uniform plans (the numbers behind the paper's
        Fig. 2/4 analogues): provider -> predicted total.  With
        ``global_space`` each provider's best is over any swept knob
        point, the fair comparison against a joint-argmin fused plan."""
        points = global_grid(global_space) if global_space is not None \
            else [knobs]
        kids = {kn.kid: kn for kn in points}
        segs = fragment(self.cfg)
        # (mesh mid or "", knob kid) -> segment -> rows: a uniform plan
        # lives on one topology
        by_gid: Dict[Tuple[str, str],
                     Dict[str, List[Tuple[Combination, CostTerms]]]] = {}
        for r in self.db.results(self.project):
            if r["status"] != "done" or not r["cost"]:
                continue
            gid = (r["mesh"].mid if r["mesh"] is not None else "",
                   (r["knobs"] or GlobalKnobs()).kid)
            by_gid.setdefault(gid, {}).setdefault(r["segment"], []).append(
                (r["combo"], CostTerms.from_dict(r["cost"])))
        out = {}
        for pname in all_providers():
            best = None
            for (_, kid), rows in by_gid.items():
                kn = kids.get(kid)
                if kn is None:
                    continue
                per_seg = {s.name: [(c, t) for c, t in rows.get(s.name, [])
                                    if c.provider == pname] for s in segs}
                if not all(per_seg.values()):
                    continue
                try:
                    _, total = best_uniform(self.cfg, per_seg, kn)
                except ValueError:
                    continue
                if best is None or total < best:
                    best = total
            if best is not None:
                out[pname] = best
        return out
