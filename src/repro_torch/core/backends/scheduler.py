"""Scheduler: registered rows -> ordered unique JobSpecs, as the
reference's ``src/repro/core/backends/scheduler.py``.

The stage of the sweep pipeline that runs before any scoring: structural
grouping (rows that build the same program share one job), black-box
validation, persistent score-cache resolution (whole groups settled
without running anything), and lower-bound ordering (cheapest analytic
bound first, so incumbents tighten early and pruning bites sooner).  With a
static analyzer mode it lints every row first (``repro_torch.analysis``),
and with the kernel autotuner's verdict each job's bound takes the
certified kernel flops of its schedule.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.backends.base import FAILED, JobGroup, JobSpec
from repro_torch.core.backends.recorder import Recorder
from repro_torch.core.combinator import (Combination, GlobalKnobs,
                                         effective_cid, mapping_key,
                                         row_cid)
from repro_torch.core.cost_model import H100, CostTerms, combo_lower_bound
from repro_torch.core.db import SweepDB
from repro_torch.core.fusion import max_boundary_cost_s
from repro_torch.core.meshspec import MeshSpec
from repro_torch.runtime.sharding import mesh_axis_sizes
from repro_torch.core.segment import Segment
from repro_torch.core.validator import validate_combination

#: statuses that Continue mode treats as settled (no re-run on resume)
SETTLED = ("done", "failed", "invalid", "pruned", "static")


def shape_key(shape: ShapeConfig) -> str:
    return f"{shape.kind}:{shape.seq_len}x{shape.global_batch}"


def mesh_key(mesh) -> str:
    """Mesh content key of the ``score_cache.mesh`` column: the
    versioned :attr:`MeshSpec.mid` (``"local"`` for no mesh).  A live
    DeviceMesh and a MeshSpec of the same content give the same key, so
    fixed-mesh and mesh-axis sweeps share cache rows."""
    if mesh is None:
        return "local"
    spec = mesh if isinstance(mesh, MeshSpec) else MeshSpec.from_mesh(mesh)
    return spec.mid


def env_key(mesh, executor) -> str:
    """The score-cache environment key: mesh content + the executor's
    ``cache_tag``, so scores of another executor or card never mix."""
    return f"{mesh_key(mesh)}/{getattr(executor, 'cache_tag', 'unknown')}"


# aliases usable where Scheduler's parameter names shadow the functions
_shape_key_fn = shape_key
_env_key_fn = env_key


@dataclass
class SweepWork:
    """What the Scheduler hands the backend: ordered unique jobs, the
    groups to fan outcomes back out to, and seeded incumbents."""
    jobs: List[JobSpec] = field(default_factory=list)
    groups: Dict[str, JobGroup] = field(default_factory=dict)
    incumbents: Dict[str, float] = field(default_factory=dict)
    shape_key: str = ""
    mesh_key: str = ""


class Scheduler:
    def __init__(self, db: SweepDB, project: str, cfg: ArchConfig,
                 shape: ShapeConfig, mesh, executor, *,
                 validate: bool = False, share_scores: bool = True,
                 use_cache: bool = True,
                 shape_key: Optional[str] = None,
                 mesh_key: Optional[str] = None,
                 boundary_slack: bool = False,
                 kernel_tuning=None,
                 static_checks: str = "off",
                 static_devices: bool = False):
        self.db = db
        self.project = project
        self.cfg = cfg
        self.shape = shape
        self.mesh = mesh
        self.executor = executor
        self.validate = validate
        self.share_scores = share_scores
        self.use_cache = use_cache
        # boundary-cost fusion is active: jobs carry the Viterbi pruning
        # allowance (JobSpec.slack_s) so pruning stays exact under it
        self.boundary_slack = boundary_slack
        # the kernel autotuner's verdict (autotune.KernelTuning): per-
        # schedule certified kernel flops tighten each job's compute
        # floor; None = no kernel axis, bounds unchanged
        self.kernel_tuning = kernel_tuning
        # static lint mode: "off" (hand-built Schedulers: no lint at
        # all), "warn" (lint + histogram, every point still dispatched),
        # "strict" (error-diagnosed rows settled as "static" before they
        # become JobSpecs: every dropped point provably fails)
        if static_checks not in ("strict", "warn", "off"):
            raise ValueError(f"static_checks={static_checks!r}: expected "
                             f"'strict' | 'warn' | 'off'")
        self.static_checks = static_checks
        # whether the mesh-satisfiability rule applies: only when the
        # linting process is the scoring one (not behind a remote server)
        self.static_devices = static_devices
        # the cache keys the pipeline reads AND writes under — a caller
        # (the tuner) passes one pair so write and read can't desync
        self.shape_key = shape_key if shape_key is not None \
            else _shape_key_fn(shape)
        self.mesh_key = mesh_key if mesh_key is not None \
            else _env_key_fn(mesh, executor)

    def build(self, segs: Sequence[Segment],
              per_seg_combos: Dict[str, List[Combination]],
              recorder: Recorder,
              knob_points: Optional[Sequence[GlobalKnobs]] = None,
              mesh_points: Optional[Sequence[MeshSpec]] = None
              ) -> SweepWork:
        """Group, validate, cache-resolve, bound and order the pending
        rows of every (segment, combination, knob point, mesh point).
        Invalid rows and cache hits are settled through the recorder;
        everything else becomes a JobSpec.

        Rows across knob points whose relevant knob projection agrees
        land in one group (one program); incumbents, and so pruning, are
        scoped per ``"<knob kid>/<segment>"``.  ``mesh_points`` (``None``
        = the mesh is not swept) adds the topology axis, as the
        reference's: each point has its own row ids, cache environment
        column (``<mid>/<cache_tag>``), incumbent scopes
        (``<mid>/<kid>/<segment>``) and bounds (over its own chip
        count); groups never span mesh points.
        """
        points = list(knob_points) if knob_points else [GlobalKnobs()]
        swept_mesh = mesh_points is not None
        mpoints: List[Optional[MeshSpec]] = \
            list(mesh_points) if swept_mesh else [None]
        work = SweepWork(shape_key=self.shape_key, mesh_key=self.mesh_key)
        statuses = self.db.statuses(self.project)

        # incumbent best per (mesh point, knob point, segment), seeded
        # from prior rows
        for r in self.db.results(self.project):
            if r["status"] == "done" and r["cost"]:
                t = CostTerms.from_dict(r["cost"]).total_s
                scope = f"{(r['knobs'] or GlobalKnobs()).kid}/{r['segment']}"
                if r["mesh"] is not None:
                    scope = f"{r['mesh'].mid}/{scope}"
                cur = work.incumbents.get(scope)
                if cur is None or t < cur:
                    work.incumbents[scope] = t

        # group pending rows by structural program identity (never across
        # mesh points: the group key carries the point's mid)
        valid_memo: Dict[str, Tuple[bool, str]] = {}
        static_memo: Dict[Tuple, list] = {}
        map_memo: Dict[Tuple[Optional[str], str, str], str] = {}
        seg_memo = {seg.name: (seg.signature(self.cfg, self.shape),
                               seg.relevant_clause_fields(self.shape.kind),
                               seg.relevant_knob_fields(self.shape.kind))
                    for seg in segs}
        for mp in mpoints:
            mmid = mp.mid if mp is not None else None
            mesh_for_map = mp if swept_mesh else self.mesh
            env = _env_key_fn(mp, self.executor) if swept_mesh \
                else self.mesh_key
            for kn in points:
                for seg in segs:
                    sig, relevant, rel_knobs = seg_memo[seg.name]
                    for c in per_seg_combos[seg.name]:
                        rid = row_cid(c, kn, mp if swept_mesh else None)
                        if statuses.get((seg.name, rid)) in SETTLED:
                            continue
                        if self.validate:
                            if c.cid not in valid_memo:
                                valid_memo[c.cid] = \
                                    validate_combination(self.cfg, c)
                            ok, msg = valid_memo[c.cid]
                            if not ok:
                                recorder.invalid(seg.name, rid, msg)
                                continue
                        if self.static_checks != "off":
                            # one lint per distinct (segment, combination,
                            # knob point, mesh point), accounted per row
                            skey = (seg.name, c.cid, kn.kid, mmid)
                            diags = static_memo.get(skey)
                            if diags is None:
                                from repro_torch.analysis.rules import \
                                    analyze_point
                                diags = analyze_point(
                                    self.cfg, self.shape, c, knobs=kn,
                                    mesh=mesh_for_map, segments=(seg,),
                                    check_devices=self.static_devices)
                                static_memo[skey] = diags
                            if diags:
                                recorder.static_note(diags)
                                errs = [d for d in diags if d.is_error]
                                if errs and self.static_checks == "strict":
                                    recorder.static(seg.name, rid, errs)
                                    continue
                        mk = map_memo.get((mmid, seg.name, c.cid))
                        if mk is None:
                            mk = mapping_key(self.cfg, mesh_for_map, c, seg)
                            map_memo[(mmid, seg.name, c.cid)] = mk
                        ec = effective_cid(c, relevant, mk, kn, rel_knobs)
                        key = f"{sig}/{ec}" if self.share_scores \
                            else f"{seg.name}/{rid}"
                        if swept_mesh:
                            key = f"{mmid}/{key}"
                        g = work.groups.setdefault(
                            key, JobGroup(seg, c, sig, ec, knobs=kn,
                                          mesh=mp if swept_mesh else None,
                                          mesh_key=env if swept_mesh
                                          else ""))
                        g.members.append((seg.name, rid))
                        scope = f"{kn.kid}/{seg.name}"
                        g.scopes.add(f"{mmid}/{scope}" if swept_mesh
                                     else scope)

        # persistent cache stage: resolve whole groups without running
        fixed_chips = getattr(self.executor, "n_chips", 1)
        hw = getattr(self.executor, "hw", H100)
        fixed_axes = mesh_axis_sizes(self.mesh) or None
        slack_memo: Dict[int, float] = {}
        for key, g in list(work.groups.items()):
            env = g.mesh_key or work.mesh_key
            hit = self.db.cache_get(g.signature, work.shape_key,
                                    env, g.eff_cid) \
                if self.use_cache else None
            if hit is not None:
                recorder.cache_hit(g, hit)
                if hit["status"] == "done" and hit["cost"]:
                    t = CostTerms.from_dict(hit["cost"]).total_s
                    for scope in g.scopes:
                        if t < work.incumbents.get(scope, float("inf")):
                            work.incumbents[scope] = t
                del work.groups[key]
                continue
            n_chips = g.mesh.n_devices if g.mesh is not None else fixed_chips
            mesh_axes = g.mesh.axis_sizes() if g.mesh is not None \
                else fixed_axes
            slack = 0.0
            if self.boundary_slack and len(segs) > 1 and n_chips > 1:
                slack = slack_memo.get(n_chips)
                if slack is None:
                    slack = (len(segs) - 1) * max_boundary_cost_s(
                        self.cfg, self.shape, n_chips, hw)
                    slack_memo[n_chips] = slack
            kflops = self.kernel_tuning.floor_flops(
                g.seg.name, g.combo.clause) \
                if self.kernel_tuning is not None else 0.0
            work.jobs.append(JobSpec(
                key, g.seg, g.combo, segments=tuple(sorted(g.scopes)),
                bound_s=combo_lower_bound(self.cfg, self.shape, g.seg,
                                          g.combo, n_chips, hw,
                                          knobs=g.knobs,
                                          mesh_axes=mesh_axes,
                                          kernel_flops=kflops),
                signature=g.signature, eff_cid=g.eff_cid, knobs=g.knobs,
                mesh=g.mesh, mesh_key=g.mesh_key, slack_s=slack))
        recorder.flush()

        # cheapest-bound-first: incumbents tighten early, pruning bites
        work.jobs.sort(key=lambda j: (j.bound_s, j.key))
        return work


def drive(engine, work: SweepWork, recorder: Recorder, *,
          transient_retries: int = 0):
    """Run ``work`` through ``engine``, recording outcomes, with up to
    ``transient_retries`` bounded re-dispatch rounds for transient
    failures before the sweep concludes.  ``out.attempts`` accumulates
    across rounds, so the Recorder counts every extra dispatch."""
    jobs = list(work.jobs)
    by_key = {j.key: j for j in jobs}
    prior: Dict[str, int] = {}
    for round_no in range(max(0, transient_retries) + 1):
        last = round_no == max(0, transient_retries)
        retry: List[JobSpec] = []
        for out in engine.run(jobs, work.incumbents):
            out.attempts += prior.get(out.key, 0)
            if (not last and out.status == FAILED and out.transient
                    and out.key in by_key):
                retry.append(by_key[out.key])
                prior[out.key] = out.attempts
                continue
            group = work.groups.get(out.key)
            if group is not None:
                recorder.outcome(group, out)
        if not retry:
            return
        jobs = retry
