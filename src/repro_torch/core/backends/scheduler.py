"""Scheduler: registered rows -> ordered unique JobSpecs, as the
reference's ``src/repro/core/backends/scheduler.py``.

The stage of the sweep pipeline that runs before any scoring: structural
grouping (rows that build the same program share one job), black-box
validation, persistent score-cache resolution (whole groups settled
without running anything), and lower-bound ordering (cheapest analytic
bound first, so incumbents tighten early and pruning bites sooner).  With a
static analyzer mode it lints every row first (``repro_torch.analysis``),
and with the kernel autotuner's verdict each job's bound takes the
certified kernel flops of its schedule.  The port is meshless.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.backends.base import FAILED, JobGroup, JobSpec
from repro_torch.core.backends.recorder import Recorder
from repro_torch.core.combinator import (Combination, GlobalKnobs,
                                         effective_cid, mapping_key,
                                         require_meshless, row_cid)
from repro_torch.core.cost_model import H100, CostTerms, combo_lower_bound
from repro_torch.core.db import SweepDB
from repro_torch.core.segment import Segment
from repro_torch.core.validator import validate_combination

#: statuses that Continue mode treats as settled (no re-run on resume)
SETTLED = ("done", "failed", "invalid", "pruned", "static")


def shape_key(shape: ShapeConfig) -> str:
    return f"{shape.kind}:{shape.seq_len}x{shape.global_batch}"


def mesh_key(mesh) -> str:
    """Mesh content key of the ``score_cache.mesh`` column: ``"local"``,
    the port being meshless."""
    require_meshless(mesh)
    return "local"


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
                 kernel_tuning=None,
                 static_checks: str = "off"):
        require_meshless(mesh)
        self.db = db
        self.project = project
        self.cfg = cfg
        self.shape = shape
        self.executor = executor
        self.validate = validate
        self.share_scores = share_scores
        self.use_cache = use_cache
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
        # the cache keys the pipeline reads AND writes under — a caller
        # (the tuner) passes one pair so write and read can't desync
        self.shape_key = shape_key if shape_key is not None \
            else _shape_key_fn(shape)
        self.mesh_key = mesh_key if mesh_key is not None \
            else _env_key_fn(None, executor)

    def build(self, segs: Sequence[Segment],
              per_seg_combos: Dict[str, List[Combination]],
              recorder: Recorder,
              knob_points: Optional[Sequence[GlobalKnobs]] = None
              ) -> SweepWork:
        """Group, validate, cache-resolve, bound and order the pending
        rows of every (segment, combination, knob point).  Invalid rows
        and cache hits are settled through the recorder; everything else
        becomes a JobSpec.

        Rows across knob points whose relevant knob projection agrees
        land in one group (one program); incumbents, and so pruning, are
        scoped per ``"<knob kid>/<segment>"``.
        """
        points = list(knob_points) if knob_points else [GlobalKnobs()]
        work = SweepWork(shape_key=self.shape_key, mesh_key=self.mesh_key)
        statuses = self.db.statuses(self.project)

        # incumbent best per (knob point, segment), seeded from prior rows
        for r in self.db.results(self.project):
            if r["status"] == "done" and r["cost"]:
                t = CostTerms.from_dict(r["cost"]).total_s
                scope = f"{(r['knobs'] or GlobalKnobs()).kid}/{r['segment']}"
                cur = work.incumbents.get(scope)
                if cur is None or t < cur:
                    work.incumbents[scope] = t

        # group pending rows by structural program identity
        valid_memo: Dict[str, Tuple[bool, str]] = {}
        static_memo: Dict[Tuple, list] = {}
        seg_memo = {seg.name: (seg.signature(self.cfg, self.shape),
                               seg.relevant_clause_fields(self.shape.kind),
                               seg.relevant_knob_fields(self.shape.kind))
                    for seg in segs}
        for kn in points:
            for seg in segs:
                sig, relevant, rel_knobs = seg_memo[seg.name]
                for c in per_seg_combos[seg.name]:
                    rid = row_cid(c, kn)
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
                        # diagnostics depend only on (segment,
                        # combination, knob point): one lint per distinct
                        # tuple, accounted per row
                        skey = (seg.name, c.cid, kn.kid)
                        diags = static_memo.get(skey)
                        if diags is None:
                            from repro_torch.analysis.rules import \
                                analyze_point
                            diags = analyze_point(self.cfg, self.shape, c,
                                                  knobs=kn, segments=(seg,))
                            static_memo[skey] = diags
                        if diags:
                            recorder.static_note(diags)
                            errs = [d for d in diags if d.is_error]
                            if errs and self.static_checks == "strict":
                                recorder.static(seg.name, rid, errs)
                                continue
                    ec = effective_cid(c, relevant,
                                       mapping_key(self.cfg, None, c, seg),
                                       kn, rel_knobs)
                    key = f"{sig}/{ec}" if self.share_scores \
                        else f"{seg.name}/{rid}"
                    g = work.groups.setdefault(
                        key, JobGroup(seg, c, sig, ec, knobs=kn))
                    g.members.append((seg.name, rid))
                    g.scopes.add(f"{kn.kid}/{seg.name}")

        # persistent cache stage: resolve whole groups without running
        hw = getattr(self.executor, "hw", H100)
        for key, g in list(work.groups.items()):
            hit = self.db.cache_get(g.signature, work.shape_key,
                                    work.mesh_key, g.eff_cid) \
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
            kflops = self.kernel_tuning.floor_flops(
                g.seg.name, g.combo.clause) \
                if self.kernel_tuning is not None else 0.0
            work.jobs.append(JobSpec(
                key, g.seg, g.combo, segments=tuple(sorted(g.scopes)),
                bound_s=combo_lower_bound(self.cfg, self.shape, g.seg,
                                          g.combo, 1, hw, knobs=g.knobs,
                                          kernel_flops=kflops),
                signature=g.signature, eff_cid=g.eff_cid, knobs=g.knobs))
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
