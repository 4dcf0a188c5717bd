"""Recorder: the sweep pipeline's batched result sink, as the reference's
``src/repro/core/backends/recorder.py``.

Fans one JobOutcome back out to every member (segment, cid) row of its
group, keeps the SweepReport accounting, applies the cache policy, and
writes in batched transactions (``record_many`` / ``cache_put_many``) on
the WAL connection instead of one commit per row.

Cache policy — decided by the *outcome*, not by error-string matching:
``pruned`` outcomes are project-relative (they depend on the incumbent)
and never cached; ``transient`` failures (deadline overruns, worker
crashes) depend on machine load / the time budget and never cached — a
bigger budget must be able to retry them.  Deterministic results (done,
lowering/sharding failures) are cached.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.backends.base import (DONE, FAILED, PRUNED, JobGroup,
                                            JobOutcome)
from repro_torch.core.db import SweepDB


class Recorder:
    def __init__(self, db: SweepDB, project: str, report, *,
                 shape_key: str = "", mesh_key: str = "",
                 use_cache: bool = True, batch: int = 64,
                 fault_plan=None):
        self.db = db
        self.project = project
        self.report = report
        self.shape_key = shape_key
        self.mesh_key = mesh_key
        self.use_cache = use_cache
        self.batch = max(1, int(batch))
        #: FaultPlan consulted at "recorder.flush" (tests only)
        self.fault_plan = fault_plan
        self._rows: List[Dict] = []
        self._cache: List[Dict] = []

    # ------------------------------------------------------------------
    def invalid(self, segment: str, cid: str, msg: str):
        self._rows.append({"segment": segment, "cid": cid,
                           "status": "invalid", "error": msg})
        self._maybe_flush()

    def static(self, segment: str, cid: str, diags):
        """Settle a row rejected by the static analyzer (strict mode).

        A ``static`` row never touches ``self._cache``: the rejection is a
        pre-dispatch verdict of this engine's rule set, not a scored
        outcome; caching it would let a later (possibly fixed) rule set
        serve a stale rejection as if the program had failed."""
        msg = "; ".join(f"{d.rule}: {d.message}" for d in diags)
        self._rows.append({"segment": segment, "cid": cid,
                           "status": "static", "error": msg})
        self._maybe_flush()

    def static_note(self, diags):
        """Account one row's diagnostics in the per-rule histogram
        (``SweepReport.static_rules``): once per row per distinct rule,
        in every mode that lints (strict and warn)."""
        hist = getattr(self.report, "static_rules", None)
        if hist is None:
            return
        for rule in sorted({d.rule for d in diags}):
            hist[rule] = hist.get(rule, 0) + 1

    def cache_hit(self, group: JobGroup, hit: Dict):
        """Settle a whole group from a persistent-cache entry."""
        self.report.n_cached += len(group.members)
        for sname, cid in group.members:
            self._rows.append({"segment": sname, "cid": cid,
                               "status": hit["status"], "cost": hit["cost"],
                               "error": hit["error"]})
        self._maybe_flush()

    def outcome(self, group: JobGroup, out: JobOutcome):
        """Fan a backend outcome out to all member rows + account it."""
        for sname, cid in group.members:
            self._rows.append({"segment": sname, "cid": cid,
                               "status": out.status, "cost": out.cost,
                               "error": out.error})
        rep = self.report
        # degraded-mode accounting: retries anywhere in the pipeline
        # (requeue, scheduler rounds, fallback handoff) and jobs a local
        # backend picked up after the remote budget ran out
        rep.n_transient_retried += max(0, out.attempts - 1)
        if out.fallback:
            rep.n_fallback_local += len(group.members)
        if out.status == FAILED:
            kind = out.kind or \
                ("transient" if out.transient else "deterministic")
            rep.failure_kinds[kind] = \
                rep.failure_kinds.get(kind, 0) + len(group.members)
        if out.status == PRUNED:
            rep.n_pruned += len(group.members)
        elif out.cached:
            # a worker served this group from the shared score cache —
            # no compile happened, so it counts as cached, not scored
            rep.n_cached += len(group.members)
        else:
            if out.status == DONE:
                rep.n_scored += 1
                rep.n_shared += len(group.members) - 1
            elif out.status == FAILED and out.transient:
                rep.n_transient += len(group.members)
            if self.use_cache and not out.transient:
                self._cache.append(
                    {"signature": group.signature, "shape": self.shape_key,
                     "mesh": group.mesh_key or self.mesh_key,
                     "cid": group.eff_cid,
                     "status": out.status, "cost": out.cost,
                     "error": out.error})
        self._maybe_flush()

    # ------------------------------------------------------------------
    def _maybe_flush(self):
        if len(self._rows) >= self.batch:
            self.flush()

    def flush(self):
        if self.fault_plan is not None and \
                self.fault_plan.fires("recorder.flush") is not None:
            raise RuntimeError("fault injection: recorder flush crashed")
        if self._rows:
            self.db.record_many(self.project, self._rows)
            self._rows = []
        if self._cache:
            self.db.cache_put_many(self._cache)
            self._cache = []
