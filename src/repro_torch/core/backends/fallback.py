"""Graceful degradation: re-score remote losses locally, in the same run,
as the reference's ``src/repro/core/backends/fallback.py``.

Before this backend, a scoring-server outage had exactly one shape: the
:class:`~repro_torch.core.backends.remote.RemoteBackend` burned its retry
budget, failed every pending job ``transient=True``, and the sweep
quietly fused a plan from whatever survived — recovery deferred to
"a later sweep".  :class:`FallbackBackend` closes that gap: it streams
the primary's outcomes through, collects the transient failures, and
re-scores them on a *local* backend before the run concludes.  The
degraded path is loud, not silent — every fallback outcome is flagged
``fallback=True`` and the Recorder surfaces the count as
``SweepReport.n_fallback_local``.

What is and is not retried locally:

* transient FAILED outcomes (server unreachable, server-side batch
  failure, deadline double-loss) — retried: they are verdicts on the
  *infrastructure*, not the combination;
* deterministic FAILED / DONE / PRUNED outcomes — passed through: the
  remote's verdict stands (re-scoring a deterministic failure locally
  would just re-prove it, and DONE needs no help);
* protocol errors (HTTP 4xx, wire-version mismatch, bad token) —
  raised: fallback exists to absorb outages, never to paper over bugs.

Attempt accounting carries across the seam: a job the remote dispatched
twice and the local backend scored on the third try reports
``attempts=3``.
"""
from __future__ import annotations

import logging
from typing import Dict, Iterator, List, Optional, Sequence

from repro_torch.core.backends.base import (FAILED, JobOutcome, JobSpec,
                                            ScoringBackend)

log = logging.getLogger("repro_torch.backends.fallback")


class FallbackBackend(ScoringBackend):
    """Wrap a primary (remote) backend over a local one: jobs the
    primary fails transiently are re-scored locally in the same run."""

    name = "fallback"

    def __init__(self, primary: ScoringBackend, local: ScoringBackend):
        self.primary = primary
        self.local = local
        self.n_fallback = 0     # jobs the local backend picked up, last run

    def run(self, jobs: Sequence[JobSpec],
            incumbents: Optional[Dict[str, float]] = None
            ) -> Iterator[JobOutcome]:
        self.n_fallback = 0
        by_key = {j.key: j for j in jobs}
        retry: List[JobSpec] = []
        prior: Dict[str, int] = {}
        for out in self.primary.run(jobs, incumbents):
            if out.status == FAILED and out.transient \
                    and out.key in by_key:
                retry.append(by_key[out.key])
                prior[out.key] = out.attempts
                continue
            yield out
        if not retry:
            return
        self.n_fallback = len(retry)
        log.warning("primary backend %s failed %d job(s) transiently: "
                    "re-scoring locally on %s", self.primary.name,
                    len(retry), self.local.name)
        for out in self.local.run(retry, incumbents):
            out.fallback = True
            out.attempts += prior.get(out.key, 1)
            yield out

    def close(self):
        try:
            self.primary.close()
        finally:
            self.local.close()
