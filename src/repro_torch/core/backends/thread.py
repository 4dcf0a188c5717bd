"""Thread backend: in-process scoring, as the reference's
``src/repro/core/backends/thread.py``.

Wraps ``ParallelSweepRunner``: shared incumbents, exact pruning, soft
(post-hoc, CPU-time) deadlines off the main thread.  ``workers=1`` is a
plain in-thread loop, which is also the ``backend="sequential"`` mode.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.backends.base import (JobOutcome, JobSpec,
                                            ScoringBackend)


class ThreadBackend(ScoringBackend):
    name = "thread"

    def __init__(self, executor, cfg: ArchConfig, shape: ShapeConfig, *,
                 workers: int = 1, prune: bool = False,
                 prune_margin: float = 0.1):
        from repro_torch.core.executor import ParallelSweepRunner
        self.runner = ParallelSweepRunner(
            executor, cfg, shape, workers=workers,
            prune=prune, prune_margin=prune_margin)

    def run(self, jobs: Sequence[JobSpec],
            incumbents: Optional[Dict[str, float]] = None
            ) -> Iterator[JobOutcome]:
        for res in self.runner.run(list(jobs), incumbents=incumbents):
            yield JobOutcome(
                key=res.job.key, status=res.status,
                cost=res.cost.as_dict() if res.cost is not None else None,
                error=res.error, transient=res.transient)

