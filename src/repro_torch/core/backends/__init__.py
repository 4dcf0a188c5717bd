"""Sweep scoring backends: Scheduler -> ScoringBackend -> Recorder, as the
reference's ``src/repro/core/backends/``.

``make_backend`` is the selection point for ``ComParTuner.sweep(
backend=...)``: ``"thread"`` (default) or ``"sequential"`` (one worker, no
pool).  The process and remote backends come with ROADMAP Queue 1 item 5.
"""
from repro_torch.core.backends.base import (  # noqa: F401
    DONE, FAILED, PRUNED, STATUSES, WIRE_VERSION, IncumbentTracker, JobGroup,
    JobOutcome, JobSpec, RetryPolicy, ScoringBackend,
)
from repro_torch.core.backends.recorder import Recorder  # noqa: F401
from repro_torch.core.backends.scheduler import (  # noqa: F401
    Scheduler, SweepWork, drive, env_key, mesh_key, shape_key,
)
from repro_torch.core.backends.thread import (  # noqa: F401
    BACKENDS, ThreadBackend, make_backend,
)
