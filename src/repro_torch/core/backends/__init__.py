"""Sweep scoring backends: Scheduler -> ScoringBackend -> Recorder, as the
reference's ``src/repro/core/backends/``.

``make_backend`` is the selection point for ``ComParTuner.sweep(
backend=...)``: ``"thread"`` (default), ``"sequential"`` (thread with one
worker, no pool), ``"process"`` (spawned workers, hard preemptive
timeouts), ``"remote"`` (ship jobs to a sweep scoring server,
``backends/server.py``, over HTTP; needs ``remote_url``).  With
``fallback=<local name>`` the remote backend is wrapped in a
:class:`FallbackBackend` that re-scores transiently failed jobs locally
in the same run (degraded mode).  ``retry`` is the unified
:class:`RetryPolicy`; ``token`` the remote server's shared secret.
"""
from repro_torch.core.backends.base import (  # noqa: F401
    DONE, FAILED, PRUNED, STATUSES, WIRE_VERSION, DeviceUnsatisfiable,
    IncumbentTracker, JobGroup, JobOutcome, JobSpec, RetryPolicy,
    ScoringBackend, WireVersionError, check_wire_version,
    executor_from_spec, executor_to_spec,
)
from repro_torch.core.backends.fallback import FallbackBackend  # noqa: F401
from repro_torch.core.backends.faults import (  # noqa: F401
    ChaosProxy, FaultPlan, FaultRule,
)
from repro_torch.core.backends.process import ProcessBackend  # noqa: F401
from repro_torch.core.backends.recorder import Recorder  # noqa: F401
from repro_torch.core.backends.remote import RemoteBackend  # noqa: F401
from repro_torch.core.backends.scheduler import (  # noqa: F401
    Scheduler, SweepWork, drive, env_key, mesh_key, shape_key,
)
from repro_torch.core.backends.thread import ThreadBackend  # noqa: F401

BACKENDS = ("thread", "sequential", "process", "remote")


def make_backend(name, executor, cfg, shape, *, workers=1, prune=False,
                 prune_margin=0.1, timeout_s=None, db_path=None,
                 shape_key="", mesh_key="", remote_url=None, token=None,
                 retry=None, fallback=None):
    if name in (None, "thread"):
        return ThreadBackend(executor, cfg, shape, workers=workers,
                             prune=prune, prune_margin=prune_margin)
    if name == "sequential":
        return ThreadBackend(executor, cfg, shape, workers=1,
                             prune=prune, prune_margin=prune_margin)
    if name == "process":
        return ProcessBackend(executor, cfg, shape, workers=workers,
                              prune=prune, prune_margin=prune_margin,
                              timeout_s=timeout_s, db_path=db_path,
                              shape_key=shape_key, mesh_key=mesh_key,
                              retry=retry)
    if name == "remote":
        if not remote_url:
            raise ValueError("backend='remote' needs remote_url "
                             "(the sweep scoring server, e.g. "
                             "http://host:8477)")
        remote = RemoteBackend(executor, cfg, shape, url=remote_url,
                               prune=prune, prune_margin=prune_margin,
                               timeout_s=timeout_s, shape_key=shape_key,
                               mesh_key=mesh_key, retry=retry, token=token)
        if fallback is None:
            return remote
        if fallback == "remote":
            raise ValueError("fallback must be a LOCAL backend "
                             "(thread/sequential/process): falling back "
                             "to the remote that just failed is a loop")
        local = make_backend(fallback, executor, cfg, shape,
                             workers=workers, prune=prune,
                             prune_margin=prune_margin, timeout_s=timeout_s,
                             db_path=db_path, shape_key=shape_key,
                             mesh_key=mesh_key, retry=retry)
        return FallbackBackend(remote, local)
    raise ValueError(f"unknown backend {name!r}; have {BACKENDS}")
