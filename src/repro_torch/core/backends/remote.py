"""Remote scoring backend: ship JobSpecs to a sweep scoring server, as the
reference's ``src/repro/core/backends/remote.py``.

The client half of sweep-as-a-service (``backends/server.py``): jobs
leave this host as the JSON wire format of ``backends.base`` and come
back as :class:`JobOutcome` streams over a long-poll cursor.  The
Scheduler and Recorder stages are untouched — this backend slots into
``ComParTuner.sweep(backend="remote", remote_url=...)`` exactly where
the thread/process backends do.

Failure contract (the part that keeps the cache honest):

* **Idempotent retries.**  Jobs are content-keyed — the server derives
  the batch id from the payload's sha1 — so a submit replayed after a
  connection loss *attaches* to the original batch, and the outcome
  cursor (``after=N``) makes polls replay-safe.  A batch the server no
  longer knows (it restarted) is simply resubmitted: every score it
  already banked is served back from its persistent cache.
* **Unreachable server = transient.**  If the server stays unreachable
  past the retry budget, every unfinished job fails with
  ``transient=True`` — the Recorder never caches transient outcomes, so
  an outage can never be poisoned into ``score_cache`` as if the
  combinations themselves were bad.  A later sweep retries them.
* **Protocol errors raise.**  HTTP 4xx (wire-version mismatch, rejected
  executor spec, bad/missing auth token) is a bug, not an outage —
  retrying can never succeed, so the sweep fails loudly instead.
  5xx, torn replies (truncated/corrupt JSON), and transport losses are
  the server's problem, not the client's: all retried within the
  :class:`~repro_torch.core.backends.base.RetryPolicy` budget with jittered
  exponential backoff (no thundering herd after a restart).

Pruning runs client-side at submit time against the seeded incumbents
(the server is incumbent-free: incumbents are a property of the client's
project, not of the shared score pool).
"""
from __future__ import annotations

import http.client
import json
import logging
import time
import urllib.error
import urllib.request
import uuid
from typing import Dict, Iterator, Optional, Sequence

from repro_torch.core.backends.base import (FAILED, PRUNED, WIRE_VERSION,
                                            IncumbentTracker, JobOutcome,
                                            JobSpec, RetryPolicy,
                                            ScoringBackend, executor_to_spec)

log = logging.getLogger("repro_torch.backends.remote")

#: sentinel `_request` returns for a recoverable HTTP 404 (unknown batch)
_NOT_FOUND = {"_not_found": True}


class RemoteBackend(ScoringBackend):
    """Score jobs on a remote sweep scoring server over HTTP."""

    name = "remote"

    def __init__(self, executor, cfg, shape, *, url: str,
                 prune: bool = False, prune_margin: float = 0.1,
                 timeout_s: Optional[float] = None,
                 shape_key: str = "", mesh_key: str = "",
                 poll_s: float = 20.0, retry_s: Optional[float] = None,
                 backoff_s: Optional[float] = None,
                 retry: Optional[RetryPolicy] = None,
                 token: Optional[str] = None):
        from repro_torch.configs.registry import arch_to_spec, shape_to_spec
        self.url = url.rstrip("/")
        self.prune = prune
        self.prune_margin = prune_margin
        self.tracker = IncumbentTracker(prune, prune_margin)
        self.poll_s = poll_s        # long-poll window per outcomes request
        # retry_s/backoff_s predate RetryPolicy; they overlay the policy
        # so existing call sites keep their behavior
        base = retry if retry is not None else RetryPolicy()
        if retry_s is not None or backoff_s is not None:
            import dataclasses
            base = dataclasses.replace(
                base,
                budget_s=base.budget_s if retry_s is None else retry_s,
                base_s=base.base_s if backoff_s is None else backoff_s)
        self.retry = base
        self.retry_s = self.retry.budget_s
        self.token = token
        # the server rebuilds the executor from this spec and rejects the
        # submit with HTTP 400 if it cannot (a wall-clock device it lacks)
        self._init = {
            "executor": executor_to_spec(executor),
            "arch": arch_to_spec(cfg),
            "shape": shape_to_spec(shape),
            "shape_key": shape_key,
            "mesh_key": mesh_key,
        }

    # ------------------------------------------------------------------
    def _request(self, path: str, payload: Optional[Dict] = None,
                 timeout: Optional[float] = None) -> Optional[Dict]:
        """One HTTP exchange with idempotent transient-failure retries.

        Returns the decoded JSON reply; ``_NOT_FOUND`` for a recoverable
        404; ``None`` once the server stayed unavailable past the retry
        budget.  Retryable: transport losses (connection refused/reset,
        timeouts), torn replies (truncated or corrupt JSON — the server
        or a proxy died mid-write), and HTTP 5xx (the server or a proxy
        in front of a restarting server failed the request).  Backoff is
        jittered exponential per :class:`RetryPolicy` so a fleet of
        clients recovering from one restart doesn't re-poll in lockstep.
        Other HTTP errors raise — they are protocol bugs a retry cannot
        fix; 401 in particular is never retried (a wrong token stays
        wrong)."""
        data = json.dumps(payload).encode() if payload is not None else None
        headers = {"Content-Type": "application/json"}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        deadline = time.monotonic() + self.retry.budget_s
        attempt = 0
        while True:
            req = urllib.request.Request(self.url + path, data=data,
                                         headers=headers)
            try:
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    return json.loads(resp.read().decode())
            except urllib.error.HTTPError as e:
                if e.code == 404:
                    return _NOT_FOUND
                if e.code < 500:
                    body = e.read().decode(errors="replace")
                    hint = " (wrong or missing --token? pass " \
                        "remote_token=/token=)" if e.code == 401 else ""
                    raise RuntimeError(
                        f"scoring server rejected {path}: "
                        f"HTTP {e.code}{hint} {body}") from e
                err: Exception = e      # 5xx: retryable server failure
            except (urllib.error.URLError, ConnectionError, OSError,
                    TimeoutError, http.client.HTTPException,
                    json.JSONDecodeError, UnicodeDecodeError) as e:
                # HTTPException covers torn replies (IncompleteRead,
                # BadStatusLine); JSON/Unicode decode failures are the
                # same event seen one layer up — bytes from a server or
                # proxy that died mid-write
                err = e
            if time.monotonic() >= deadline:
                log.warning("scoring server %s unavailable past %.1fs "
                            "retry budget (%s): %s", self.url,
                            self.retry.budget_s, path, err)
                return None
            time.sleep(self.retry.pause_s(attempt))
            attempt += 1

    def _submit(self, payload: Dict) -> Optional[str]:
        resp = self._request("/v1/submit", payload,
                             timeout=max(self.retry_s, 10.0))
        if resp is _NOT_FOUND:
            # only /v1/outcomes 404s (a forgotten batch) are recoverable;
            # a 404 on submit means the URL is not a scoring server —
            # that's a protocol error, not an outage
            raise RuntimeError(
                f"scoring server rejected /v1/submit with HTTP 404 — is "
                f"{self.url} really a sweep scoring server "
                f"(python -m repro_torch.core.backends.server)?")
        if resp is None:
            return None
        return resp["batch"]

    # ------------------------------------------------------------------
    def run(self, jobs: Sequence[JobSpec],
            incumbents: Optional[Dict[str, float]] = None
            ) -> Iterator[JobOutcome]:
        self.tracker = IncumbentTracker(self.prune, self.prune_margin)
        self.tracker.seed(incumbents)
        submit = []
        for job in jobs:
            if self.tracker.pruned(job):
                yield JobOutcome(job.key, PRUNED,
                                 error=f"lower bound {job.bound_s:.3e}s > "
                                       "incumbent best")
            else:
                submit.append(job)
        if not submit:
            return
        # the run nonce scopes batch idempotency to THIS run(): retries
        # and resubmits replay the same payload (same batch), while a
        # *different* sweep with identical jobs gets a fresh batch whose
        # scores resolve from the server's cache as cached=True — so a
        # client's n_scored counts only compiles done on its behalf
        payload = {"v": WIRE_VERSION, "run": uuid.uuid4().hex,
                   "init": self._init,
                   "jobs": [j.to_json() for j in submit]}
        pending = {j.key for j in submit}

        def fail_pending(reason: str,
                         kind: str = "unreachable") -> Iterator[JobOutcome]:
            # server-side losses are never a verdict on the combination:
            # transient means the Recorder won't cache them, and a
            # FallbackBackend (or a later sweep / a scheduler retry
            # round) re-scores them
            for key in sorted(pending):
                yield JobOutcome(key, FAILED, error=reason, transient=True,
                                 kind=kind)

        batch = self._submit(payload)
        if batch is None:
            yield from fail_pending(
                f"scoring server {self.url} unreachable (submit)")
            return
        after = 0
        while pending:
            resp = self._request(
                f"/v1/outcomes?batch={batch}&after={after}"
                f"&wait={self.poll_s:g}", timeout=self.poll_s + 30.0)
            if resp is None:
                yield from fail_pending(
                    f"scoring server {self.url} unreachable (poll)")
                return
            if resp is _NOT_FOUND:
                # the server forgot the batch (restart/eviction): the
                # payload is content-keyed, so resubmitting resumes it —
                # already-banked scores come back as cache hits
                log.warning("batch %s unknown to %s: resubmitting",
                            batch, self.url)
                batch = self._submit(payload)
                if batch is None:
                    yield from fail_pending(
                        f"scoring server {self.url} unreachable (resubmit)")
                    return
                after = 0
                continue
            for od in resp.get("outcomes", []):
                after += 1
                out = JobOutcome.from_json(od)
                if out.key not in pending:
                    continue            # replayed duplicate after a resubmit
                pending.discard(out.key)
                yield out
            if resp.get("done") and pending:
                err = resp.get("error") or \
                    "server finished without scoring all jobs"
                yield from fail_pending(f"scoring server error: {err}",
                                        kind="server")
                return

    def close(self):
        """Stateless client: nothing to release (pools live server-side)."""
