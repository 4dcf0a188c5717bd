"""Sweep scoring server: the remote end of sweep-as-a-service, as the
reference's ``src/repro/core/backends/server.py``.

A stdlib-only HTTP service that fronts a warm :class:`ProcessBackend` pool
and a WAL ``score_cache``, so any number of client sweeps, on this host or
others, can ship :class:`JobSpec` batches here instead of scoring locally.
Every job is resolved against the server's persistent ``score_cache``
before any worker spawns, so a combination any client ever scored is
served to every later client without running it again.

    python -m repro_torch.core.backends.server --db /path/scores.db --workers 4

Wall-clock specs are timed on this host's card, and their cache tag names
that card (a client's tag that names another is refused at submit).  A
departure from the reference, whose server times ``--workers`` programs
and every client's batches on one card at once: an executor that is not
``parallel_safe`` (the wall clock) gets an engine of one worker, and its
batches run one at a time per device, under one lock per device, so no
two wall-clock timings contend whatever the clients send.  Dry-run
batches keep ``--workers`` workers and run in parallel.

Protocol (all JSON, wire version ``backends.base.WIRE_VERSION``):

``POST /v1/submit``
    ``{"v": 1, "init": {executor/arch/shape specs + shape_key/mesh_key},
    "jobs": [JobSpec...]}`` → ``{"v": 1, "batch": "<id>", "resumed": bool}``.
    The batch id is the sha1 of the payload content — submits are
    **idempotent**: replaying the same payload (a client retrying after
    a connection loss) attaches to the original batch instead of scoring
    everything twice.
``GET /v1/outcomes?batch=ID&after=N&wait=S``
    long-poll: blocks up to ``S`` seconds for outcomes with index >= N,
    returns ``{"v": 1, "outcomes": [JobOutcome...], "done": bool,
    "error": str}``.  The cursor makes polls replay-safe too.
``GET /v1/health`` / ``GET /v1/stats``
    liveness + counters (``n_compiled``, ``n_cache_hits``,
    ``cache_size``, ``n_evicted``): a cache-warm sweep leaves
    ``n_compiled`` untouched.

Completed batches are TTL-evicted (``--batch-ttl-s``, default 1h): the
outcome log of a finished batch only matters until its client drains
it, and the client's resubmit-on-404 path makes eviction safe even for
a client that comes back later — the resubmitted batch resolves from
the score cache.

Auth: ``--token SECRET`` requires ``Authorization: Bearer SECRET`` on
every request (constant-time compare; 401 otherwise — clients treat
that as a protocol error, never retried).  Binding a non-loopback host
without a token is refused outright: an open scoring server is a free
compile farm plus a writable shared score cache for anyone who finds
the port.  (Transport encryption is still TLS-terminating-proxy
territory — the token travels in clear over plain HTTP.)

Client *executor* specs are deserialized with ``allow_test=False`` by
default: accepting ``{"kind": "crash"}`` from the network would hand
every client a kill switch for the worker pool (``--allow-test-executors``
opts in for fault-injection tests).  Batches never run client code: a
JobSpec names registry configs and enum-like clause fields only.  A spec
this host cannot run (a wall-clock device it lacks, a mesh) is HTTP 400 at
submit, never a score taken on another device.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import hmac
import ipaddress
import json
import logging
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from repro_torch.core.backends.base import (DONE, FAILED, WIRE_VERSION,
                                            JobOutcome, JobSpec,
                                            WireVersionError,
                                            check_wire_version,
                                            executor_from_spec)
from repro_torch.core.backends.process import ProcessBackend
from repro_torch.core.db import SweepDB

log = logging.getLogger("repro_torch.backends.server")


def batch_id(payload: Dict) -> str:
    """Content key of a submit payload: the same submit always resolves
    to the same batch, so replays after a connection loss are safe.  The
    client's ``run`` nonce is part of the key — idempotency is scoped to
    one client ``run()``; a *different* sweep with identical jobs gets
    its own batch (and its scores from the cache, flagged ``cached``)."""
    blob = json.dumps({"run": payload.get("run"),
                       "init": payload.get("init"),
                       "jobs": payload.get("jobs")}, sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()[:20]


class _Batch:
    """One submitted job batch: outcomes accumulate under a condition
    variable so long-polling readers wake as soon as one lands."""

    def __init__(self, bid: str, init: Dict, jobs: List[Dict]):
        self.bid = bid
        self.init = init
        self.jobs = jobs
        self.outcomes: List[Dict] = []
        self.done = False
        self.error = ""
        self.finished_at: Optional[float] = None   # monotonic, for TTL
        self.cond = threading.Condition()

    def push(self, out: Dict):
        with self.cond:
            self.outcomes.append(out)
            self.cond.notify_all()

    def finish(self, error: str = ""):
        with self.cond:
            self.done = True
            self.error = error
            self.finished_at = time.monotonic()
            self.cond.notify_all()

    def read(self, after: int, wait_s: float
             ) -> Tuple[List[Dict], bool, str]:
        deadline = time.monotonic() + max(0.0, wait_s)
        with self.cond:
            while len(self.outcomes) <= after and not self.done:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self.cond.wait(left)
            return list(self.outcomes[after:]), self.done, self.error


def _is_loopback(host: str) -> bool:
    """True for hosts that only loopback traffic can reach.  Unknown
    names (and the all-interfaces wildcards) count as non-loopback —
    the guard must fail closed."""
    if host in ("localhost", ""):
        return host == "localhost"
    try:
        return ipaddress.ip_address(host).is_loopback
    except ValueError:
        return False


class SweepScoringServer:
    """HTTP front of a warm ProcessBackend pool + a shared score cache."""

    def __init__(self, db_path: str, *, workers: int = 2,
                 host: str = "127.0.0.1", port: int = 0,
                 allow_test: bool = False, poll_cap_s: float = 60.0,
                 token: Optional[str] = None,
                 batch_ttl_s: float = 3600.0,
                 calibrate: bool = False):
        if token is None and not _is_loopback(host):
            raise ValueError(
                f"refusing to bind non-loopback host {host!r} without a "
                "shared-secret token: an open scoring server is a free "
                "compile farm and a writable score cache for anyone who "
                "finds the port — pass --token (and keep TLS termination "
                "in front for non-trusted networks)")
        self.db = SweepDB(db_path)
        self.db_path = db_path
        #: this host's measured MachineProfile (``--calibrate``): loaded
        #: from (or measured on this host's card into) the server DB's
        #: ``machine_cache``, so every ``machine="auto"`` tuner sharing
        #: this DB reuses one profile.  Surfaced in ``/v1/stats``.
        self.profile = None
        if calibrate:
            from repro_torch.core.machine import load_or_calibrate
            self.profile = load_or_calibrate(self.db, device="cuda")
            log.info("host profile %s (pid %s)", self.profile.key,
                     self.profile.pid[:12])
        self.workers = max(1, int(workers))
        self.allow_test = allow_test
        self.poll_cap_s = poll_cap_s
        self.token = token
        self.batch_ttl_s = batch_ttl_s
        self._lock = threading.Lock()       # batches/engines/counters
        self._db_lock = threading.Lock()    # one writer connection
        self._batches: Dict[str, _Batch] = {}
        #: engine-config key -> (backend, run lock, device lock);
        #: ProcessBackend.run is not re-entrant, so batches sharing an
        #: engine serialize on the run lock
        self._engines: Dict[str, Tuple[ProcessBackend, threading.Lock,
                                       Optional[threading.Lock]]] = {}
        #: device -> the lock every timing executor on it runs under
        self._device_locks: Dict[str, threading.Lock] = {}
        self.n_compiled = 0                 # programs actually scored here
        self.n_cache_hits = 0               # jobs served from score_cache
        self.n_evicted = 0                  # finished batches TTL-swept
        self._httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> str:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        log.info("sweep scoring server listening on %s (db=%s, workers=%d)",
                 self.url, self.db_path, self.workers)
        return self.url

    def close(self):
        """Stop serving and release the worker pools; idempotent (and
        safe on a never-started server: shutdown() would block forever
        waiting for a serve_forever loop that never ran)."""
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5)
            self._thread = None
        self._httpd.server_close()
        with self._lock:
            engines, self._engines = self._engines, {}
        for engine, _, _ in engines.values():
            try:
                engine.close()
            except Exception:
                log.warning("engine close failed", exc_info=True)

    # ------------------------------------------------------------------
    def submit(self, payload: Dict) -> Tuple[str, bool]:
        """Register a batch (idempotent) and start scoring it.  Returns
        ``(batch_id, resumed)``.  Raises ``WireVersionError`` /
        ``TypeError`` / ``ValueError`` on protocol-level bad payloads —
        the handler maps those to HTTP 400 so the client fails loudly
        instead of retrying a request that can never succeed."""
        self._evict()
        check_wire_version(payload)
        init = payload.get("init") or {}
        if not isinstance(payload.get("jobs"), list):
            raise ValueError("payload has no job list")
        # reject un-servable payloads at submit time (protocol errors,
        # not transient outages — a client must fail loudly, not retry
        # forever): test executors are never admitted from the wire
        # unless this server opted in, and arch/shape/job specs that
        # cannot be reconstructed here (registry version skew, malformed
        # wire data) are a 400, not a batch that 'transiently' fails on
        # every resubmit; so is a wall-clock device this host lacks
        # (DeviceUnsatisfiable) and a mesh it cannot build
        # (MeshUnsatisfiable)
        from repro_torch.configs.registry import (arch_from_spec,
                                                  shape_from_spec)
        executor = executor_from_spec(init["executor"],
                                      allow_test=self.allow_test)
        arch_from_spec(init["arch"])
        shape_from_spec(init["shape"])
        self._check_cache_tag(executor, init.get("mesh_key", ""))
        for jd in payload["jobs"]:
            spec = JobSpec.from_json(jd)
            if spec.mesh is not None:
                # a protocol error (HTTP 400): retrying can never succeed
                spec.mesh.check_local()
            self._check_cache_tag(executor, spec.mesh_key)
        bid = batch_id(payload)
        with self._lock:
            batch = self._batches.get(bid)
            resumed = batch is not None
            if not resumed:
                batch = _Batch(bid, init, payload["jobs"])
                self._batches[bid] = batch
        if not resumed:
            threading.Thread(target=self._run_batch, args=(batch,),
                             daemon=True).start()
        return bid, resumed

    @staticmethod
    def _check_cache_tag(executor, mesh_key: str):
        """A client-derived environment column whose executor tag half
        does not match the tag of the executor THIS server rebuilt is a
        protocol error: scores would be measured here but banked under
        the client's environment — e.g. a CPU client's
        ``wallclock:r5:cpu:x86_64`` column filled with this host's card's
        medians, served back to genuinely-CPU hosts later.  Only env-formatted
        keys (``<mesh>/<tag>``) are checked; opaque test keys pass."""
        tag = getattr(executor, "cache_tag", None)
        if tag is None or "/" not in mesh_key:
            return
        got = mesh_key.split("/", 1)[1]
        if got != tag:
            raise ValueError(
                f"cache environment tag mismatch: client banked under "
                f"{got!r} but this server's executor scores as {tag!r} — "
                "scores measured here must not be cached as the client's "
                "environment")

    def _evict(self):
        """TTL-sweep finished batches.  Safe by construction: an evicted
        batch polls as 404 and the client resubmits its content-keyed
        payload, which resolves from the score cache.  Caller must NOT
        hold ``_lock``."""
        if self.batch_ttl_s is None or self.batch_ttl_s < 0:
            return
        now = time.monotonic()
        with self._lock:
            dead = [bid for bid, b in self._batches.items()
                    if b.done and b.finished_at is not None
                    and now - b.finished_at > self.batch_ttl_s]
            for bid in dead:
                del self._batches[bid]
            self.n_evicted += len(dead)
        for bid in dead:
            log.info("evicted finished batch %s (ttl %.0fs)", bid,
                     self.batch_ttl_s)

    def batch(self, bid: str) -> Optional[_Batch]:
        self._evict()
        with self._lock:
            return self._batches.get(bid)

    def stats(self) -> Dict:
        self._evict()
        with self._lock:
            n_compiled, n_hits = self.n_compiled, self.n_cache_hits
            n_batches = len(self._batches)
            n_evicted = self.n_evicted
        with self._db_lock:
            cache_size = self.db.cache_size()
        return {"n_compiled": n_compiled, "n_cache_hits": n_hits,
                "n_batches": n_batches, "cache_size": cache_size,
                "n_evicted": n_evicted, "batch_ttl_s": self.batch_ttl_s,
                "workers": self.workers,
                "machine": ({"key": self.profile.key,
                             "pid": self.profile.pid,
                             "hbm_bw": self.profile.hbm_bw,
                             "peak_flops": dict(self.profile.peak_flops)}
                            if self.profile is not None else None)}

    # ------------------------------------------------------------------
    def _engine_for(self, init: Dict) -> Tuple[ProcessBackend,
                                               threading.Lock,
                                               Optional[threading.Lock]]:
        """One warm ProcessBackend per distinct (executor, arch, shape,
        cache-key) config, reused across batches: torch imports and CUDA
        contexts are paid once per worker, not once per client sweep.

        An executor that is not ``parallel_safe`` gets one worker and its
        device's lock (the module docstring's departure); a parallel-safe
        one gets ``self.workers`` and no device lock."""
        from repro_torch.configs.registry import (arch_from_spec,
                                                  shape_from_spec)
        key = json.dumps(init, sort_keys=True)
        with self._lock:
            entry = self._engines.get(key)
            if entry is None:
                executor = executor_from_spec(init["executor"],
                                              allow_test=self.allow_test)
                timing = not executor.parallel_safe
                device_lock = self._device_locks.setdefault(
                    str(executor.device), threading.Lock()) \
                    if timing else None
                engine = ProcessBackend(
                    executor, arch_from_spec(init["arch"]),
                    shape_from_spec(init["shape"]),
                    workers=1 if timing else self.workers,
                    timeout_s=getattr(executor, "timeout_s", None),
                    db_path=self.db_path, shape_key=init.get("shape_key", ""),
                    mesh_key=init.get("mesh_key", ""))
                entry = (engine, threading.Lock(), device_lock)
                self._engines[key] = entry
            return entry

    def _run_batch(self, batch: _Batch):
        try:
            sk = batch.init.get("shape_key", "")
            mk = batch.init.get("mesh_key", "")
            pending: List[JobSpec] = []
            for jd in batch.jobs:
                spec = JobSpec.from_json(jd)
                hit = None
                if spec.signature:
                    with self._db_lock:
                        # mesh-axis jobs carry their own environment
                        # column; the init mesh_key covers the rest
                        hit = self.db.cache_get(spec.signature, sk,
                                                spec.mesh_key or mk,
                                                spec.eff_cid)
                if hit is not None and hit["status"] in (DONE, FAILED):
                    with self._lock:
                        self.n_cache_hits += 1
                    batch.push(JobOutcome(
                        spec.key, hit["status"], cost=hit["cost"],
                        error=hit["error"], cached=True).to_json())
                else:
                    pending.append(spec)
            if pending:
                engine, run_lock, device_lock = self._engine_for(
                    batch.init)
                by_key = {s.key: s for s in pending}
                puts: List[Dict] = []
                # the device lock first, then the engine's: one order
                with device_lock or contextlib.nullcontext(), run_lock:
                    for out in engine.run(pending):
                        spec = by_key.get(out.key)
                        if out.status == DONE and not out.cached:
                            with self._lock:
                                self.n_compiled += 1
                        # same policy as the Recorder: deterministic
                        # results enter the shared cache, transient ones
                        # (deadline double-loss, crash) never do
                        if (spec is not None and spec.signature
                                and not out.cached and not out.transient
                                and out.status in (DONE, FAILED)):
                            puts.append({
                                "signature": spec.signature, "shape": sk,
                                "mesh": spec.mesh_key or mk,
                                "cid": spec.eff_cid,
                                "status": out.status, "cost": out.cost,
                                "error": out.error})
                        batch.push(out.to_json())
                if puts:
                    with self._db_lock:
                        self.db.cache_put_many(puts)
            batch.finish()
        except Exception as e:
            # a server-side failure is an outage, not a verdict on the
            # jobs: finish with an error so clients fail their remaining
            # rows as *transient* (retryable, never cached)
            log.exception("batch %s failed server-side", batch.bid)
            batch.finish(error=f"{type(e).__name__}: {e}")


def _make_handler(app: SweepScoringServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):          # route to logging
            log.debug("%s - %s", self.address_string(), fmt % args)

        def _reply(self, code: int, obj: Dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _authorized(self) -> bool:
            """Shared-secret check; replies 401 itself on failure.
            Constant-time compare — a scoring token is still a secret."""
            if app.token is None:
                return True
            got = self.headers.get("Authorization", "")
            ok = got.startswith("Bearer ") and hmac.compare_digest(
                got[len("Bearer "):], app.token)
            if not ok:
                self._reply(401, {"v": WIRE_VERSION,
                                  "error": "missing or bad bearer token"})
            return ok

        def do_POST(self):
            if not self._authorized():
                return
            if urlparse(self.path).path != "/v1/submit":
                return self._reply(404, {"error": f"no route {self.path}"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n))
                bid, resumed = app.submit(payload)
            except (WireVersionError, TypeError, ValueError, KeyError,
                    AttributeError, NotImplementedError) as e:
                return self._reply(400, {"v": WIRE_VERSION,
                                         "error": f"{type(e).__name__}: {e}"})
            self._reply(200, {"v": WIRE_VERSION, "batch": bid,
                              "resumed": resumed})

        def do_GET(self):
            if not self._authorized():
                return
            u = urlparse(self.path)
            q = parse_qs(u.query)
            if u.path == "/v1/health":
                return self._reply(200, {"v": WIRE_VERSION, "ok": True})
            if u.path == "/v1/stats":
                return self._reply(200, {"v": WIRE_VERSION, **app.stats()})
            if u.path == "/v1/outcomes":
                bid = (q.get("batch") or [""])[0]
                batch = app.batch(bid)
                if batch is None:
                    # an evicted/unknown batch is recoverable: the client
                    # resubmits its content-keyed payload
                    return self._reply(404, {"v": WIRE_VERSION,
                                             "error": f"unknown batch {bid}"})
                after = int((q.get("after") or ["0"])[0])
                wait = min(float((q.get("wait") or ["0"])[0]),
                           app.poll_cap_s)
                outs, done, error = batch.read(after, wait)
                return self._reply(200, {"v": WIRE_VERSION, "outcomes": outs,
                                         "done": done, "error": error})
            self._reply(404, {"error": f"no route {self.path}"})

    return Handler


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.backends.server",
        description="Sweep scoring server: fronts a warm process-worker "
                    "pool and a shared WAL score cache over HTTP.")
    ap.add_argument("--db", required=True,
                    help="sqlite path of the shared score cache (WAL)")
    ap.add_argument("--workers", type=int, default=2,
                    help="process workers scoring a dry-run client's "
                         "unique programs (a wall-clock client's engine "
                         "has one, and its batches take turns on the "
                         "device)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8477)
    ap.add_argument("--allow-test-executors", action="store_true",
                    help="admit sleep/crash executor specs from clients "
                         "(fault-injection tests only, never in production)")
    ap.add_argument("--token", default=None,
                    help="shared-secret bearer token required on every "
                         "request (mandatory for non-loopback --host)")
    ap.add_argument("--batch-ttl-s", type=float, default=3600.0,
                    help="evict finished batches after this many seconds "
                         "(clients recover via resubmit-on-404)")
    ap.add_argument("--calibrate", action="store_true",
                    help="measure (or load) this host's card's "
                         "MachineProfile into the server DB's machine_cache "
                         "at startup and expose it in /v1/stats")
    args = ap.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    srv = SweepScoringServer(args.db, workers=args.workers, host=args.host,
                             port=args.port,
                             allow_test=args.allow_test_executors,
                             token=args.token, batch_ttl_s=args.batch_ttl_s,
                             calibrate=args.calibrate)
    url = srv.start()
    print(f"sweep scoring server listening on {url} "
          f"(db={args.db}, workers={args.workers})", flush=True)
    def _interrupt(signum, frame):
        raise KeyboardInterrupt

    # SIGTERM shuts down as Ctrl-C does: the workers are closed, not orphaned
    signal.signal(signal.SIGTERM, _interrupt)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()


if __name__ == "__main__":
    main()
