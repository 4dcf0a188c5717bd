"""Deterministic fault injection for the scoring pipeline, as the
reference's ``src/repro/core/backends/faults.py`` (stdlib only).

The failure contracts of ``remote.py`` / ``process.py`` / ``server.py``
("an unreachable server is transient", "a killed worker requeues once",
"a restart mid-batch is recovered by resubmission") are only worth the
docstrings they are written in if every one of them is *executable*.
This module makes them so, in two layers driven by one seeded plan:

* :class:`FaultPlan` — a reproducible schedule of faults.  Each named
  *injection point* ("proxy:/v1/submit", "process.kill_worker",
  "recorder.flush") counts its events; rules fire on explicit indices
  (``at=``), periodically (``every=``), or on a seeded pseudo-random
  fraction (``rate=``) whose decisions are a pure function of
  ``(seed, point, event index)`` — the same plan replays the same
  faults, run after run, host after host.
* :class:`ChaosProxy` — a stdlib HTTP proxy that sits between a
  :class:`~repro_torch.core.backends.remote.RemoteBackend` and the scoring
  server and, per request, can drop the connection, delay past the
  client's timeout, reply 5xx, truncate the body mid-reply, or corrupt
  the JSON — every wire-level failure mode the client's retry loop
  claims to survive.  An unreachable upstream (the server restarting
  under it) is surfaced as HTTP 502, which the client treats as
  transient.

In-process points are consumed by the pipeline itself when handed a
plan: ``ProcessBackend(fault_plan=...)`` kills the worker holding the
Nth dispatched job ("process.kill_worker"), and
``Recorder(fault_plan=...)`` raises out of the Nth flush
("recorder.flush").  Production code paths pay one ``is None`` check.

The invariant the chaos suite (``tests/test_torch_remote.py``) drives with
these tools: under ANY fault schedule the sweep terminates, the fused
plan is byte-identical to the fault-free sequential baseline whenever
all jobs eventually score, and no injected failure ever writes a
``score_cache`` row.
"""
from __future__ import annotations

import hashlib
import json
import logging
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple

log = logging.getLogger("repro_torch.backends.faults")

# --- fault kinds -------------------------------------------------------------
#: wire-level kinds, applied by the ChaosProxy
DROP = "drop"            # close the connection without any reply
DELAY = "delay"          # sleep ``delay_s`` before forwarding
ERROR = "error"          # reply HTTP ``status`` (default 500) instead
TRUNCATE = "truncate"    # declare the full Content-Length, send half, close
CORRUPT = "corrupt"      # reply 200 with a non-JSON body
#: in-process kinds, applied at pipeline injection points
KILL = "kill"            # kill the process-backend worker holding the job
RAISE = "raise"          # raise RuntimeError at the injection point
KINDS = (DROP, DELAY, ERROR, TRUNCATE, CORRUPT, KILL, RAISE)


@dataclass(frozen=True)
class FaultRule:
    """One fault trigger at one injection point.

    Fires when the point's 1-based event counter matches any explicit
    ``at`` index, is a multiple of ``every``, or falls under the seeded
    pseudo-random ``rate`` (deterministic per (plan seed, point, event));
    ``limit`` caps total firings (0 = unlimited)."""
    kind: str
    at: Tuple[int, ...] = ()
    every: int = 0
    rate: float = 0.0
    limit: int = 0
    delay_s: float = 0.0
    status: int = 500


class FaultPlan:
    """A seeded, thread-safe, replayable schedule of faults.

    ``rules`` maps injection-point names to rule sequences.  Every call
    to :meth:`fires` counts one event at that point and returns the
    first rule that triggers (or ``None``); each firing is appended to
    :attr:`events` as ``(point, event index, kind)`` so tests can assert
    the schedule actually executed.
    """

    def __init__(self, rules: Dict[str, Sequence[FaultRule]], *,
                 seed: int = 0):
        self.seed = seed
        self.rules = {p: tuple(rs) for p, rs in rules.items()}
        self._lock = threading.Lock()
        self._n: Dict[str, int] = {}
        self._fired: Dict[Tuple[str, int], int] = {}
        self.events: List[Tuple[str, int, str]] = []

    def fires(self, point: str) -> Optional[FaultRule]:
        """Count one event at ``point``; return the triggered rule."""
        with self._lock:
            n = self._n.get(point, 0) + 1
            self._n[point] = n
            for i, rule in enumerate(self.rules.get(point, ())):
                fired = self._fired.get((point, i), 0)
                if rule.limit and fired >= rule.limit:
                    continue
                if self._matches(rule, point, n, i):
                    self._fired[(point, i)] = fired + 1
                    self.events.append((point, n, rule.kind))
                    return rule
        return None

    def _matches(self, rule: FaultRule, point: str, n: int, i: int) -> bool:
        if n in rule.at:
            return True
        if rule.every and n % rule.every == 0:
            return True
        if rule.rate:
            blob = f"{self.seed}:{point}:{i}:{n}".encode()
            h = hashlib.sha256(blob).digest()
            return int.from_bytes(h[:8], "big") / 2.0 ** 64 < rule.rate
        return False

    def reset(self):
        """Rewind every counter so the same schedule replays."""
        with self._lock:
            self._n = {}
            self._fired = {}
            self.events = []


# --- the chaos HTTP proxy ----------------------------------------------------

#: body served for CORRUPT replies — bytes that can never decode as JSON
_GARBAGE = b'\xff\xfe{"chaos": not json'


class ChaosProxy:
    """A fault-injecting HTTP proxy in front of a scoring server.

    Forwards every request to ``upstream`` verbatim (method, path,
    query, body, Content-Type/Authorization headers) unless the plan
    fires for the request's injection point.  Two points are consulted
    per request, each with its own counter: the route-specific
    ``"proxy:<path>"`` (e.g. ``"proxy:/v1/submit"``) first, then the
    catch-all ``"proxy"``.

    ``retarget`` repoints the proxy at a different upstream — the chaos
    suite uses it to restart the scoring server mid-batch while the
    client keeps one stable URL.
    """

    def __init__(self, upstream: str, plan: Optional[FaultPlan] = None, *,
                 host: str = "127.0.0.1", port: int = 0,
                 upstream_timeout_s: float = 90.0):
        self.plan = plan if plan is not None else FaultPlan({})
        self.upstream = upstream.rstrip("/")
        self.upstream_timeout_s = upstream_timeout_s
        self._httpd = ThreadingHTTPServer((host, port),
                                          _make_proxy_handler(self))
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> str:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        log.info("chaos proxy %s -> %s", self.url, self.upstream)
        return self.url

    def retarget(self, upstream: str):
        self.upstream = upstream.rstrip("/")

    def close(self):
        # shutdown() only when serve_forever is live — it blocks forever
        # on a never-started server
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5)
            self._thread = None
        self._httpd.server_close()

    # ------------------------------------------------------------------
    def forward(self, method: str, path: str, body: Optional[bytes],
                headers: Dict[str, str]) -> Tuple[int, bytes]:
        """One upstream exchange; an unreachable upstream becomes a 502
        (the retryable verdict a real reverse proxy would give)."""
        req = urllib.request.Request(self.upstream + path, data=body,
                                     headers=headers, method=method)
        try:
            with urllib.request.urlopen(
                    req, timeout=self.upstream_timeout_s) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()
        except (urllib.error.URLError, ConnectionError, OSError) as e:
            return 502, json.dumps(
                {"error": f"upstream {self.upstream} unreachable: {e}"}
            ).encode()


def _make_proxy_handler(app: ChaosProxy):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            log.debug("%s - %s", self.address_string(), fmt % args)

        def do_GET(self):
            self._serve("GET")

        def do_POST(self):
            self._serve("POST")

        def _serve(self, method: str):
            route = self.path.split("?", 1)[0]
            rule = app.plan.fires(f"proxy:{route}") or app.plan.fires("proxy")
            if rule is not None and rule.kind == DROP:
                # no reply at all: the client sees the connection die
                self.close_connection = True
                return
            if rule is not None and rule.kind == DELAY:
                time.sleep(rule.delay_s)
            if rule is not None and rule.kind == ERROR:
                return self._reply(rule.status, json.dumps(
                    {"error": f"injected HTTP {rule.status}"}).encode())
            body = None
            if method == "POST":
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
            headers = {h: self.headers[h]
                       for h in ("Content-Type", "Authorization")
                       if self.headers.get(h)}
            code, payload = app.forward(method, self.path, body, headers)
            if rule is not None and rule.kind == CORRUPT:
                payload = _GARBAGE
            if rule is not None and rule.kind == TRUNCATE:
                # full Content-Length, half the bytes: the client's read
                # raises IncompleteRead — retryable, like any torn reply
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload[:max(1, len(payload) // 2)])
                self.wfile.flush()
                self.close_connection = True
                return
            self._reply(code, payload)

        def _reply(self, code: int, payload: bytes):
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

    return Handler
