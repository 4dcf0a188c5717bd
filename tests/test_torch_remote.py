"""The port's remote scoring backend and sweep scoring server on the CPU.

Counterparts of the reference's ``tests/test_remote_backend.py``:
sequential and remote (loopback server) backends fuse byte-identical
plans (thread and process are held to sequential in
``test_torch_backends.py``); a second remote sweep against a warm server cache
scores nothing server-side; submits are idempotent (content-keyed
batches); a vanished batch is recovered by resubmission; an unreachable
server fails jobs as transient, and transient outcomes never enter the
score cache or mark an incumbent, across all four backends; the token and
the loopback-only bind; TTL eviction.  Beside them, the port's own
refusal: a wall-clock spec for a card this host lacks is HTTP 400 at
submit, never a score taken on the CPU; and the server's CLI.  The plans
are held to the port's sequential backend, which ``test_torch_sweep.py``
holds to the JAX package.
"""
import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from repro_torch.configs import arch_to_spec, get_arch, get_shape, \
    shape_to_spec
from repro_torch.core.backends import (WIRE_VERSION, JobGroup, JobSpec,
                                       ProcessBackend, Recorder,
                                       RemoteBackend, RetryPolicy,
                                       ThreadBackend, executor_to_spec,
                                       make_backend)
from repro_torch.core.backends.server import SweepScoringServer, batch_id
from repro_torch.core.combinator import Combination
from repro_torch.core.db import SweepDB
from repro_torch.core.executor import (CombinationFailed, CrashExecutor,
                                       DryRunExecutor)
from repro_torch.core.segment import fragment
from repro_torch.core.tuner import ComParTuner, SweepReport
from repro_torch.examples import compar_sweep_json
from repro_torch.models.context import SegmentClause

ROOT = Path(__file__).resolve().parents[1]
SPACE = {"remat": ("none", "full"), "kernel": ("plain",), "block_q": (16, 32),
         "block_k": (16,), "scan_unroll": (1,), "mlstm_chunk": (16,)}


def _plan_bytes(plan):
    d = plan.to_json()
    return json.dumps({"segments": d["segments"], "knobs": d["knobs"]},
                      sort_keys=True).encode()


def _cell():
    return get_arch("granite-8b").smoke(), get_shape("train_4k").smoke()


def _tuner(db, project, mode="new"):
    cfg, shape = _cell()
    return ComParTuner(cfg, shape, device="cpu", db=db, project=project,
                       mode=mode, executor="dryrun", timeout_s=120)


def _sweep(tuner, **kw):
    return tuner.sweep(providers=["tensor_par", "fsdp"], clause_space=SPACE,
                       max_flags=1, use_cache=False, **kw)


def _stats(url):
    with urllib.request.urlopen(url + "/v1/stats", timeout=10) as r:
        return json.loads(r.read())


def _dead_url():
    """A URL nothing listens on (bind a port, then release it)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"http://127.0.0.1:{port}"


def _stack_job(key, provider="fsdp", **kw):
    cfg, _ = _cell()
    seg = next(s for s in fragment(cfg) if s.kind == "stack")
    return JobSpec(key, seg, Combination(provider, frozenset(),
                                         SegmentClause()),
                   segments=(seg.name,), **kw)


@pytest.fixture(scope="module")
def reference():
    """The sequential sweep every remote sweep here must reproduce."""
    plan, rep = _sweep(_tuner(SweepDB(":memory:"), "ref-seq"),
                       backend="sequential")
    return _plan_bytes(plan), rep


@pytest.fixture
def server(tmp_path):
    srv = SweepScoringServer(str(tmp_path / "server.db"), workers=2)
    srv.start()
    yield srv
    srv.close()


# --- the acceptance invariant ----------------------------------------------------

def test_backend_equivalence_includes_remote_and_warm_server(server,
                                                            reference):
    """sequential == remote (loopback server), and a second remote sweep
    against the warm server cache scores nothing server-side."""
    ref, rep_ref = reference
    plan_r, rep_r = _sweep(_tuner(SweepDB(":memory:"), "eq-rem"),
                           backend="remote", remote_url=server.url)
    assert _plan_bytes(plan_r) == ref
    assert (rep_r.n_done, rep_r.n_failed, rep_r.n_scored, rep_r.n_shared) \
        == (rep_ref.n_done, 0, rep_ref.n_scored, rep_ref.n_shared)
    cold = _stats(server.url)
    assert cold["n_compiled"] == rep_ref.n_scored > 0

    # a fresh client (empty local DB) is served everything from the
    # server's score cache: zero new runs
    plan_w, rep_w = _sweep(_tuner(SweepDB(":memory:"), "eq-rem-warm"),
                           remote_url=server.url)     # url implies remote
    assert _plan_bytes(plan_w) == ref
    assert rep_w.n_scored == 0
    assert rep_w.n_cached == rep_w.n_combinations
    warm = _stats(server.url)
    assert warm["n_compiled"] == cold["n_compiled"], \
        "warm remote sweep scored server-side"
    assert warm["n_cache_hits"] > cold["n_cache_hits"]


def test_backend_options_bundle_carries_the_remote_fields(server,
                                                          reference):
    """``sweep(backend=BackendOptions(remote_url=...))`` is the bare kwarg's
    sweep; a bundle plus a non-default bare twin raises; the bundle's
    fields are the reference's."""
    from repro.core.tuner import BackendOptions as JBackendOptions
    from repro_torch.core.tuner import BackendOptions
    assert list(BackendOptions.__dataclass_fields__) == \
        list(JBackendOptions.__dataclass_fields__)
    plan, rep = _sweep(_tuner(SweepDB(":memory:"), "bo-rem"),
                       backend=BackendOptions(remote_url=server.url))
    assert _plan_bytes(plan) == reference[0] and rep.n_failed == 0
    with pytest.raises(ValueError, match="conflicts"):
        _sweep(_tuner(SweepDB(":memory:"), "bo-clash"),
               backend=BackendOptions(remote_url=server.url),
               fallback="thread")


# --- protocol contracts ----------------------------------------------------------

def _dry_init():
    cfg, shape = _cell()
    return {"executor": executor_to_spec(DryRunExecutor(timeout_s=60)),
            "arch": arch_to_spec(cfg), "shape": shape_to_spec(shape),
            "shape_key": "sk", "mesh_key": "mk"}


def _post(url, payload):
    req = urllib.request.Request(
        url + "/v1/submit", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def test_submit_is_idempotent_content_keyed(server):
    payload = {"v": WIRE_VERSION, "run": "fixed-nonce", "init": _dry_init(),
               "jobs": []}
    a = _post(server.url, payload)
    b = _post(server.url, payload)
    assert a["batch"] == b["batch"] == batch_id(payload)
    assert not a["resumed"] and b["resumed"]
    assert _stats(server.url)["n_batches"] == 1
    c = _post(server.url, {**payload, "run": "other-nonce"})
    assert c["batch"] != a["batch"] and not c["resumed"]


def test_wire_version_mismatch_rejected(server):
    cfg, shape = _cell()
    backend = RemoteBackend(DryRunExecutor(), cfg, shape,
                            url=server.url, retry_s=1.0)
    with pytest.raises(RuntimeError, match="HTTP 400"):
        backend._request("/v1/submit", {"v": 99, "init": _dry_init(),
                                        "jobs": []})


def test_server_rejects_test_executor_specs_from_the_wire(tmp_path, server):
    """``{"kind": "crash"}`` from a client would kill every worker:
    rejected at submit unless the server opted in."""
    bad = {"v": WIRE_VERSION, "run": "n1",
           "init": {**_dry_init(), "executor": {"kind": "crash"}},
           "jobs": []}
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server.url, bad)
    assert ei.value.code == 400
    trusting = SweepScoringServer(str(tmp_path / "trusting.db"),
                                  workers=1, allow_test=True)
    trusting.start()
    try:
        assert "batch" in _post(trusting.url, bad)   # empty batch: no spawn
    finally:
        trusting.close()


def test_submit_404_raises_not_transient(server):
    """A 404 on /v1/submit means the URL is not a scoring server: a
    protocol error that raises, never a sweep of transient failures."""
    cfg, shape = _cell()
    backend = RemoteBackend(DryRunExecutor(), cfg, shape,
                            url=server.url + "/api", retry_s=1.0)
    with pytest.raises(RuntimeError, match="HTTP 404"):
        list(backend.run([_stack_job("j")]))


def test_submit_validates_specs_eagerly(server):
    """Deterministic payload errors (registry skew, a malformed JobSpec)
    are HTTP 400 at submit."""
    good = _dry_init()
    bad_arch = {"v": WIRE_VERSION, "run": "n", "jobs": [],
                "init": {**good, "arch": {"name": "no-such-arch"}}}
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server.url, bad_arch)
    assert ei.value.code == 400
    bad_job = {"v": WIRE_VERSION, "run": "n", "init": good,
               "jobs": [{"key": "k"}]}
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server.url, bad_job)
    assert ei.value.code == 400


def test_submit_refuses_what_this_host_cannot_run(server):
    """A wall-clock spec for a card this host lacks, and a mesh, are HTTP
    400 at submit: never scored on the CPU, never a transient batch."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the test is for one without")
    cuda = {**_dry_init(), "executor": {
        "kind": "wallclock", "timeout_s": 60, "repeats": 5,
        "device": "cuda", "mesh": None}}
    for init, what in ((cuda, "DeviceUnsatisfiable"),
                       ({**_dry_init(), "executor": {
                           **_dry_init()["executor"],
                           "mesh": {"axes": [["data", 2]]}}},
                        "MeshUnsatisfiable")):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(server.url, {"v": WIRE_VERSION, "run": "n",
                               "init": init, "jobs": []})
        assert ei.value.code == 400
        assert what in ei.value.read().decode()
    job = _stack_job("m").to_json()
    job["mesh"] = {"axes": [["data", 2]]}
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server.url, {"v": WIRE_VERSION, "run": "n",
                           "init": _dry_init(), "jobs": [job]})
    assert ei.value.code == 400
    assert _stats(server.url)["n_compiled"] == 0


def test_backend_remote_requires_url():
    with pytest.raises(ValueError, match="remote_url"):
        _sweep(_tuner(SweepDB(":memory:"), "nourl"), backend="remote")
    cfg, shape = _cell()
    with pytest.raises(ValueError, match="remote_url"):
        make_backend("remote", DryRunExecutor(), cfg, shape)


def test_vanished_batch_is_resubmitted_and_served_from_cache(server):
    """The server forgets a batch mid-poll: the client resubmits its
    content-keyed payload and the replacement resolves from the cache."""
    cfg, shape = _cell()
    job = _stack_job("sig/ec", signature="sig", eff_cid="ec")
    backend = RemoteBackend(DryRunExecutor(timeout_s=120), cfg, shape,
                            url=server.url, shape_key="sk", mesh_key="mk",
                            poll_s=0.2, retry_s=10.0)
    submits = []
    orig_submit = backend._submit

    def evicting_submit(payload):
        bid = orig_submit(payload)
        submits.append(bid)
        if len(submits) == 1 and bid is not None:
            batch = server.batch(bid)
            deadline = time.monotonic() + 120
            while not batch.done and time.monotonic() < deadline:
                time.sleep(0.02)
            assert batch.done, "first batch never finished server-side"
            with server._lock:
                del server._batches[bid]
        return bid

    backend._submit = evicting_submit
    outs = list(backend.run([job]))
    assert len(submits) == 2 and submits[0] == submits[1]
    assert [o.status for o in outs] == ["done"]
    assert outs[0].cached
    assert _stats(server.url)["n_compiled"] == 1


def _sleep_batches(srv, log, device, n_clients=2, n_jobs=3):
    """``n_clients`` clients, each with its own sleep config (a distinct
    engine), submit ``n_jobs`` jobs at once; returns the logged (start,
    end) of every job, sorted, once every batch is done."""
    cfg, shape = _cell()
    bids = []
    for c in range(n_clients):
        init = {"executor": {"kind": "sleep", "sleep_s": 0.3 + 0.01 * c,
                             "timeout_s": None, "device": device,
                             "log": str(log)},
                "arch": arch_to_spec(cfg), "shape": shape_to_spec(shape),
                "shape_key": "sk", "mesh_key": "mk"}
        jobs = [_stack_job(f"c{c}j{j}").to_json() for j in range(n_jobs)]
        bids.append(_post(srv.url, {"v": WIRE_VERSION, "run": f"c{c}",
                                    "init": init, "jobs": jobs})["batch"])
    deadline = time.monotonic() + 120
    while not all(srv.batch(b).done for b in bids):
        assert time.monotonic() < deadline, "batches never finished"
        time.sleep(0.05)
    for b in bids:
        assert [o["status"] for o in srv.batch(b).outcomes] == \
            ["done"] * n_jobs
    spans = sorted(tuple(map(float, line.split()))
                   for line in log.read_text().splitlines())
    assert len(spans) == n_clients * n_jobs
    return spans


def test_server_times_one_wall_clock_program_per_device(tmp_path):
    """A timing executor (not ``parallel_safe``) gets one worker, and two
    clients with different configs take turns on its device: no two
    programs are ever in flight at once, though the server has 2 workers.
    A departure from the reference's server, which times them together."""
    srv = SweepScoringServer(str(tmp_path / "s.db"), workers=2,
                             allow_test=True)
    srv.start()
    try:
        spans = _sleep_batches(srv, tmp_path / "wall.log", device="cpu")
        assert all(e.workers == 1 for e, _, _ in srv._engines.values())
    finally:
        srv.close()
    for (_, end), (start, _) in zip(spans, spans[1:]):
        assert start >= end, spans


def test_server_runs_dry_run_batches_in_parallel(tmp_path):
    """A parallel-safe executor keeps the server's workers and its batches
    overlap: the per-device lock holds timing executors only."""
    srv = SweepScoringServer(str(tmp_path / "s.db"), workers=2,
                             allow_test=True)
    srv.start()
    try:
        spans = _sleep_batches(srv, tmp_path / "dry.log", device=None)
        assert all(e.workers == 2 and lock is None
                   for e, _, lock in srv._engines.values())
    finally:
        srv.close()
    assert any(start < end for (_, end), (start, _) in zip(spans, spans[1:]))


def test_unreachable_server_fails_jobs_transient():
    cfg, shape = _cell()
    backend = RemoteBackend(DryRunExecutor(), cfg, shape,
                            url=_dead_url(), retry_s=0.3, backoff_s=0.05)
    outs = list(backend.run([_stack_job("a"), _stack_job("b")]))
    assert len(outs) == 2
    assert all(o.status == "failed" and o.transient for o in outs)
    assert all("unreachable" in o.error and o.kind == "unreachable"
               for o in outs)


# --- the transient cache policy, across all four backends ------------------------

class _TransientExecutor:
    """Raises a transient CombinationFailed for every job (the in-process
    stand-in for a deadline overrun)."""
    parallel_safe = True
    timeout_s = None
    cache_tag = "transient-test"
    n_chips = 1

    def score_segment(self, cfg, shape, seg, combo, knobs=None):
        raise CombinationFailed("synthetic deadline overrun", transient=True)


def _drive_policy(backend, jobs, db, tracker):
    groups = {}
    for job in jobs:
        db.register("p", job.seg.name, job.combo)
        groups[job.key] = JobGroup(
            job.seg, job.combo, job.signature, job.eff_cid,
            members=[(job.seg.name, job.combo.cid)])
    rep = SweepReport("p", n_combinations=len(jobs))
    rec = Recorder(db, "p", rep, shape_key="sk", mesh_key="mk",
                   use_cache=True)
    outs = []
    for out in backend.run(jobs):
        outs.append(out)
        rec.outcome(groups[out.key], out)
    rec.flush()
    assert len(outs) == len(jobs)
    assert all(o.status == "failed" and o.transient for o in outs)
    assert rep.n_transient == len(jobs)
    assert db.cache_size() == 0, "transient outcome leaked into score_cache"
    assert tracker._best == {}, "transient outcome marked an incumbent"
    assert all(r["status"] == "failed" for r in db.results("p"))


@pytest.mark.parametrize("backend_name", ["sequential", "thread", "process",
                                          "remote"])
def test_transient_outcomes_never_cached_never_incumbent(backend_name,
                                                         tmp_path):
    """Transient failures (deadline overrun, worker crash double-loss,
    remote connection loss) are recorded failed, never enter
    ``score_cache`` and never tighten an incumbent."""
    cfg, shape = _cell()
    jobs = [_stack_job(f"sig{i}/ec", provider, signature=f"sig{i}",
                       eff_cid="ec")
            for i, provider in enumerate(("fsdp", "tensor_par"))]
    db = SweepDB(str(tmp_path / f"{backend_name}.db"))
    db.open_project("p", "new")
    if backend_name in ("sequential", "thread"):
        backend = ThreadBackend(_TransientExecutor(), cfg, shape,
                                workers=1 if backend_name == "sequential"
                                else 2)
        tracker = backend.runner.tracker
    elif backend_name == "process":
        backend = ProcessBackend(CrashExecutor(), cfg, shape, workers=1,
                                 timeout_s=60)
        tracker = backend.tracker
    else:
        backend = RemoteBackend(DryRunExecutor(), cfg, shape,
                                url=_dead_url(), retry_s=0.3,
                                backoff_s=0.05)
        tracker = backend.tracker
    try:
        _drive_policy(backend, jobs, db, tracker)
        if backend_name in ("process", "remote"):
            assert backend.tracker._best == {}
    finally:
        backend.close()


# --- shared-secret auth, the bind guard, TTL eviction ----------------------------

def test_token_auth_required_and_never_retried(tmp_path):
    """A --token server 401s requests without (or with the wrong) bearer
    token; the client raises at once, with no retry budget burned."""
    srv = SweepScoringServer(str(tmp_path / "auth.db"), workers=1,
                             token="s3cret")
    srv.start()
    try:
        cfg, shape = _cell()

        def client(token):
            return RemoteBackend(DryRunExecutor(), cfg, shape, url=srv.url,
                                 token=token,
                                 retry=RetryPolicy(budget_s=30.0,
                                                   base_s=1.0))
        for bad in (None, "wrong"):
            t0 = time.monotonic()
            with pytest.raises(RuntimeError, match="HTTP 401"):
                client(bad)._request("/v1/health", timeout=5.0)
            assert time.monotonic() - t0 < 5.0, "401 burned the retry budget"
        assert client("s3cret")._request("/v1/health",
                                         timeout=5.0)["ok"] is True
    finally:
        srv.close()


def test_token_auth_sweep_end_to_end(tmp_path, reference):
    """remote_token= flows tuner -> make_backend -> Authorization header;
    the authed sweep matches the sequential plan byte for byte."""
    srv = SweepScoringServer(str(tmp_path / "auth-e2e.db"), workers=2,
                             token="s3cret")
    srv.start()
    try:
        plan, rep = _sweep(_tuner(SweepDB(":memory:"), "auth-e2e"),
                           remote_url=srv.url, remote_token="s3cret")
        assert _plan_bytes(plan) == reference[0]
        assert rep.n_failed == 0
    finally:
        srv.close()


def test_non_loopback_bind_refused_without_token(tmp_path):
    with pytest.raises(ValueError, match="token"):
        SweepScoringServer(str(tmp_path / "open.db"), host="0.0.0.0")
    srv = SweepScoringServer(str(tmp_path / "tok.db"), host="127.0.0.1")
    srv.close()     # loopback without token: fine (never started)


def test_finished_batches_ttl_evicted(tmp_path):
    """Completed batches are TTL-swept (counted in /v1/stats); an evicted
    batch polls as 404, which the client recovers from by resubmitting."""
    srv = SweepScoringServer(str(tmp_path / "ttl.db"), workers=1,
                             batch_ttl_s=0.05)
    srv.start()
    try:
        payload = {"v": WIRE_VERSION, "run": "ttl-nonce",
                   "init": _dry_init(), "jobs": []}
        bid = _post(srv.url, payload)["batch"]
        with urllib.request.urlopen(
                srv.url + f"/v1/outcomes?batch={bid}&after=0&wait=10",
                timeout=30) as r:
            assert json.loads(r.read())["done"]
        time.sleep(0.1)                       # let the TTL lapse
        stats = _stats(srv.url)               # stats sweeps eviction
        assert stats["n_evicted"] >= 1
        assert stats["n_batches"] == 0
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(
                srv.url + f"/v1/outcomes?batch={bid}&after=0&wait=0",
                timeout=10)
        assert ei.value.code == 404
    finally:
        srv.close()


def test_server_cli_serves_a_sweep(tmp_path, reference):
    """``python -m repro_torch.core.backends.server`` on a free loopback
    port: health, then a client sweep fusing the sequential plan."""
    port = int(_dead_url().rsplit(":", 1)[1])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.core.backends.server",
         "--db", str(tmp_path / "cli.db"), "--workers", "1",
         "--port", str(port)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    url = f"http://127.0.0.1:{port}"
    try:
        assert "listening on" in proc.stdout.readline()
        plan, rep = _sweep(_tuner(SweepDB(":memory:"), "cli"),
                           remote_url=url)
        assert _plan_bytes(plan) == reference[0]
        assert rep.n_failed == 0 and _stats(url)["n_compiled"] > 0
    finally:
        proc.terminate()
        proc.wait(timeout=30)


# --- the example ------------------------------------------------------------------

EXAMPLE_ARGV = ["--smoke", "--device", "cpu", "--backend", "thread"]


@pytest.fixture(scope="module")
def example_thread(tmp_path_factory):
    """The example's thread-backend run, shared by both cases."""
    import tempfile
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tempfile, "tempdir",
                   str(tmp_path_factory.mktemp("example")))
        return compar_sweep_json.main(EXAMPLE_ARGV)


@pytest.mark.parametrize("backend", ["thread", "remote"])
def test_compar_sweep_json_runs_on_the_cpu(tmp_path, monkeypatch,
                                           example_thread, backend):
    """The reference's example at smoke size: the JSON spec's "globals"
    as the knob axis, a Continue run that scores nothing, a clean lint
    and the saved plan; ``--remote-url`` through a loopback server fuses
    the same plan.  ``--mesh-space`` raises naming item 4."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    ref = example_thread
    assert ref["report"].n_knob_points == 2
    assert ref["report"].n_done == ref["report"].n_combinations
    assert ref["report2"].n_scored == 0
    assert Path(ref["plan_path"]).exists()
    if backend == "remote":
        srv = SweepScoringServer(str(tmp_path / "srv.db"), workers=1)
        srv.start()
        try:
            out = compar_sweep_json.main(
                ["--smoke", "--device", "cpu", "--remote-url", srv.url])
        finally:
            srv.close()
        assert _plan_bytes(out["plan2"]) == _plan_bytes(ref["plan2"])
        assert out["report"].n_scored == srv.stats()["n_compiled"] > 0
    # the topology axis: local against a world-size-1 data ring, made
    # and destroyed by the example
    out = compar_sweep_json.main(EXAMPLE_ARGV + ["--mesh-space"])
    assert out["report"].n_mesh_points == 2
    assert out["plan2"].mesh == out["plan"].mesh is not None
