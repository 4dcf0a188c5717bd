"""The port's fault injection on the CPU: counterparts of the reference's
``tests/test_faults.py``.

Under any deterministic ``FaultPlan`` schedule (submit-time outages,
corrupt or truncated replies, 5xx storms, a server restart mid-batch,
worker kills, a crashing recorder flush) the sweep terminates, the fused
plan is byte-identical to the fault-free sequential baseline whenever all
jobs eventually score, transients are retried in-sweep up to the budget,
and no injected failure writes a ``score_cache`` row.  The baseline is the
port's sequential backend, which ``test_torch_sweep.py`` holds to the JAX
package.  Smoke configs and the dry run.
"""
import json
import random
import socket
import threading
import time

import pytest

from repro_torch.configs import get_arch, get_shape
from repro_torch.core.backends import (DONE, FAILED, FallbackBackend,
                                       JobGroup, JobOutcome, JobSpec,
                                       Recorder, RemoteBackend, RetryPolicy,
                                       ThreadBackend, make_backend)
from repro_torch.core.backends.faults import (CORRUPT, DELAY, DROP, ERROR,
                                              KILL, RAISE, TRUNCATE,
                                              ChaosProxy, FaultPlan,
                                              FaultRule)
from repro_torch.core.backends.process import ProcessBackend
from repro_torch.core.backends.server import SweepScoringServer
from repro_torch.core.combinator import Combination
from repro_torch.core.db import SweepDB
from repro_torch.core.executor import CombinationFailed, DryRunExecutor
from repro_torch.core.segment import fragment
from repro_torch.core.tuner import ComParTuner, SweepReport
from repro_torch.examples import train_e2e
from repro_torch.models.context import SegmentClause

SPACE = {"remat": ("none", "full"), "kernel": ("plain",), "block_q": (16, 32),
         "block_k": (16,), "scan_unroll": (1,), "mlstm_chunk": (16,)}

#: fast, bounded recovery: the sweep must end quickly even when a
#: schedule burns the whole budget
POLICY = RetryPolicy(budget_s=15.0, base_s=0.05, cap_s=0.25)


def _plan_bytes(plan):
    d = plan.to_json()
    return json.dumps({"segments": d["segments"], "knobs": d["knobs"]},
                      sort_keys=True).encode()


def _cell():
    return get_arch("granite-8b").smoke(), get_shape("train_4k").smoke()


def _tuner(db, project):
    cfg, shape = _cell()
    return ComParTuner(cfg, shape, device="cpu", db=db, project=project,
                       mode="new", executor="dryrun", timeout_s=120)


def _sweep(tuner, **kw):
    return tuner.sweep(providers=["tensor_par", "fsdp"], clause_space=SPACE,
                       max_flags=1, use_cache=False, **kw)


def _dead_url():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"http://127.0.0.1:{port}"


@pytest.fixture(scope="module")
def baseline():
    """The fault-free sequential plan every chaos sweep must reproduce."""
    plan, rep = _sweep(_tuner(SweepDB(":memory:"), "chaos-base"),
                       backend="sequential")
    return _plan_bytes(plan), rep


# --- FaultPlan: the deterministic schedule ---------------------------------------

def test_fault_plan_at_every_limit_semantics():
    plan = FaultPlan({"p": [FaultRule(DROP, at=(2,)),
                            FaultRule(ERROR, every=3, limit=1)]})
    kinds = [(r.kind if r else None) for r in (plan.fires("p")
                                               for _ in range(9))]
    assert kinds == [None, DROP, ERROR, None, None, None, None, None, None]
    assert plan.events == [("p", 2, DROP), ("p", 3, ERROR)]
    plan.reset()
    assert plan.fires("p") is None and plan.fires("p").kind == DROP


def test_fault_plan_points_count_independently():
    plan = FaultPlan({"a": [FaultRule(DROP, at=(1,))],
                      "b": [FaultRule(ERROR, at=(2,))]})
    assert plan.fires("a").kind == DROP
    assert plan.fires("b") is None
    assert plan.fires("b").kind == ERROR


def test_fault_plan_rate_is_seed_deterministic():
    def draw(seed):
        p = FaultPlan({"p": [FaultRule(DROP, rate=0.5)]}, seed=seed)
        return [p.fires("p") is not None for _ in range(64)]

    a, b = draw(7), draw(7)
    assert a == b, "same seed must replay the same schedule"
    assert a != draw(8), "a different seed should (overwhelmingly) differ"
    assert 8 < sum(a) < 56, "rate=0.5 should fire a middling fraction"


def test_retry_policy_backoff_is_jittered_and_capped():
    pol = RetryPolicy(base_s=0.1, cap_s=0.4, jitter=0.5)
    pauses = [pol.pause_s(a, rng=random.Random(3)) for a in range(6)]
    assert all(0.0 < p <= 0.4 for p in pauses)
    assert pol.pause_s(10) <= 0.4
    flat = RetryPolicy(base_s=0.1, cap_s=0.4, jitter=0.0)
    assert [flat.pause_s(a) for a in range(4)] == [0.1, 0.2, 0.4, 0.4]
    r1, r2 = random.Random(1), random.Random(2)
    assert pol.pause_s(2, rng=r1) != pol.pause_s(2, rng=r2)


# --- the client retry loop, per wire-level fault kind ----------------------------

@pytest.fixture
def server(tmp_path):
    srv = SweepScoringServer(str(tmp_path / "server.db"), workers=2)
    srv.start()
    yield srv
    srv.close()


def _proxy_backend(proxy, **kw):
    cfg, shape = _cell()
    return RemoteBackend(DryRunExecutor(), cfg, shape, url=proxy.url,
                         retry=kw.pop("retry", RetryPolicy(
                             budget_s=5.0, base_s=0.01, cap_s=0.05)), **kw)


@pytest.mark.parametrize("rule", [
    FaultRule(ERROR, at=(1,), status=500),
    FaultRule(ERROR, at=(1,), status=503),
    FaultRule(TRUNCATE, at=(1,)),
    FaultRule(CORRUPT, at=(1,)),
    FaultRule(DROP, at=(1,)),
], ids=["http-500", "http-503", "truncated-reply", "corrupt-json",
        "dropped-conn"])
def test_request_retries_every_torn_reply_kind(server, rule):
    """One request of each failure kind, then a clean one: ``_request``
    absorbs the fault inside its budget."""
    plan = FaultPlan({"proxy:/v1/health": [rule]})
    proxy = ChaosProxy(server.url, plan)
    proxy.start()
    try:
        resp = _proxy_backend(proxy)._request("/v1/health", timeout=5.0)
        assert resp.get("ok") is True
        assert plan.events and plan.events[0][2] == rule.kind
    finally:
        proxy.close()


def test_request_retries_delay_past_timeout(server):
    plan = FaultPlan({"proxy:/v1/health": [FaultRule(DELAY, at=(1,),
                                                     delay_s=1.0)]})
    proxy = ChaosProxy(server.url, plan)
    proxy.start()
    try:
        assert _proxy_backend(proxy)._request(
            "/v1/health", timeout=0.2).get("ok") is True
    finally:
        proxy.close()


def test_request_gives_up_past_budget_not_forever(server):
    plan = FaultPlan({"proxy": [FaultRule(ERROR, every=1)]})   # always 5xx
    proxy = ChaosProxy(server.url, plan)
    proxy.start()
    try:
        backend = _proxy_backend(proxy, retry=RetryPolicy(
            budget_s=0.3, base_s=0.01, cap_s=0.05))
        t0 = time.monotonic()
        assert backend._request("/v1/health", timeout=5.0) is None
        assert time.monotonic() - t0 < 5.0
    finally:
        proxy.close()


# --- the chaos matrix: full sweeps under wire-fault schedules --------------------

MATRIX = {
    "passthrough": lambda: FaultPlan({}),
    "submit-outage": lambda: FaultPlan(
        {"proxy:/v1/submit": [FaultRule(DROP, at=(1, 2))]}),
    "corrupt-replies": lambda: FaultPlan(
        {"proxy": [FaultRule(CORRUPT, every=3, limit=4)]}),
    "truncated-replies": lambda: FaultPlan(
        {"proxy": [FaultRule(TRUNCATE, at=(2, 4))]}),
    "server-5xx": lambda: FaultPlan(
        {"proxy": [FaultRule(ERROR, every=2, limit=5, status=502)]}),
    "seeded-mixed": lambda: FaultPlan(
        {"proxy": [FaultRule(DROP, rate=0.2), FaultRule(ERROR, rate=0.2)]},
        seed=7),
}


@pytest.mark.parametrize("schedule", sorted(MATRIX), ids=sorted(MATRIX))
def test_chaos_matrix_sweep_is_byte_identical(tmp_path, baseline, schedule):
    """A full remote sweep through a faulty wire: the plan comes out
    byte-identical to the sequential baseline, with zero failed rows and
    no poisoned score_cache entry."""
    ref_bytes, ref_rep = baseline
    plan_fp = MATRIX[schedule]()
    srv = SweepScoringServer(str(tmp_path / "srv.db"), workers=2)
    srv.start()
    proxy = ChaosProxy(srv.url, plan_fp)
    proxy.start()
    try:
        plan, rep = _sweep(_tuner(SweepDB(":memory:"), f"chaos-{schedule}"),
                           remote_url=proxy.url, retry=POLICY)
    finally:
        proxy.close()
        srv.close()
    assert _plan_bytes(plan) == ref_bytes
    assert rep.n_failed == 0 and rep.n_transient == 0
    assert srv.db.cache_size() == ref_rep.n_scored
    if schedule != "passthrough":
        assert plan_fp.events, "schedule never fired: the test is vacuous"


def test_server_restart_mid_batch_recovers_byte_identical(tmp_path, baseline):
    """The server dies after its first scored program and a fresh one
    takes over the same DB behind the same proxy URL: resubmit-on-404 and
    the in-sweep retry round carry the client to the baseline plan."""
    ref_bytes, ref_rep = baseline
    db_path = str(tmp_path / "srv.db")
    srv1 = SweepScoringServer(db_path, workers=2)
    srv1.start()
    proxy = ChaosProxy(srv1.url)
    proxy.start()
    srv2_box = {}

    def restart():
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            with srv1._lock:
                if srv1.n_compiled >= 1:
                    break
            time.sleep(0.01)
        srv1.close()
        srv2 = SweepScoringServer(db_path, workers=2)
        srv2.start()
        srv2_box["srv"] = srv2
        proxy.retarget(srv2.url)

    t = threading.Thread(target=restart, daemon=True)
    t.start()
    try:
        plan, rep = _sweep(_tuner(SweepDB(":memory:"), "chaos-restart"),
                           remote_url=proxy.url, retry=POLICY)
        t.join(timeout=120)
        assert "srv" in srv2_box, "server restart never happened"
        assert _plan_bytes(plan) == ref_bytes
        assert rep.n_failed == 0 and rep.n_transient == 0
        assert srv2_box["srv"].db.cache_size() == ref_rep.n_scored
        assert srv2_box["srv"].stats()["n_batches"] >= 1
    finally:
        proxy.close()
        if "srv" in srv2_box:
            srv2_box["srv"].close()
        srv1.close()


# --- process backend: seeded worker kills ----------------------------------------

def _stack_jobs(n=2):
    cfg, _ = _cell()
    seg = next(s for s in fragment(cfg) if s.kind == "stack")
    return [JobSpec(f"j{i}", seg, Combination(provider, frozenset(),
                                              SegmentClause()),
                    segments=(seg.name,))
            for i, provider in enumerate(("fsdp", "tensor_par")[:n])]


def test_process_worker_kill_requeues_and_completes():
    """The worker holding the first dispatched job is terminated: the job
    requeues onto another worker and everything scores."""
    cfg, shape = _cell()
    plan = FaultPlan({"process.kill_worker": [FaultRule(KILL, at=(1,))]})
    backend = ProcessBackend(DryRunExecutor(timeout_s=120), cfg, shape,
                             workers=2, fault_plan=plan)
    try:
        outs = list(backend.run(_stack_jobs()))
    finally:
        backend.close()
    assert sorted(o.key for o in outs) == ["j0", "j1"]
    assert all(o.status == "done" for o in outs)
    assert plan.events == [("process.kill_worker", 1, KILL)]
    assert max(o.attempts for o in outs) == 2


def test_process_worker_kill_every_dispatch_fails_transient_kind_crash():
    """Every dispatch killed: the job burns max_attempts and comes back
    transient, kind "crash", and the run ends instead of respawning
    forever."""
    cfg, shape = _cell()
    plan = FaultPlan({"process.kill_worker": [FaultRule(KILL, every=1)]})
    backend = ProcessBackend(DryRunExecutor(timeout_s=120), cfg, shape,
                             workers=2, retry=RetryPolicy(max_attempts=2),
                             fault_plan=plan)
    try:
        outs = list(backend.run(_stack_jobs(n=1)))
    finally:
        backend.close()
    assert len(outs) == 1
    out = outs[0]
    assert out.status == "failed" and out.transient
    assert out.kind == "crash" and out.attempts == 2


# --- graceful degradation: FallbackBackend ---------------------------------------

def test_fallback_rescues_unreachable_server_in_same_run(baseline):
    """Remote down for the whole sweep: every job is re-scored locally in
    the same run, the plan matches the baseline, and the degradation is
    accounted."""
    ref_bytes, _ = baseline
    plan, rep = _sweep(_tuner(SweepDB(":memory:"), "chaos-fallback"),
                       remote_url=_dead_url(), fallback="thread",
                       retry=RetryPolicy(budget_s=0.3, base_s=0.05,
                                         cap_s=0.1))
    assert _plan_bytes(plan) == ref_bytes
    assert rep.n_failed == 0 and rep.n_transient == 0
    assert rep.n_fallback_local == rep.n_combinations > 0
    assert "fallback_local" in rep.summary()


def test_fallback_to_process_rescues_unreachable_server(baseline):
    """The same with the process backend as the local one."""
    ref_bytes, _ = baseline
    with _tuner(SweepDB(":memory:"), "chaos-fallback-prc") as tuner:
        plan, rep = _sweep(tuner, remote_url=_dead_url(),
                           fallback="process", workers=2,
                           retry=RetryPolicy(budget_s=0.3, base_s=0.05,
                                             cap_s=0.1))
    assert _plan_bytes(plan) == ref_bytes
    assert rep.n_failed == 0
    assert rep.n_fallback_local == rep.n_combinations > 0


def test_fallback_requires_remote_backend():
    with pytest.raises(ValueError, match="fallback"):
        _sweep(_tuner(SweepDB(":memory:"), "chaos-nofb"),
               backend="thread", fallback="thread")


def test_fallback_refuses_remote_as_local():
    cfg, shape = _cell()
    with pytest.raises(ValueError, match="LOCAL"):
        make_backend("remote", DryRunExecutor(), cfg, shape,
                     remote_url=_dead_url(), fallback="remote")


def test_fallback_passes_protocol_errors_through():
    """Fallback absorbs outages, never bugs: a primary that raises must
    propagate, not degrade to local scoring."""
    cfg, shape = _cell()

    class Raising(ThreadBackend):
        def run(self, jobs, incumbents=None):
            raise RuntimeError("HTTP 400 protocol error")
            yield  # pragma: no cover

    fb = FallbackBackend(Raising(DryRunExecutor(), cfg, shape),
                         ThreadBackend(DryRunExecutor(), cfg, shape))
    with pytest.raises(RuntimeError, match="HTTP 400"):
        list(fb.run(_stack_jobs()))


# --- in-sweep transient recovery (scheduler retry rounds) ------------------------

def _once_flaky(tuner):
    """The FIRST score of every unique program raises a transient deadline
    overrun; the retry succeeds."""
    orig = tuner.executor.score_segment
    seen = set()

    def flaky(cfg, shape, seg, combo, knobs=None):
        key = (seg.name, combo.cid, knobs.kid if knobs else "")
        if key not in seen:
            seen.add(key)
            raise CombinationFailed("deadline 0s exceeded (synthetic)",
                                    transient=True)
        return orig(cfg, shape, seg, combo, knobs=knobs)

    tuner.executor.score_segment = flaky
    return tuner


def test_scheduler_retry_round_rescues_transients(baseline):
    ref_bytes, ref_rep = baseline
    tuner = _once_flaky(_tuner(SweepDB(":memory:"), "chaos-retry"))
    plan, rep = _sweep(tuner, backend="sequential")
    assert _plan_bytes(plan) == ref_bytes
    assert rep.n_failed == 0 and rep.n_transient == 0
    assert rep.n_transient_retried == ref_rep.n_scored
    assert "transient_retried" in rep.summary()


def test_scheduler_retry_disabled_keeps_old_behavior(baseline):
    tuner = _once_flaky(_tuner(SweepDB(":memory:"), "chaos-noretry"))
    with pytest.raises(Exception):
        # every program transient-fails and fusion has nothing to fuse
        _sweep(tuner, backend="sequential", transient_retries=0)
    counts = tuner.db.done_count("chaos-noretry")
    assert counts.get("failed", 0) > 0 and counts.get("done", 0) == 0


def test_failure_kinds_histogram_reaches_report():
    db = SweepDB(":memory:")
    rep = SweepReport("p", n_combinations=2)
    rec = Recorder(db, "p", rep)
    jobs = _stack_jobs()
    g0 = JobGroup(jobs[0].seg, jobs[0].combo, "s0", "e0",
                  members=[("seg", "c0")])
    g1 = JobGroup(jobs[1].seg, jobs[1].combo, "s1", "e1",
                  members=[("seg", "c1")])
    rec.outcome(g0, JobOutcome("j0", FAILED, error="x", transient=True,
                               kind="crash", attempts=2))
    rec.outcome(g1, JobOutcome("j1", FAILED, error="y"))
    assert rep.failure_kinds == {"crash": 1, "deterministic": 1}
    assert rep.n_transient_retried == 1
    assert "failure_kinds" in rep.summary()


# --- recorder flush crash --------------------------------------------------------

def test_recorder_flush_crash_then_recovery(tmp_path):
    """The first flush raises (rows stay buffered); the retry lands every
    row exactly once."""
    db = SweepDB(str(tmp_path / "rec.db"))
    db.open_project("p", "new")
    rep = SweepReport("p", n_combinations=1)
    plan = FaultPlan({"recorder.flush": [FaultRule(RAISE, at=(1,))]})
    rec = Recorder(db, "p", rep, fault_plan=plan, batch=1000)
    job = _stack_jobs(n=1)[0]
    db.register("p", job.seg.name, job.combo)
    g = JobGroup(job.seg, job.combo, "sig", "ec",
                 members=[(job.seg.name, job.combo.cid)])
    rec.outcome(g, JobOutcome("j0", DONE, cost={"total_s": 1.0}))
    with pytest.raises(RuntimeError, match="fault injection"):
        rec.flush()
    assert all(r["status"] != "done" for r in db.results("p"))
    rec.flush()
    rows = [r for r in db.results("p") if r["status"] == "done"]
    assert len(rows) == 1
    assert plan.events == [("recorder.flush", 1, RAISE)]


# --- a training crash and its restart (the train_e2e example) --------------------

def test_train_e2e_resumes_from_its_checkpoint(tmp_path):
    """The example's simulated crash at the halfway point: the restart
    resumes from the latest checkpoint and replays the straight run's
    losses bit for bit."""
    import math

    from repro_torch.launch.train import train
    out = train_e2e.main(["--device", "cpu", "--steps", "4",
                          "--ckpt", str(tmp_path / "ckpt")])
    assert len(out["first"]) == 2 and len(out["second"]) == 2
    assert all(math.isfinite(x) for x in out["first"] + out["second"])
    straight = train(["--arch", "xlstm-125m", "--smoke", "--device", "cpu",
                      "--batch", "8", "--seq", "64", "--steps", "4",
                      "--resume", "never", "--ckpt-dir",
                      str(tmp_path / "straight")])
    assert out["first"] + out["second"] == straight
