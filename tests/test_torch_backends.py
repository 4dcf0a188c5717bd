"""The port's process backend and the wire format on the CPU, against the
JAX package.

Counterparts of the reference's backend tests in
``tests/test_sweep_engine.py``: sequential, thread and process backends
fuse byte-identical plans (the knob axis included); a hung worker is
killed by the hard timeout within the reference's bound; a crashing
worker's job is requeued once, to a different worker, then failed
transient; ``use_cache=False`` reaches the workers; the pool survives
across runs and a tuner reuses its engine across sweeps.  The wire format
is held to the reference's: the config specs equal its dicts, and
``JobSpec``/``JobOutcome.to_json`` of the same rows equal its output with
the clause ``kernel`` names mapped.  The port is meshless: an executor
spec carrying a mesh raises naming ROADMAP Queue 1 item 4, and a
wall-clock spec whose device the host lacks is refused, never timed on
another device.  Smoke configs, the dry run and the sleep and crash
executors throughout.
"""
import dataclasses
import json
import time

import pytest

from repro.configs import arch_to_spec as jarch_to_spec
from repro.configs import get_arch as jget_arch
from repro.configs import get_shape as jget_shape
from repro.configs import shape_to_spec as jshape_to_spec
from repro.core.backends import JobOutcome as JJobOutcome
from repro.core.backends import JobSpec as JJobSpec
from repro.core.backends.base import executor_to_spec as jexecutor_to_spec
from repro.core.combinator import Combination as JCombination
from repro.core.combinator import GlobalKnobs as JGlobalKnobs
from repro.core.executor import DryRunExecutor as JDryRunExecutor
from repro.core.segment import Segment as JSegment
from repro.models.context import SegmentClause as JClause
from repro_torch.configs import (ARCHS, all_cells, arch_from_spec,
                                 arch_to_spec, get_arch, get_shape,
                                 shape_from_spec, shape_to_spec)
from repro_torch.core.backends import (DeviceUnsatisfiable, JobOutcome,
                                       JobSpec, ProcessBackend,
                                       executor_from_spec, executor_to_spec)
from repro_torch.core.backends.process import _Worker
from repro_torch.core.combinator import Combination, GlobalKnobs
from repro_torch.core.cost_model import H100
from repro_torch.core.db import SweepDB
from repro_torch.core.executor import (CrashExecutor, DryRunExecutor,
                                       SleepExecutor, WallClockExecutor)
from repro_torch.core.machine import MachineProfile, hardware_from_profile
from repro_torch.core.segment import Segment, fragment
from repro_torch.core.tuner import ComParTuner
from repro_torch.models.context import SegmentClause

SPACE = {"remat": ("none", "full"), "kernel": ("plain",), "block_q": (16, 32),
         "block_k": (16,), "scan_unroll": (1,), "mlstm_chunk": (16,)}


def _plan_bytes(plan):
    """Byte-identity of the fused decisions: per-segment combinations and
    the chosen knob point."""
    d = plan.to_json()
    return json.dumps({"segments": d["segments"], "knobs": d["knobs"]},
                      sort_keys=True).encode()


def _tuner(db, project, mode="new"):
    cfg = get_arch("granite-8b").smoke()
    shape = get_shape("train_4k").smoke()
    return ComParTuner(cfg, shape, device="cpu", db=db, project=project,
                       mode=mode, executor="dryrun", timeout_s=120)


def _sweep(tuner, **kw):
    return tuner.sweep(providers=["tensor_par", "fsdp"], clause_space=SPACE,
                       max_flags=1, **kw)


def _cell():
    return get_arch("granite-8b").smoke(), get_shape("train_4k").smoke()


def _job(key, provider="fsdp"):
    cfg, _ = _cell()
    seg = next(s for s in fragment(cfg) if s.kind == "stack")
    return JobSpec(key, seg, Combination(provider, frozenset(),
                                         SegmentClause()),
                   segments=(seg.name,))


@pytest.fixture(scope="module")
def sequential():
    plan, rep = _sweep(_tuner(SweepDB(":memory:"), "seq"),
                       backend="sequential", use_cache=False)
    return plan, rep


# --- Scheduler -> Backend -> Recorder -------------------------------------------

def test_backend_equivalence_sequential_thread_process(sequential):
    """Sequential, thread(2) and process(2) backends fuse byte-identical
    plans with the same accounting."""
    plan_ref, rep_ref = sequential
    ref = _plan_bytes(plan_ref)
    plan_t, _ = _sweep(_tuner(SweepDB(":memory:"), "be-thr"),
                       backend="thread", workers=2, use_cache=False)
    assert _plan_bytes(plan_t) == ref
    with _tuner(SweepDB(":memory:"), "be-prc") as t_prc:
        plan_p, rep_p = _sweep(t_prc, backend="process", workers=2,
                               use_cache=False)
    assert _plan_bytes(plan_p) == ref
    assert (rep_p.n_done, rep_p.n_failed, rep_p.n_scored, rep_p.n_shared) \
        == (rep_ref.n_done, 0, rep_ref.n_scored, rep_ref.n_shared)


def test_process_backend_hard_timeout_kills_hung_worker():
    """A worker stuck past timeout_s is killed (requeued once, then failed
    transient) within the reference's bound: the sweep cannot hang."""
    cfg, shape = _cell()
    timeout_s = 2.0
    backend = ProcessBackend(SleepExecutor(sleep_s=600.0), cfg, shape,
                             workers=2, timeout_s=timeout_s)
    try:
        backend.warmup()            # keep the start-up out of the window
        t0 = time.monotonic()
        outs = list(backend.run([_job("hung")]))
        elapsed = time.monotonic() - t0
    finally:
        backend.close()
    assert len(outs) == 1
    out = outs[0]
    assert out.status == "failed" and out.transient
    assert out.attempts == 2 and "killed" in out.error
    assert out.kind == "deadline"
    # two attempts, each killed at timeout_s * (1 + kill_grace)
    budget = 2 * timeout_s * (1 + ProcessBackend.kill_grace) + 1.0
    assert elapsed < budget, f"hard kill too slow: {elapsed:.1f}s"


def test_process_backend_crash_requeues_once_then_fails_transient():
    cfg, shape = _cell()
    backend = ProcessBackend(CrashExecutor(), cfg, shape, workers=2,
                             timeout_s=60)
    try:
        backend.warmup()
        outs = list(backend.run([_job("boom")]))
    finally:
        backend.close()
    assert len(outs) == 1
    out = outs[0]
    assert out.status == "failed" and out.transient and out.attempts == 2
    assert "crashed" in out.error and out.kind == "crash"
    # the requeue went to a different worker than the one it died on
    wids = [w for _, w in backend.dispatch_log]
    assert [k for k, _ in backend.dispatch_log] == ["boom", "boom"]
    assert wids[0] != wids[1], "retry burned on the worker the job died on"


def test_next_job_skips_excluded_worker():
    """Dispatch unit: a job is never handed back to a worker id it died
    on; a non-excluded worker still gets it, in queue order."""
    from collections import deque
    cfg, shape = _cell()
    backend = ProcessBackend(SleepExecutor(sleep_s=0.01), cfg, shape,
                             workers=2)
    j1, j2 = _job("j1"), _job("j2")
    w0, w1 = _Worker(None, None, 0), _Worker(None, None, 1)
    queue = deque([j1, j2])
    job, pruned = backend._next_job(w0, queue, {"j1": {0}}, {})
    assert job is j2 and not pruned
    assert list(queue) == [j1]
    job, _ = backend._next_job(w1, queue, {"j1": {0}}, {})
    assert job is j1 and not queue


def test_process_backend_honors_use_cache_off(tmp_path):
    """use_cache=False forces real runs even on a file-backed DB whose
    score_cache is warm: the workers get no cache reader."""
    db = SweepDB(str(tmp_path / "sweep.db"))
    _sweep(_tuner(db, "warm"), use_cache=True)
    with _tuner(db, "nocache") as t2:
        _, rep = _sweep(t2, backend="process", workers=2, use_cache=False)
    assert rep.n_cached == 0
    assert rep.n_scored > 0
    assert rep.n_done == rep.n_combinations


def test_process_workers_serve_the_shared_cache(tmp_path):
    """With the cache on, a worker resolves a job another sweep scored
    from its read-only view of the DB: ``cached``, nothing run."""
    db = SweepDB(str(tmp_path / "sweep.db"))
    _sweep(_tuner(db, "warm"), use_cache=True)
    row = db.conn.execute("SELECT signature, shape, mesh, cid FROM "
                          "score_cache LIMIT 1").fetchone()
    cfg, shape = _cell()
    job = dataclasses.replace(_job("hit"), signature=row[0], eff_cid=row[3])
    backend = ProcessBackend(CrashExecutor(), cfg, shape, workers=1,
                             timeout_s=60, db_path=db.path,
                             shape_key=row[1], mesh_key=row[2])
    try:
        outs = list(backend.run([job]))
    finally:
        backend.close()
    assert [(o.status, o.cached) for o in outs] == [("done", True)]


def test_backend_equivalence_extends_to_knob_axis():
    """sequential/thread/process sweeps over the same global_space fuse
    byte-identical plans, segments and chosen knobs."""
    space = {"microbatches": (1, 2),
             "opt_state_dtype": ("float32", "bfloat16")}
    plans = {}
    for backend, workers in (("sequential", 1), ("thread", 2),
                             ("process", 2)):
        with _tuner(SweepDB(":memory:"), f"kbe-{backend}") as t:
            plans[backend] = _sweep(t, backend=backend, workers=workers,
                                    use_cache=False, global_space=space)
    ref_bytes = _plan_bytes(plans["sequential"][0])
    ref_rep = plans["sequential"][1]
    for backend, (plan, rep) in plans.items():
        assert _plan_bytes(plan) == ref_bytes, backend
        assert (rep.n_done, rep.n_failed, rep.n_scored) == \
            (ref_rep.n_done, 0, ref_rep.n_scored), backend


def test_process_backend_pool_survives_across_runs():
    """Successive run() calls reuse the same warm workers; close() shuts
    them down, each acknowledging with its launch totals."""
    cfg, shape = _cell()
    backend = ProcessBackend(SleepExecutor(sleep_s=0.01), cfg, shape,
                             workers=1, timeout_s=60)
    try:
        backend.warmup()
        pids0 = sorted(w.proc.pid for w in backend._pool)
        assert [o.status for o in backend.run([_job("j1")])] == ["done"]
        assert sorted(w.proc.pid for w in backend._pool) == pids0
        assert [o.status for o in backend.run([_job("j2")])] == ["done"]
        assert sorted(w.proc.pid for w in backend._pool) == pids0
        assert all(w.proc.is_alive() for w in backend._pool)
        assert len(backend.spawn_s) == 1 and backend.spawn_s[0] > 0
    finally:
        backend.close()
    assert backend._pool == []
    # the worker's LAUNCHES reached the parent (no kernel runs on the CPU)
    from repro_torch.kernels import LAUNCHES
    assert backend.launches == dict.fromkeys(LAUNCHES, 0)


def test_tuner_reuses_process_engine_across_sweeps():
    """Two sweeps on one tuner share one cached process backend (same
    warm pool), released by tuner.close()."""
    tuner = _tuner(SweepDB(":memory:"), "reuse")
    try:
        _sweep(tuner, backend="process", workers=1, use_cache=False)
        assert len(tuner._engines) == 1
        engine = next(iter(tuner._engines.values()))
        pids = sorted(w.proc.pid for w in engine._pool)
        assert pids, "pool should stay warm after the first sweep"
        tuner.sweep(providers=["tensor_par", "fsdp"],
                    clause_space=dict(SPACE, block_q=(64,)), max_flags=1,
                    backend="process", workers=1, use_cache=False)
        assert len(tuner._engines) == 1
        assert next(iter(tuner._engines.values())) is engine
        assert sorted(w.proc.pid for w in engine._pool) == pids
    finally:
        tuner.close()
    assert tuner._engines == {}


def test_sweep_after_injected_failure_completes(monkeypatch):
    """An error mid-sweep leaves the cached process engine usable: the
    next sweep on the same tuner culls dead workers and completes;
    close() stays idempotent."""
    import repro_torch.core.tuner as T
    tuner = _tuner(SweepDB(":memory:"), "injected")

    class BoomRecorder(T.Recorder):
        def outcome(self, group, out):
            raise RuntimeError("injected recorder failure")

    with monkeypatch.context() as m:
        m.setattr(T, "Recorder", BoomRecorder)
        with pytest.raises(RuntimeError, match="injected"):
            _sweep(tuner, backend="process", workers=1, use_cache=False)
    engine = next(iter(tuner._engines.values()))
    for w in list(engine._pool):
        w.proc.terminate()
        w.proc.join(timeout=10)
    plan, rep = _sweep(tuner, backend="process", workers=1, use_cache=False)
    assert rep.n_done == rep.n_combinations and rep.n_failed == 0
    assert next(iter(tuner._engines.values())) is engine
    tuner.close()
    tuner.close()
    assert tuner._engines == {}


def test_worker_that_cannot_reach_its_device_fails_its_jobs():
    """A wall-clock spec naming a device the worker lacks: the worker
    fails every job transient (never cached), kind "crash"; it never
    times the job on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the test is for one without")
    cfg, shape = _cell()
    backend = ProcessBackend(DryRunExecutor(), cfg, shape, workers=1,
                             timeout_s=60)
    backend._init["executor"] = {"kind": "wallclock", "timeout_s": 60,
                                 "repeats": 1, "device": "cuda",
                                 "mesh": None}
    try:
        outs = list(backend.run([_job("j")]))
    finally:
        backend.close()
    assert len(outs) == 1 and outs[0].status == "failed"
    assert outs[0].transient and outs[0].kind == "crash"
    assert "DeviceUnsatisfiable" in outs[0].error and outs[0].cost is None


# --- the wire format -------------------------------------------------------------

def test_jobspec_joboutcome_wire_roundtrip():
    """Pure JSON both ways, the GlobalKnobs point included."""
    seg = Segment("g0", "stack", ("attn", "rec"), 3)
    combo = Combination("tensor_par", frozenset({"shard_vocab"}),
                        SegmentClause(remat="dots", block_q=64,
                                      kernel="cuda"))
    spec = JobSpec("k1", seg, combo, segments=("g0", "g3"), bound_s=1.5,
                   signature="sig", eff_cid="ec",
                   knobs=GlobalKnobs(microbatches=2, donate=False))
    back = JobSpec.from_json(json.loads(json.dumps(spec.to_json())))
    assert back == spec and isinstance(back.seg.pattern, tuple)
    assert isinstance(back.segments, tuple) and back.knobs == spec.knobs
    bare = JobSpec("k2", seg, combo)
    assert JobSpec.from_json(
        json.loads(json.dumps(bare.to_json()))).knobs is None
    out = JobOutcome("k1", "failed", cost=None, error="deadline",
                     transient=True, attempts=2, kind="deadline",
                     fallback=True)
    assert JobOutcome.from_json(json.loads(json.dumps(out.to_json()))) == out


def test_wire_dicts_match_reference():
    """The same rows give the reference's JSON, kernel names mapped
    (``cuda`` <-> ``pallas``); a reference payload decodes in the port."""
    for kernel, jkernel in (("cuda", "pallas"), ("plain", "xla")):
        spec = JobSpec(
            "k", Segment("g0", "stack", ("attn",), 2),
            Combination("fsdp", frozenset({"shard_vocab"}),
                        SegmentClause(remat="dots", kernel=kernel)),
            segments=("mb/g0",), bound_s=0.25, signature="s",
            eff_cid="e", knobs=GlobalKnobs(microbatches=2))
        jspec = JJobSpec(
            "k", JSegment("g0", "stack", ("attn",), 2),
            JCombination("fsdp", frozenset({"shard_vocab"}),
                         JClause(remat="dots", kernel=jkernel)),
            segments=("mb/g0",), bound_s=0.25, signature="s",
            eff_cid="e", knobs=JGlobalKnobs(microbatches=2))
        got = json.loads(json.dumps(spec.to_json()))
        want = json.loads(json.dumps(jspec.to_json()))
        assert got["combo"]["clause"].pop("kernel") == kernel
        assert want["combo"]["clause"].pop("kernel") == jkernel
        assert got == want
        assert JobSpec.from_json(jspec.to_json()) == spec
    out = dict(key="k", status="done", cost={"total_s": 1.0}, error="",
               transient=False, cached=True, attempts=3, kind="",
               fallback=True)
    assert JobOutcome(**out).to_json() == JJobOutcome(**out).to_json()


def test_arch_shape_specs_match_reference_and_roundtrip():
    for name in sorted(ARCHS):
        for cfg, jcfg in ((get_arch(name), jget_arch(name)),
                          (get_arch(name).smoke(), jget_arch(name).smoke())):
            assert arch_to_spec(cfg) == jarch_to_spec(jcfg)
            # registry fast path: the canonical config comes back
            assert arch_from_spec(json.loads(json.dumps(
                arch_to_spec(cfg)))) == cfg
    for sname in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        for shape, jshape in ((get_shape(sname), jget_shape(sname)),
                              (get_shape(sname).smoke(),
                               jget_shape(sname).smoke())):
            assert shape_to_spec(shape) == jshape_to_spec(jshape)
            assert shape_from_spec(json.loads(json.dumps(
                shape_to_spec(shape)))) == shape
    # ad-hoc configs (fields diverge from the registry) rebuild from fields
    cfg = get_arch("granite-8b").smoke()
    custom = dataclasses.replace(cfg, d_model=cfg.d_model * 2)
    rebuilt = arch_from_spec(json.loads(json.dumps(arch_to_spec(custom))))
    assert rebuilt == custom and isinstance(rebuilt.block_pattern, tuple)
    assert len(list(all_cells())) == 4 * len(ARCHS)


def test_executor_specs_roundtrip_and_refuse_a_mesh():
    """The dry run's whole Hardware crosses the wire (a calibrated view's
    ``cache_tag`` comes back equal), the wall clock's device too; a mesh
    raises naming ROADMAP item 4; the sleep and crash specs need
    ``allow_test``; the dry run's spec keys are the reference's."""
    prof = MachineProfile(platform="cuda", device_kind="H100",
                          n_devices=1, peak_flops={"bfloat16": 7.5e14},
                          hbm_bw=3.0e12)
    for hw in (H100, hardware_from_profile(prof)):
        ex = DryRunExecutor(hw, timeout_s=60)
        spec = json.loads(json.dumps(executor_to_spec(ex)))
        back = executor_from_spec(spec)
        assert back.hw == hw and back.cache_tag == ex.cache_tag
        assert back.timeout_s == 60
    assert executor_from_spec(executor_to_spec(
        DryRunExecutor(hardware_from_profile(prof)))).cache_tag.startswith(
            "dryrun:cal1-cuda-")
    assert set(executor_to_spec(DryRunExecutor())) == \
        set(jexecutor_to_spec(JDryRunExecutor(None)))
    wc = WallClockExecutor("cpu", repeats=3, timeout_s=9)
    spec = json.loads(json.dumps(executor_to_spec(wc)))
    assert spec["device"] == "cpu" and spec["mesh"] is None
    back = executor_from_spec(spec)
    assert (back.device.type, back.repeats, back.timeout_s) == ("cpu", 3, 9)
    assert back.cache_tag == wc.cache_tag
    # a fixed mesh travels as its MeshSpec and is rebuilt by the scoring
    # process, which refuses one it cannot build (a 2-device mesh, here)
    from repro_torch.core.meshspec import MeshUnsatisfiable
    with pytest.raises(MeshUnsatisfiable, match="needs 2"):
        executor_from_spec(dict(executor_to_spec(DryRunExecutor()),
                                mesh={"axes": [["data", 2]]}))
    for ex in (SleepExecutor(sleep_s=1.0), CrashExecutor()):
        spec = executor_to_spec(ex)
        with pytest.raises(ValueError, match="unknown executor kind"):
            executor_from_spec(spec)
        assert type(executor_from_spec(spec, allow_test=True)) is type(ex)


def test_wallclock_spec_for_a_missing_device_is_refused():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the test is for one without")
    spec = {"kind": "wallclock", "timeout_s": 60, "repeats": 5,
            "device": "cuda", "mesh": None}
    with pytest.raises(DeviceUnsatisfiable, match="cuda"):
        executor_from_spec(spec)
    assert issubclass(DeviceUnsatisfiable, ValueError)
