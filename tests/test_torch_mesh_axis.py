"""The mesh/topology axis of the port's sweep, as the reference's
``tests/test_mesh_axis.py``: the MeshSpec wire format, worker-rebuilt
meshes, unsatisfiable meshes (transient in a worker, HTTP 400 at the
server), per-point rows, the joint argmin, cache sharing with fixed-mesh
sweeps, pruning exactness, and the boundary costs of a multi-device point.

A mesh here spans the ranks of a process group, one device each, so a
one-process test materializes the one-device points (``{"data": 1}``: a
world-size-1 gloo group, destroyed after each test) and a 2-device point
is unsatisfiable; the reference's multi-device cases run in
tests/test_torch_distributed.py, and the boundary costs of ``{"data": 2,
"model": 2}`` are priced from the spec (no group needed) and held to the
reference's.
"""
from __future__ import annotations

import json
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

from repro_torch.configs import get_arch, get_shape
from repro_torch.core.backends import JobSpec
from repro_torch.core.combinator import Combination, GlobalKnobs, row_cid
from repro_torch.core.db import SweepDB
from repro_torch.core.executor import DryRunExecutor
from repro_torch.core.meshspec import LOCAL, MeshSpec, MeshUnsatisfiable
from repro_torch.core.segment import Segment, fragment
from repro_torch.core.tuner import ComParTuner
from repro_torch.launch.mesh import destroy_group
from repro_torch.models.context import SegmentClause

SPACE = {"remat": ("none",), "kernel": ("plain",), "block_q": (16,),
         "block_k": (16,), "scan_unroll": (1,), "mlstm_chunk": (16,)}
ONE = {"data": 1}


@pytest.fixture(autouse=True)
def _no_group_left():
    """Each test's world-size-1 group (and its memoized meshes) goes with
    it."""
    yield
    destroy_group()


def _plan_bytes(plan):
    d = plan.to_json()
    return json.dumps({"segments": d["segments"], "knobs": d["knobs"],
                       "mesh": d["mesh"]}, sort_keys=True).encode()


def _tuner(db, project, mesh=None, mode="new"):
    cfg = get_arch("granite-8b").smoke()
    shape = get_shape("train_4k").smoke()
    return ComParTuner(cfg, shape, device="cpu", mesh=mesh, db=db,
                       project=project, mode=mode, executor="dryrun",
                       timeout_s=120)


def _sweep(tuner, **kw):
    kw.setdefault("use_cache", False)
    return tuner.sweep(providers=["tensor_par", "fsdp"], clause_space=SPACE,
                       max_flags=1, **kw)


def _stack():
    cfg = get_arch("granite-8b").smoke()
    shape = get_shape("train_4k").smoke()
    seg = next(s for s in fragment(cfg) if s.kind == "stack")
    return cfg, shape, seg, Combination("fsdp", frozenset(), SegmentClause())


# --- the wire format ----------------------------------------------------------

def test_jobspec_carries_meshspec_roundtrip():
    seg = Segment("g0", "stack", ("attn",), 2)
    combo = Combination("fsdp", frozenset(), SegmentClause())
    spec = JobSpec("k", seg, combo, segments=("m1/kid/g0",), bound_s=1.0,
                   signature="sig", eff_cid="ec",
                   knobs=GlobalKnobs(microbatches=2),
                   mesh=MeshSpec.of(data=2, device_kind="cpu"),
                   mesh_key="abc123/dryrun:h100-sxm")
    back = JobSpec.from_json(json.loads(json.dumps(spec.to_json())))
    assert back == spec
    assert back.mesh == spec.mesh and back.mesh_key == spec.mesh_key
    bare = JobSpec("k2", seg, combo)
    wire = json.loads(json.dumps(bare.to_json()))
    assert JobSpec.from_json(wire).mesh is None
    assert JobSpec.from_json(wire).mesh_key == ""


def test_row_cid_mesh_qualified():
    from repro.core.combinator import GlobalKnobs as JKnobs
    from repro.core.combinator import row_cid as jrow_cid
    from repro.core.meshspec import MeshSpec as JMeshSpec
    combo = Combination("fsdp", frozenset(), SegmentClause())
    kn = GlobalKnobs(microbatches=2)
    spec = MeshSpec.of(data=2)
    assert row_cid(combo) == combo.cid
    assert row_cid(combo, kn) == f"{combo.cid}@{kn.kid}"
    assert row_cid(combo, None, spec) == f"{combo.cid}#{spec.mid}"
    assert row_cid(combo, kn, spec) == f"{combo.cid}@{kn.kid}#{spec.mid}"
    assert row_cid(combo, None, LOCAL) == f"{combo.cid}#local"
    # the qualifiers are the reference's
    jc = SimpleNamespace(cid=combo.cid)
    assert jrow_cid(jc, JKnobs(microbatches=2), JMeshSpec.of(data=2)) == \
        row_cid(combo, kn, spec)


# --- worker-rebuilt meshes --------------------------------------------------------

def test_worker_rebuilt_mesh_scores_byte_identical():
    """A process worker rebuilds the mesh from the JobSpec in its own
    world-size-1 group and scores byte-identically to this process."""
    from repro_torch.core.backends import ProcessBackend
    cfg, shape, seg, combo = _stack()
    spec = MeshSpec.of(data=1)
    parent = DryRunExecutor(timeout_s=120).score_segment(
        cfg, shape, seg, combo, mesh=spec.to_mesh())
    backend = ProcessBackend(DryRunExecutor(timeout_s=120), cfg, shape,
                             workers=1, timeout_s=120)
    try:
        outs = list(backend.run([JobSpec("j", seg, combo,
                                         segments=(seg.name,), mesh=spec)]))
    finally:
        backend.close()
    assert len(outs) == 1 and outs[0].status == "done", outs
    assert json.dumps(outs[0].cost, sort_keys=True) == \
        json.dumps(parent.as_dict(), sort_keys=True)


def test_process_sweep_workers_destroy_their_groups(tmp_path, monkeypatch):
    """A process-backend sweep over a one-device point: each worker makes
    its world-size-1 group, its store in the pool's directory under the
    parent's temp dir (which a forkserver's environment need not name),
    and destroys it on its way out; the pool's directory goes on close,
    also after a worker killed mid-job."""
    import tempfile
    from repro_torch.core.backends import ProcessBackend
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    plan, rep = _sweep(_tuner(SweepDB(":memory:"), "prc"),
                       mesh_space=[None, ONE], backend="process", workers=2)
    assert rep.n_done == rep.n_combinations
    assert set(rep.per_mesh_total_s) == {"local", "data1[any]"}
    assert not list(tmp_path.rglob("repro_torch_*"))
    # a worker that made its group and then died without its teardown
    cfg, shape, seg, combo = _stack()
    backend = ProcessBackend(DryRunExecutor(timeout_s=120), cfg, shape,
                             workers=1, timeout_s=120)
    try:
        outs = list(backend.run([JobSpec("j", seg, combo,
                                         segments=(seg.name,),
                                         mesh=MeshSpec.of(data=1))]))
        assert outs[0].status == "done", outs
        assert list(tmp_path.rglob("repro_torch_pg_*"))    # the live group
        for w in list(backend._pool):
            backend._kill(w)
    finally:
        backend.close()
    assert not list(tmp_path.rglob("repro_torch_*"))


def test_unsatisfiable_job_mesh_fails_transient_not_cached():
    from repro_torch.core.backends import ThreadBackend
    cfg, shape, seg, combo = _stack()
    backend = ThreadBackend(DryRunExecutor(timeout_s=60), cfg, shape)
    outs = list(backend.run([JobSpec("j", seg, combo, segments=(seg.name,),
                                     mesh=MeshSpec.of(data=1 << 20))]))
    assert len(outs) == 1
    assert outs[0].status == "failed" and outs[0].transient
    assert "rank" in outs[0].error


def test_server_rejects_unsatisfiable_mesh_http_400(tmp_path):
    from repro_torch.configs.registry import arch_to_spec, shape_to_spec
    from repro_torch.core.backends import WIRE_VERSION, executor_to_spec
    from repro_torch.core.backends.server import SweepScoringServer
    cfg, shape, seg, combo = _stack()
    init = {"executor": executor_to_spec(DryRunExecutor(timeout_s=60)),
            "arch": arch_to_spec(cfg), "shape": shape_to_spec(shape),
            "shape_key": "sk", "mesh_key": "mk"}

    def post(url, payload):
        req = urllib.request.Request(
            url + "/v1/submit", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            return json.loads(r.read())

    srv = SweepScoringServer(str(tmp_path / "srv.db"), workers=1)
    srv.start()
    try:
        bad_job = JobSpec("j", seg, combo, segments=(seg.name,),
                          mesh=MeshSpec.of(data=1 << 20)).to_json()
        with pytest.raises(urllib.error.HTTPError) as ei:
            post(srv.url, {"v": WIRE_VERSION, "run": "n", "init": init,
                           "jobs": [bad_job]})
        assert ei.value.code == 400
        assert "MeshUnsatisfiable" in ei.value.read().decode()
        huge_exec = dict(init["executor"],
                         mesh=MeshSpec.of(data=1 << 20).to_json())
        with pytest.raises(urllib.error.HTTPError) as ei:
            post(srv.url, {"v": WIRE_VERSION, "run": "n",
                           "init": {**init, "executor": huge_exec},
                           "jobs": []})
        assert ei.value.code == 400
        ok = JobSpec("j2", seg, combo, segments=(seg.name,),
                     mesh=MeshSpec.of(data=1)).to_json()
        resp = post(srv.url, {"v": WIRE_VERSION, "run": "n", "init": init,
                              "jobs": [ok]})
        assert "batch" in resp
    finally:
        srv.close()


# --- the mesh axis as a swept dimension ------------------------------------------

def test_mesh_axis_sweep_registers_per_point_rows_and_chooses_mesh():
    tuner = _tuner(SweepDB(":memory:"), "axis")
    plan, rep = _sweep(tuner, mesh_space=[None, ONE])
    _, ref_rep = _sweep(_tuner(SweepDB(":memory:"), "ref"))
    assert rep.n_mesh_points == 2
    assert rep.n_combinations == 2 * ref_rep.n_combinations
    assert rep.n_done == rep.n_combinations
    assert plan.mesh is not None
    assert set(rep.per_mesh_total_s) == {"local", "data1[any]"}
    assert plan.meta["predicted_total_s"] == min(rep.per_mesh_total_s.values())
    assert plan.meta["fusion"].endswith("+mesh-argmin")
    baselines = tuner.baselines()
    assert baselines
    assert plan.meta["predicted_total_s"] <= min(baselines.values()) + 1e-12
    # "auto" on one process is the local point alone
    plan_a, rep_a = _sweep(_tuner(SweepDB(":memory:"), "auto"),
                           mesh_space="auto")
    assert rep_a.n_mesh_points == 1 and plan_a.mesh == LOCAL


def test_mesh_axis_matches_fixed_mesh_brute_force():
    plan, rep = _sweep(_tuner(SweepDB(":memory:"), "swept"),
                       mesh_space=[None, ONE])
    ref = {}
    for name, mesh in (("local", None),
                       ("data1[any]", MeshSpec.of(data=1).to_mesh())):
        p, _ = _sweep(_tuner(SweepDB(":memory:"), f"fix-{name}", mesh=mesh))
        ref[name] = p.meta["predicted_total_s"]
    assert rep.per_mesh_total_s == pytest.approx(ref)
    assert plan.meta["predicted_total_s"] == pytest.approx(min(ref.values()))


def test_mesh_axis_shares_cache_with_fixed_mesh_sweeps(tmp_path):
    db = SweepDB(str(tmp_path / "shared.db"))
    mesh = MeshSpec.of(data=1).to_mesh()
    _, rep_fixed = _sweep(_tuner(db, "fixed", mesh=mesh), use_cache=True)
    assert rep_fixed.n_scored > 0
    _, rep_axis = _sweep(_tuner(db, "axis"), use_cache=True,
                         mesh_space=[None, ONE])
    local_only = _sweep(_tuner(SweepDB(":memory:"), "loc"))[1].n_scored
    assert rep_axis.n_scored == local_only
    plan_a, _ = _sweep(_tuner(db, "axis2"), use_cache=True,
                       mesh_space=[None, ONE])
    plan_b, rep_warm = _sweep(_tuner(db, "axis3"), use_cache=True,
                              mesh_space=[None, ONE])
    assert rep_warm.n_scored == 0
    assert rep_warm.n_cached == rep_warm.n_combinations
    assert _plan_bytes(plan_a) == _plan_bytes(plan_b)


def test_mesh_axis_incumbent_scopes_and_pruning_exactness():
    from repro_torch.core.backends import Recorder, Scheduler
    from repro_torch.core.tuner import SweepReport
    plan_ref, _ = _sweep(_tuner(SweepDB(":memory:"), "np"),
                         mesh_space=[None, ONE])
    plan_pr, rep_pr = _sweep(_tuner(SweepDB(":memory:"), "pr"),
                             mesh_space=[None, ONE], prune=True,
                             prune_margin=0.0, workers=2)
    assert _plan_bytes(plan_pr) == _plan_bytes(plan_ref)
    assert (rep_pr.n_done + rep_pr.n_failed + rep_pr.n_pruned
            == rep_pr.n_combinations)
    cfg = get_arch("granite-8b").smoke()
    shape = get_shape("train_4k").smoke()
    db = SweepDB(":memory:")
    db.open_project("s", "new")
    ex = DryRunExecutor(timeout_s=60)
    sched = Scheduler(db, "s", cfg, shape, None, ex)
    segs = fragment(cfg)
    combos = {s.name: [Combination("fsdp", frozenset(), SegmentClause())]
              for s in segs}
    db.register_many("s", [(s.name, combos[s.name][0], None, mp)
                           for s in segs for mp in (LOCAL, MeshSpec.of(data=1))])
    rec = Recorder(db, "s", SweepReport("s", 0))
    work = sched.build(segs, combos, rec,
                       mesh_points=[LOCAL, MeshSpec.of(data=1)])
    mid = MeshSpec.of(data=1).mid
    scopes = {s for j in work.jobs for s in j.segments}
    assert any(s.startswith("local/") for s in scopes)
    assert any(s.startswith(f"{mid}/") for s in scopes)
    assert {j.mesh_key for j in work.jobs} == \
        {f"local/{ex.cache_tag}", f"{mid}/{ex.cache_tag}"}


def test_unsatisfiable_point_is_skipped_by_the_argmin():
    """A 2-device point in a one-process sweep: its rows fail as
    transient (never cached), and the plan takes a point that scored."""
    plan, rep = _sweep(_tuner(SweepDB(":memory:"), "two"),
                       mesh_space=[ONE, {"data": 2}], transient_retries=0)
    assert plan.mesh == MeshSpec.of(data=1)
    assert rep.n_failed == rep.n_combinations // 2
    assert set(rep.per_mesh_total_s) == {"data1[any]"}
    assert plan.meta["mesh_failures"]


def test_mesh_axis_multidevice_resharding_differentiates_boundary_costs():
    """At a ``data 2 x model 2`` point the Viterbi boundary costs are
    mesh-dependent, priced from the spec's axes without a group, and equal
    the reference's on a mesh of that shape; the local point charges 0."""
    from repro.configs import get_arch as jget_arch
    from repro.configs import get_shape as jget_shape
    from repro.core import cost_model as JCM
    from repro.core import fusion as JF
    from repro.core.combinator import Combination as JCombination
    from repro.core.segment import fragment as jfragment
    from repro.models.context import SegmentClause as JClause
    from repro_torch.core import cost_model as TCM
    from repro_torch.core import fusion as TF
    cfg, jcfg = get_arch("granite-8b").smoke(), jget_arch("granite-8b").smoke()
    shape, jshape = get_shape("train_4k").smoke(), \
        jget_shape("train_4k").smoke()
    spec = MeshSpec.of(data=2, model=2)
    duck = SimpleNamespace(axis_names=("data", "model"),
                           devices=np.empty((2, 2)))
    hw = TCM.H100
    jhw = JCM.Hardware(**{k: getattr(hw, k) for k in vars(hw)})
    (sa, sb), (ja, jb) = fragment(cfg)[1:3], jfragment(jcfg)[1:3]
    seen = set()
    for fa in (frozenset(), frozenset({"seq_parallel"})):
        for fb in (frozenset(), frozenset({"shard_vocab"})):
            a, b = (Combination("tensor_par", fa, SegmentClause()),
                    Combination("fsdp", fb, SegmentClause()))
            got = TF.boundary_cost_s(cfg, shape, spec, a, sa, b, sb, hw)
            want = JF.boundary_cost_s(
                jcfg, jshape, duck, JCombination("tensor_par", fa, JClause()),
                ja, JCombination("fsdp", fb, JClause()), jb, jhw)
            assert got == want
            assert TF.boundary_cost_s(cfg, shape, None, a, sa, b, sb, hw) \
                == 0.0
            seen.add(got > 0)
    assert seen == {True, False}
    # a sweep priced with boundary costs keeps each point's own total
    plan, rep = _sweep(_tuner(SweepDB(":memory:"), "bc"),
                       mesh_space=[None, ONE], boundary_costs=True)
    assert set(rep.per_mesh_total_s) == {"local", "data1[any]"}
    assert plan.meta["fusion"].endswith("+mesh-argmin")


def test_fixed_mesh_tuner_refuses_an_unbuildable_mesh():
    cfg = get_arch("granite-8b").smoke()
    shape = get_shape("train_4k").smoke()
    with pytest.raises(MeshUnsatisfiable, match="needs 2"):
        ComParTuner(cfg, shape, device="cpu", mesh={"data": 2})
