"""The port's sweep core on the CPU against the JAX package.

Signatures, clause relevance, enumeration, the cost model's bounds and
fusion are exact: the same values and the same order, with the clause
``kernel`` names mapped (``"xla"`` -> ``"plain"``, ``"pallas"`` ->
``"cuda"``) and both cost models given the same ``Hardware`` constants
(floats to 1e-12 relative).  Segment programs run the same weights and
inputs (the reference's, carried through numpy) and are held at the
tolerances ``tests/test_torch_train.py`` uses for gradients: atol 1e-5 +
1e-4 of each leaf's largest magnitude.  The reference runs its ``pallas``
clause in interpret mode, as its own tests do; the port's ``cuda`` clause
takes the kernels' plain versions on the CPU.  The whole tuner is held to
the reference's through a test-local table executor plugged into both.
"""
import dataclasses
import math
import zlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import get_shape as jget_shape
from repro.core import combinator as JC
from repro.core import cost_model as JCM
from repro.core import fusion as JF
from repro.core.db import SweepDB as JSweepDB
from repro.core.executor import _materialize as jmaterialize
from repro.core.providers import get_provider as jget_provider
from repro.core.segment import fragment as jfragment
from repro.core.timer import segment_program as jsegment_program
from repro.core.tuner import ComParTuner as JTuner
from repro.models.context import SegmentClause as JClause
from repro_torch.configs import get_arch, get_shape
from repro_torch.configs.registry import ARCHS
from repro_torch.core import combinator as TC
from repro_torch.core import cost_model as TCM
from repro_torch.core import fusion as TF
from repro_torch.core.db import SweepDB
from repro_torch.core.executor import DryRunExecutor, OpCounter
from repro_torch.core.providers import get_provider
from repro_torch.core.segment import fragment
from repro_torch.core.timer import segment_program
from repro_torch.core.tuner import ComParTuner
from repro_torch.examples import quickstart
from repro_torch.models.context import SegmentClause
from repro_torch.models.convert import params_from_numpy, tensor_to_numpy

KERNEL = {"plain": "xla", "cuda": "pallas"}     # port clause -> reference
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
SPACE = {"remat": ("none", "dots"), "kernel": ("xla", "pallas"),
         "block_q": (16, 32)}


def _cfgs(name, smoke=True):
    j, t = jget_arch(name), get_arch(name)
    return (j.smoke(), t.smoke()) if smoke else (j, t)


def _clause_json(combo):
    """A combination in the port's names, comparable across packages."""
    cl = dict(vars(combo.clause))
    cl["kernel"] = TC.port_kernel(cl["kernel"])
    return (combo.provider, tuple(sorted(combo.flags)),
            tuple(sorted(cl.items())))


def _hw_pair():
    """The port's H100 constants in both packages' ``Hardware``."""
    d = dataclasses.asdict(TCM.H100)
    return JCM.Hardware(**d), TCM.Hardware(**d)


# --- signatures and relevance --------------------------------------------------

@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_signatures_and_relevance_match_reference(name, smoke):
    jcfg, tcfg = _cfgs(name, smoke)
    for sname in SHAPES + ("long_500k",):
        jsh, tsh = jget_shape(sname), get_shape(sname)
        jsegs, tsegs = jfragment(jcfg), fragment(tcfg)
        assert [s.to_json() for s in tsegs] == [s.to_json() for s in jsegs]
        for js, ts in zip(jsegs, tsegs):
            assert ts.signature(tcfg, tsh) == js.signature(jcfg, jsh)
            assert ts.relevant_clause_fields(tsh.kind) == \
                js.relevant_clause_fields(jsh.kind)
            assert ts.relevant_knob_fields(tsh.kind) == \
                js.relevant_knob_fields(jsh.kind)


# --- combinator ----------------------------------------------------------------

@pytest.mark.parametrize("budget,max_flags", [(None, None), (None, 1),
                                              (40, None), (7, 1)])
def test_enumeration_matches_reference(budget, max_flags):
    provs = ["tensor_par", "fsdp", "hybrid2d", "expert_par"]
    jl = JC.enumerate_combinations(provs, None, budget=budget,
                                   max_flags=max_flags, seed=3)
    tl = TC.enumerate_combinations(provs, None, budget=budget,
                                   max_flags=max_flags, seed=3)
    assert [_clause_json(c) for c in tl] == [_clause_json(c) for c in jl]
    # a space in the reference's kernel names enumerates the same
    tl2 = TC.enumerate_combinations(provs, SPACE, max_flags=max_flags)
    jl2 = JC.enumerate_combinations(provs, SPACE, max_flags=max_flags)
    assert [_clause_json(c) for c in tl2] == [_clause_json(c) for c in jl2]


def test_counts_grids_and_subsets_match_reference():
    for flags, rtl, d in [([2, 2, 3], 0, 6), ([2], 2, 9), ([3, 1], 1, 2)]:
        assert TC.paper_combination_count(flags, rtl, d) == \
            JC.paper_combination_count(flags, rtl, d)
    for space in (None, {"microbatches": (1, 2)},
                  {"microbatches": (1, 2, 4), "donate": (True, False)}):
        assert [k.to_json() for k in TC.global_grid(space)] == \
            [k.to_json() for k in JC.global_grid(space)]
        assert [k.kid for k in TC.global_grid(space)] == \
            [k.kid for k in JC.global_grid(space)]
        assert TC.swept_knob_fields(space) == JC.swept_knob_fields(space)
    for fl, mf in [(("a", "b", "c"), None), (("a", "b", "c"), 2), ((), 1)]:
        assert TC.flag_subsets(fl, mf) == JC.flag_subsets(fl, mf)


@pytest.mark.parametrize("pname", ["tensor_par", "fsdp", "hybrid2d",
                                   "expert_par"])
def test_providers_match_reference(pname):
    tp, jp = get_provider(pname), jget_provider(pname)
    assert tp.flags == jp.flags
    for name in sorted(ARCHS):
        jcfg, tcfg = _cfgs(name, smoke=False)
        for js, ts in zip(jfragment(jcfg), fragment(tcfg)):
            assert tp.applicable(tcfg, ts) == jp.applicable(jcfg, js)
            for axes in ({}, {"data": 4}, {"data": 2, "model": 4},
                         {"pod": 2, "data": 2, "model": 8}):
                for fl in TC.flag_subsets(sorted(tp.flags)):
                    assert tp.mapping(tcfg, axes, fl, ts) == \
                        jp.mapping(jcfg, axes, fl, js)


def test_sweep_spec_maps_reference_kernels_and_refuses_later_axes(tmp_path):
    path = tmp_path / "spec.json"
    path.write_text('{"providers": {"fsdp": []}, "clauses": {"kernel": '
                    '["xla", "pallas"]}, "globals": {"microbatches": [1, 2]}}')
    spec = TC.load_sweep_json(str(path))
    assert spec.clauses["kernel"] == ("plain", "cuda")
    assert spec.globals["microbatches"] == (1, 2)
    plan = {"provider": "fsdp", "flags": [],
            "clause": vars(JClause(kernel="pallas"))}
    assert TC.Combination.from_json(plan).clause.kernel == "cuda"
    # the mesh axis is ported: its points read and write as the reference's
    meshes = {"meshes": [None, {"data": 2, "model": 2}]}
    tspec = TC.SweepSpec.from_json(meshes)
    assert [m.key() for m in tspec.meshes] == ["local", "data2xmodel2[any]"]
    assert tspec.to_json()["meshes"] == \
        JC.SweepSpec.from_json(meshes).to_json()["meshes"]
    # the kernel axis is ported (tests/test_torch_autotune.py): its
    # kernel names map too
    assert TC.SweepSpec.from_json({"kernels": {"kernel": ["xla"]}}
                                  ).kernel_space == {"kernel": ("plain",)}


def test_row_and_effective_cids_follow_reference_contract():
    c = TC.Combination("fsdp", frozenset(), SegmentClause())
    kn = TC.GlobalKnobs(microbatches=2)
    assert TC.row_cid(c) == c.cid == TC.row_cid(c, TC.GlobalKnobs())
    assert TC.row_cid(c, kn) == f"{c.cid}@{kn.kid}"
    jc = JC.Combination("fsdp", frozenset(), JClause(kernel="xla"))
    # clause fields outside the relevant set are invisible: the port's
    # effective cid of a projection without the kernel equals the
    # reference's
    rel = frozenset({"remat", "block_q"})
    assert TC.effective_cid(c, rel, "local", kn, frozenset({"microbatches"})
                            ) == JC.effective_cid(
        jc, rel, "local", JC.GlobalKnobs(microbatches=2),
        frozenset({"microbatches"}))
    # under a mesh point the mapping key is the reference's, byte for byte
    from repro.core.meshspec import MeshSpec as JMeshSpec
    from repro_torch.core.meshspec import MeshSpec
    tcfg, jcfg = get_arch("granite-8b").smoke(), jget_arch("granite-8b").smoke()
    for tseg, jseg in zip(fragment(tcfg), jfragment(jcfg)):
        for prov in ("tensor_par", "fsdp"):
            tc = TC.Combination(prov, frozenset(), SegmentClause())
            jc = JC.Combination(prov, frozenset(), JClause())
            assert TC.mapping_key(tcfg, MeshSpec.of(data=2, model=2), tc,
                                  tseg) == JC.mapping_key(
                jcfg, JMeshSpec.of(data=2, model=2), jc, jseg) != "local"
    assert TC.mapping_key(None, None, c, None) == "local"


# --- cost model ----------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ARCHS))
def test_cost_model_matches_reference(name):
    jhw, thw = _hw_pair()
    for smoke in (True, False):
        jcfg, tcfg = _cfgs(name, smoke)
        assert TCM.active_params(tcfg) == JCM.active_params(jcfg)
        for sname in SHAPES:
            jsh, tsh = jget_shape(sname), get_shape(sname)
            assert math.isclose(TCM.model_flops(tcfg, tsh),
                                JCM.model_flops(jcfg, jsh), rel_tol=1e-12)
            for js, ts in zip(jfragment(jcfg), fragment(tcfg)):
                assert math.isclose(
                    TCM.segment_forward_flops(tcfg, tsh, ts),
                    JCM.segment_forward_flops(jcfg, jsh, js), rel_tol=1e-12)
                for remat in ("none", "dots", "full"):
                    for mb in (1, 2):
                        tb = TCM.combo_lower_bound(
                            tcfg, tsh, ts,
                            TC.Combination("fsdp", frozenset(),
                                           SegmentClause(remat=remat)),
                            1, thw, knobs=TC.GlobalKnobs(microbatches=mb))
                        jb = JCM.combo_lower_bound(
                            jcfg, jsh, js,
                            JC.Combination("fsdp", frozenset(),
                                           JClause(remat=remat)),
                            1, jhw, knobs=JC.GlobalKnobs(microbatches=mb))
                        assert math.isclose(tb, jb, rel_tol=1e-12)


def test_h100_is_the_default_and_no_tpu_constant_is_left():
    assert TCM.H100.peak_flops == 989e12 and TCM.H100.hbm_bw == 3.35e12
    assert not hasattr(TCM, "V5E")
    assert DryRunExecutor().cache_tag == "dryrun:h100-sxm"


# --- fusion --------------------------------------------------------------------

def _table(pkg, cm, cfg, seed):
    """segment -> [(combination, CostTerms)] from a seeded numpy table."""
    rng = np.random.default_rng(seed)
    clauses = [(r, k) for r in ("none", "dots") for k in ("xla", "pallas")]
    out = {}
    for s in pkg.fragment(cfg):
        rows = []
        for p in ("tensor_par", "fsdp"):
            for r, k in clauses:
                cl = (JClause if pkg is JPKG else SegmentClause)(
                    remat=r, kernel=k if pkg is JPKG else TC.port_kernel(k))
                t = rng.uniform(0.1, 1.0, 3)
                rows.append((pkg.Combination(p, frozenset(), cl),
                             cm.CostTerms(*t)))
        out[s.name] = rows
    return out


class _Pkg:
    def __init__(self, fragment_, combination):
        self.fragment = fragment_
        self.Combination = combination


JPKG = _Pkg(jfragment, JC.Combination)
TPKG = _Pkg(fragment, TC.Combination)


def _plan_key(plan):
    return ({k: _clause_json(c) for k, c in plan.segments.items()},
            plan.knobs.to_json())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fusion_matches_reference(seed):
    jcfg, tcfg = _cfgs("recurrentgemma-2b", smoke=False)
    jshape, tshape = jget_shape("train_4k"), get_shape("train_4k")
    jt = _table(JPKG, JCM, jcfg, seed)
    tt = _table(TPKG, TCM, tcfg, seed)
    for bc in (False, True):
        jp = JF.fuse(jcfg, jshape, None, jt, boundary_costs=bc)
        tp = TF.fuse(tcfg, tshape, None, tt, boundary_costs=bc)
        assert _plan_key(tp) == _plan_key(jp)
        assert tp.meta["predicted_total_s"] == jp.meta["predicted_total_s"]
    # meshless, the Viterbi chooses the argmin's plan
    assert _plan_key(TF.fuse(tcfg, tshape, None, tt, boundary_costs=True)) \
        == _plan_key(TF.fuse(tcfg, tshape, None, tt))
    kn = [(JC.GlobalKnobs(microbatches=m), TC.GlobalKnobs(microbatches=m))
          for m in (1, 2, 4)]
    jper = {j.kid: _table(JPKG, JCM, jcfg, seed + 10 * i)
            for i, (j, _) in enumerate(kn)}
    tper = {t.kid: _table(TPKG, TCM, tcfg, seed + 10 * i)
            for i, (_, t) in enumerate(kn)}
    jp = JF.fuse_joint(jcfg, jshape, None, jper, [j for j, _ in kn])
    tp = TF.fuse_joint(tcfg, tshape, None, tper, [t for _, t in kn])
    assert _plan_key(tp) == _plan_key(jp)
    assert tp.meta["per_knob_total_s"] == jp.meta["per_knob_total_s"]
    (jb, jtot), (tb, ttot) = JF.best_uniform(jcfg, jt), \
        TF.best_uniform(tcfg, tt)
    assert _plan_key(tb) == _plan_key(jb) and ttot == jtot
    # the mesh axis: one local point fuses the same plan, tagged with it
    from repro.core.meshspec import LOCAL as JLOCAL
    from repro_torch.core.meshspec import LOCAL
    jm = JF.fuse_joint(jcfg, jshape, None, {JLOCAL.mid: jper},
                       [j for j, _ in kn], mesh_points=[JLOCAL])
    tm = TF.fuse_joint(tcfg, tshape, None, {LOCAL.mid: tper},
                       [t for _, t in kn], mesh_points=[LOCAL])
    assert _plan_key(tm) == _plan_key(jm) == _plan_key(tp)
    assert tm.mesh == LOCAL and tm.meta["per_mesh_total_s"] == \
        jm.meta["per_mesh_total_s"]


# --- timer: segment programs on the same weights and inputs ----------------------

def _flat_j(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_t(tree, prefix=()):
    if isinstance(tree, (tuple, list)):
        tree = dict(enumerate(tree))
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_t(v, prefix + (str(k),)))
        return out
    if not isinstance(tree, torch.Tensor):
        return {}
    return {"/".join(prefix): tensor_to_numpy(tree).astype(np.float32)}


def _copy_in(dst, src):
    """Write the reference's arrays ``src`` into the port's float tensors
    ``dst`` (a tensor or a tree of them; integers and ``pos`` are zero in
    both packages)."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_in(dst[k], src[k])
    elif isinstance(dst, torch.Tensor) and dst.is_floating_point():
        with torch.no_grad():
            dst.copy_(torch.from_numpy(np.array(src, np.float32)))


def _program_cases():
    for name in ("granite-8b", "recurrentgemma-2b", "xlstm-125m"):
        cfg = get_arch(name).smoke()
        for sname in SHAPES:
            for seg in fragment(cfg):
                kernels = ("plain", "cuda") if seg.kind == "stack" \
                    else ("plain",)
                for k in kernels:
                    yield pytest.param(name, sname, seg.name, k, 1,
                                       id=f"{name}-{sname}-{seg.name}-{k}")
    # a stub frontend's embed segment times the embedding of zero tokens,
    # as the reference's, and its block and head segments are the dense
    # ones; a tied head (starcoder2-3b) reads the embedding table
    for name, segname, kernel in (("phi-3-vision-4.2b", "embed", "plain"),
                                  ("phi-3-vision-4.2b", "g0", "cuda"),
                                  ("phi-3-vision-4.2b", "head", "plain"),
                                  ("starcoder2-3b", "head", "plain")):
        for sname in ("train_4k", "prefill_32k"):
            yield pytest.param(name, sname, segname, kernel, 1,
                               id=f"{name}-{sname}-{segname}-{kernel}")
    # gradient accumulation over two batch slices
    for segname in ("g0", "head"):
        yield pytest.param("granite-8b", "train_4k", segname, "plain", 2,
                           id=f"granite-8b-train_4k-{segname}-mb2")


@pytest.mark.parametrize("name,sname,segname,kernel,mb", _program_cases())
def test_segment_program_matches_reference(name, sname, segname, kernel,
                                           mb):
    jcfg, tcfg = _cfgs(name)
    jshape, tshape = jget_shape(sname).smoke(), get_shape(sname).smoke()
    jseg = [s for s in jfragment(jcfg) if s.name == segname][0]
    tseg = [s for s in fragment(tcfg) if s.name == segname][0]
    fields = dict(block_q=16, block_k=16, mlstm_chunk=16)
    jfn, jargs, _ = jsegment_program(
        jcfg, jshape, jseg,
        JC.Combination("fsdp", frozenset(),
                       JClause(kernel=KERNEL[kernel], **fields)), None,
        knobs=JC.GlobalKnobs(microbatches=mb))
    jconc = jax.tree.map(jmaterialize, jargs,
                         is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    want = _flat_j(jax.jit(jfn)(*jconc))

    tp = params_from_numpy(jax.tree.map(np.asarray, jconc[0]), "cpu")
    fn, args = segment_program(
        tcfg, tshape, tseg,
        TC.Combination("fsdp", frozenset(),
                       SegmentClause(kernel=kernel, **fields)),
        device="cpu", knobs=TC.GlobalKnobs(microbatches=mb), params=tp)
    for t, j in zip(args[1:], jconc[1:]):
        _copy_in(t, j)
    got = _flat_t(fn(*args))
    assert sorted(got) == sorted(want)
    for path in want:
        w, g = want[path], got[path]
        atol = 1e-5 + 1e-4 * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=path)


# --- the whole slice: both tuners on one table executor --------------------------

class TableExecutor:
    """Scores (segment kind, clause, knob point) from a seeded function of
    them, with the clause's kernel in the port's names: the same number in
    both packages."""
    parallel_safe = True
    n_chips = 1
    timeout_s = None
    cache_tag = "table"

    def __init__(self, cost_terms):
        self.cost_terms = cost_terms
        self.calls = 0

    def score_segment(self, cfg, shape, seg, combo, knobs=None, mesh=None):
        self.calls += 1
        cl = combo.clause
        key = (f"{seg.kind}|{cl.remat}|{TC.port_kernel(cl.kernel)}|"
               f"{cl.block_q}|{getattr(knobs, 'microbatches', 1)}")
        t = np.random.default_rng(zlib.crc32(key.encode())).uniform(
            0.1, 1.0, 3)
        return self.cost_terms(*map(float, t))


def _swept(tuner, executor, **kw):
    tuner.executor = executor
    return tuner.sweep(clause_space=SPACE, max_flags=1,
                       global_space={"microbatches": (1, 2)},
                       static_checks="off", **kw)


def test_whole_tuner_matches_reference():
    jcfg, tcfg = _cfgs("granite-8b")
    jshape, tshape = jget_shape("train_4k").smoke(), \
        get_shape("train_4k").smoke()
    jt = JTuner(jcfg, jshape, None, executor="dryrun")
    tt = ComParTuner(tcfg, tshape, device="cpu", executor="dryrun")
    jplan, jrep = _swept(jt, TableExecutor(JCM.CostTerms))
    tplan, trep = _swept(tt, TableExecutor(TCM.CostTerms))
    assert _plan_key(tplan) == _plan_key(jplan)
    assert tplan.meta["predicted_total_s"] == \
        jplan.meta["predicted_total_s"]
    for f in ("n_combinations", "n_done", "n_inapplicable", "paper_count",
              "per_knob_total_s", "n_scored", "n_shared"):
        assert getattr(trep, f) == getattr(jrep, f), f
    assert trep.n_inapplicable > 0          # expert_par on the dense stack
    assert tt.baselines(global_space={"microbatches": (1, 2)}) == \
        jt.baselines(global_space={"microbatches": (1, 2)})
    assert tt.baselines() == jt.baselines()


# --- the DB ----------------------------------------------------------------------

def test_db_schema_matches_reference():
    def schema(conn):
        return sorted(conn.execute(
            "SELECT type, name, sql FROM sqlite_master").fetchall())
    assert schema(SweepDB().conn) == schema(JSweepDB().conn)


def test_continue_mode_rescores_nothing(tmp_path):
    cfg, shape = get_arch("granite-8b").smoke(), \
        get_shape("train_4k").smoke()
    path = str(tmp_path / "sweep.db")
    first = ComParTuner(cfg, shape, device="cpu", db=SweepDB(path),
                        project="p")
    plan, rep = _swept(first, TableExecutor(TCM.CostTerms))
    assert rep.n_scored > 0
    again = ComParTuner(cfg, shape, device="cpu", db=SweepDB(path),
                        project="p", mode="continue")
    ex = TableExecutor(TCM.CostTerms)
    plan2, rep2 = _swept(again, ex)
    assert ex.calls == 0 and rep2.n_scored == 0
    assert plan2.to_json() == plan.to_json()
    # a new project on the same DB is served from the score cache
    third = ComParTuner(cfg, shape, device="cpu", db=SweepDB(path),
                        project="q")
    ex3 = TableExecutor(TCM.CostTerms)
    plan3, rep3 = _swept(third, ex3)
    assert ex3.calls == 0 and rep3.n_cached == rep3.n_combinations
    assert _plan_key(plan3) == _plan_key(plan)


# --- the executors ---------------------------------------------------------------

def test_wallclock_sweep_on_cpu_scores_every_row():
    cfg, shape = get_arch("granite-8b").smoke(), \
        get_shape("train_4k").smoke()
    tuner = ComParTuner(cfg, shape, device="cpu", executor="wallclock")
    tuner.executor.repeats = 1
    plan, rep = tuner.sweep(["fsdp"], {"kernel": ("plain", "cuda"),
                                       "block_q": (16,)})
    rows = tuner.db.results(tuner.project)
    assert rows and all(r["status"] == "done" for r in rows)
    assert rep.n_scored == 4                 # embed, head, 2 stack programs
    d = rows[0]["cost"]["detail"]
    assert d["wall_s"] > 0 and len(d["repeats_s"]) == 1
    assert tuner.executor.cache_tag.startswith("wallclock:r1:cpu:")
    assert set(plan.segments) == {"embed", "g0", "head"}


@pytest.mark.parametrize("name,sname", [("granite-8b", "train_4k"),
                                        ("recurrentgemma-2b", "train_4k"),
                                        ("xlstm-125m", "prefill_32k"),
                                        ("granite-8b", "decode_32k")])
def test_dry_run_is_deterministic_and_sound(name, sname):
    cfg, shape = get_arch(name).smoke(), get_shape(sname).smoke()
    space = {"remat": ("none", "dots"), "kernel": ("plain", "cuda"),
             "block_q": (16,), "mlstm_chunk": (16,)}
    tuner = ComParTuner(cfg, shape, device="cpu", executor="dryrun")
    plan, rep = tuner.sweep(["fsdp"], space)
    assert rep.n_done == rep.n_combinations
    table = tuner.audit_soundness()
    assert all(v["max"] <= 1.0 for v in table.values())
    # scoring a row's program again gives its recorded terms exactly
    for r in tuner.db.results(tuner.project)[-4:]:
        seg = [s for s in fragment(cfg) if s.name == r["segment"]][0]
        again = tuner.executor.score_segment(cfg, shape, seg, r["combo"])
        assert again.as_dict() == r["cost"]


def test_validate_rejects_nothing_the_reference_accepts():
    """``validate=True`` runs the black-box check (``core/validator.py``)
    on every combination before it is scored."""
    cfg, shape = get_arch("recurrentgemma-2b").smoke(), \
        get_shape("prefill_32k").smoke()
    tuner = ComParTuner(cfg, shape, device="cpu", validate=True)
    plan, rep = tuner.sweep(["fsdp"], {"kernel": ("plain", "cuda"),
                                       "block_q": (16,)})
    assert rep.n_invalid == 0 and rep.n_done == rep.n_combinations


def test_dry_run_threads_count_their_own_kernels():
    """Each thread's OpCounter sees only its own program's kernels: a
    4-thread dry run records the sequential run's terms."""
    cfg, shape = get_arch("recurrentgemma-2b").smoke(), \
        get_shape("prefill_32k").smoke()
    space = {"kernel": ("plain", "cuda"), "block_q": (16, 32),
             "mlstm_chunk": (16,)}
    costs = []
    for workers in (1, 4):
        tuner = ComParTuner(cfg, shape, device="cpu")
        tuner.sweep(["fsdp"], space, workers=workers)
        costs.append({(r["segment"], r["cid"]): r["cost"]
                      for r in tuner.db.results(tuner.project)})
    assert costs[0] == costs[1]


def test_dry_run_counts_fewer_bytes_for_the_attention_kernel():
    cfg, shape = get_arch("granite-8b").smoke(), \
        get_shape("prefill_32k").smoke()
    seg = fragment(cfg)[1]
    ex = DryRunExecutor()
    counts = {k: ex.count(cfg, shape, seg, TC.Combination(
        "fsdp", frozenset(), SegmentClause(kernel=k, block_q=16)))
        for k in ("plain", "cuda")}
    assert counts["cuda"].bytes < counts["plain"].bytes
    fa = counts["cuda"].flops_by_op()["flash_attention"]
    assert "flash_attention" not in counts["plain"].flops_by_op()
    B, S, H, D = 4, 32, cfg.num_heads, cfg.head_dim_
    assert fa == cfg.num_layers * 4 * B * H * D * S * (S + 1) // 2
    # no device memory: the dry run's tensors are fake
    assert ex.score_segment(cfg, shape, seg, TC.Combination(
        "fsdp", frozenset(), SegmentClause(kernel="cuda"))).total_s > 0


def test_op_counter_counts_every_product():
    from torch._subclasses.fake_tensor import FakeTensorMode
    M, N, K, Bt = 8, 12, 16, 3
    with FakeTensorMode():
        a, b = torch.randn(M, K), torch.randn(K, N)
        ba, bb, bc = torch.randn(Bt, M, K), torch.randn(Bt, K, N), \
            torch.randn(Bt, M, N)
        c = torch.randn(M, N)
        q = torch.randn(1, 2, M, K)
        cases = {
            "mm": (lambda: a @ b, 2 * M * N * K),
            "addmm": (lambda: torch.addmm(c, a, b), 2 * M * N * K),
            "bmm": (lambda: torch.bmm(ba, bb), 2 * Bt * M * N * K),
            "baddbmm": (lambda: torch.baddbmm(bc, ba, bb),
                        2 * Bt * M * N * K),
            "sdpa": (lambda: torch.nn.functional.scaled_dot_product_attention(
                q, q, q), 2 * 2 * 2 * M * M * K),
        }
        for name, (fn, flops) in cases.items():
            with OpCounter() as cnt:
                fn()
            assert cnt.flops >= flops, name
            assert cnt.bytes > 0, name


def test_later_axes_raise_naming_their_roadmap_item(tmp_path):
    """Nothing of the mesh axis is pending any more.  The mesh axis runs:
    a point this process cannot build (a 2-device point, one rank) fails
    its rows as transient and the plan takes the local point; a fixed
    mesh it cannot build is refused.  The sharded model paths run on a
    (1, 1) mesh: an engine under ``decode_shardmap``
    and one under ``moe_dispatch="a2a"`` serve the same tokens as the
    meshless engine of the same plan.  The mesh axis is held in
    tests/test_torch_mesh_axis.py, the meshes themselves in
    tests/test_torch_{sharding,distributed,optimizations}.py."""
    from repro_torch.core.meshspec import LOCAL, MeshUnsatisfiable
    from repro_torch.core.plan import uniform_plan
    from repro_torch.launch.mesh import destroy_group, device_mesh
    from repro_torch.models.model import model_specs
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import ServeEngine
    cfg, shape = get_arch("granite-8b").smoke(), \
        get_shape("train_4k").smoke()
    tuner = ComParTuner(cfg, shape, device="cpu")
    plan, rep = tuner.sweep(["fsdp"], mesh_space=[None, {"data": 2}],
                            max_flags=0, transient_retries=0)
    assert plan.mesh == LOCAL and rep.n_mesh_points == 2
    assert rep.n_failed == rep.n_combinations // 2
    with pytest.raises(MeshUnsatisfiable, match="needs 2"):
        ComParTuner(cfg, shape, device="cpu", mesh={"data": 2})
    reqs = [{"rid": "a", "prompt": (1, 2), "max_new_tokens": 2},
            {"rid": "b", "prompt": (3, 4, 5), "max_new_tokens": 3}]
    moe = get_arch("qwen3-moe-30b-a3b").smoke()
    cases = [(cfg, uniform_plan(cfg, "tensor_par", clause=SegmentClause(
        decode_shardmap=True))),
        (moe, uniform_plan(moe, "expert_par", clause=SegmentClause(
            moe_dispatch="a2a")))]
    try:
        mesh = device_mesh((1, 1), ("data", "model"), "cpu")
        for c, p in cases:
            params = init_params(model_specs(c),
                                 torch.Generator().manual_seed(0), "cpu")
            meshed = ServeEngine(c, p, params=params, mesh=mesh,
                                 device="cpu").run(reqs)
            meshless = ServeEngine(c, p, params=params,
                                   device="cpu").run(reqs)
            assert {k: r.tokens for k, r in meshed.items()} == \
                {k: r.tokens for k, r in meshless.items()}, c.name
            assert all(len(r.tokens) for r in meshed.values())
    finally:
        destroy_group()


# --- the example -----------------------------------------------------------------

def test_quickstart_runs_on_the_cpu(tmp_path):
    out = quickstart.main(["--smoke", "--device", "cpu", "--steps", "2",
                           "--plan-out", str(tmp_path / "plan.json")])
    assert len(out["losses"]) == 2
    assert all(math.isfinite(x) for x in out["losses"])
    assert out["report"].n_done == out["report"].n_combinations
    assert (tmp_path / "plan.json").exists()
    assert out["launches_per_step"]["flash_attention"] == 0   # the CPU

