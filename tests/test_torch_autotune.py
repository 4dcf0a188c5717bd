"""The port's kernel autotuner (``kernels/autotune.py``) and the tuner's
kernel axis against the JAX package's, on the CPU.

Exact, with the clause ``kernel`` names mapped (``"plain"`` <->
``"xla"``, ``"cuda"`` <-> ``"pallas"``): ``segment_ops``, ``_op_dims``
(and the cache key, given one executor tag: the tags differ by design),
``op_variants`` and ``schedule_key`` for every registered arch and shape
kind; ``tune_segments`` with ``_measure_one`` replaced, in both
packages, by one deterministic table (the same ``fields``, ``surviving``,
``floors`` and report; the table gives every ``cuda``/``pallas`` variant
of an op one outcome, as the port's CUDA kernels ignore the tiles).  One
departure: the port's top k counts programs, and all of an op's ``cuda``
keys are one program, so its survivors are the reference's survivors
widened to whole programs (``_with_ties``: the reference's own ranking,
walked program by program).  And a
sweep with ``kernel_space`` registers the reference's rows (a row id
hashes the clause, which names the kernel, so the port's rows are
compared through their reference-named twins).
"""
import zlib

import numpy as np
import pytest

import repro.kernels.autotune as JAT
from repro.configs import get_arch as jget_arch
from repro.configs import get_shape as jget_shape
from repro.core import combinator as JC
from repro.core import cost_model as JCM
from repro.core.db import SweepDB as JSweepDB
from repro.core.segment import fragment as jfragment
from repro.core.tuner import ComParTuner as JTuner
from repro.models.context import SegmentClause as JClause
import repro_torch.kernels.autotune as AT
from repro_torch.configs import get_arch, get_shape
from repro_torch.configs.registry import ARCHS
from repro_torch.core import combinator as TC
from repro_torch.core import cost_model as TCM
from repro_torch.core.db import SweepDB
from repro_torch.core.executor import WallClockExecutor
from repro_torch.core.segment import fragment
from repro_torch.core.tuner import ComParTuner
from repro_torch.models.context import SegmentClause

from test_torch_sweep import KERNEL, TableExecutor, _plan_key

SHAPES = ("train_4k", "prefill_32k", "decode_32k")
NAMES = {"kernel=xla": "kernel=plain", "kernel=pallas": "kernel=cuda"}


def _port_key(vkey: str) -> str:
    """A reference schedule key in the port's kernel names."""
    return ",".join(NAMES.get(p, p) for p in vkey.split(","))


def _port_fields(fields):
    return {k: TC.port_kernel(v) if k == "kernel" else v
            for k, v in fields.items()}


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_op_signatures_match_reference(name, smoke):
    jcfg, tcfg = jget_arch(name), get_arch(name)
    if smoke:
        jcfg, tcfg = jcfg.smoke(), tcfg.smoke()
    assert AT.OP_FIELDS == JAT.OP_FIELDS
    assert AT.KERNEL_CACHE_VERSION == JAT.KERNEL_CACHE_VERSION
    for sname in SHAPES:
        jsh, tsh = jget_shape(sname), get_shape(sname)
        for js, ts in zip(jfragment(jcfg), fragment(tcfg)):
            ops = AT.segment_ops(tcfg, tsh, ts)
            assert ops == JAT.segment_ops(jcfg, jsh, js)
            for op in ops:
                assert AT._op_dims(op, tcfg, tsh) == \
                    JAT._op_dims(op, jcfg, jsh)
                assert AT.cache_key(op, tcfg, tsh, "tag") == \
                    JAT.cache_key(op, jcfg, jsh, "tag")


@pytest.mark.parametrize("space", [
    JAT.DEFAULT_KERNEL_SPACE, {"kernel": ("xla",)},
    {"kernel": ("xla", "pallas"), "block_k": (128,), "mlstm_chunk": (8,)}])
def test_op_variants_and_schedule_keys_match_reference(space):
    assert AT.DEFAULT_KERNEL_SPACE == TC.port_space(JAT.DEFAULT_KERNEL_SPACE)
    for op in AT.OP_FIELDS:
        jv = JAT.op_variants(op, space)
        tv = AT.op_variants(op, TC.port_space(space))
        assert tv == [_port_fields(f) for f in jv]
        assert [AT.schedule_key(f) for f in tv] == \
            [_port_key(JAT.schedule_key(f)) for f in jv]
    jcl = JClause(kernel="pallas", block_q=256)
    tcl = SegmentClause(kernel="cuda", block_q=256)
    for fields in AT.OP_FIELDS.values():
        assert AT.clause_schedule(tcl, fields) == \
            _port_key(JAT.clause_schedule(jcl, fields))


def _table(op, fields):
    """One deterministic outcome per (op, variant), fields in the port's
    names: every cuda variant of an op shares one; one plain variant of
    flash-attention fails."""
    k = fields["kernel"]
    key = f"{op}|{k}" if k == "cuda" else f"{op}|{AT.schedule_key(fields)}"
    rng = np.random.default_rng(zlib.crc32(key.encode()))
    t, flops = rng.uniform(0.1, 1.0), rng.uniform(1e6, 1e9)
    if op == "flash_attention" and k == "plain" and \
            fields.get("block_q") == 256 and fields.get("block_k") == 512:
        return {"status": "failed", "error": "table"}
    return {"status": "done", "time_s": float(t), "flops": float(flops)}


class _TableHw:
    """An executor with a hardware model (so the floors are kept)."""
    hw = TCM.H100
    cache_tag = "table"


def _patch_tables(monkeypatch):
    calls = []

    def port(op, fields, cfg, shape, executor):
        calls.append((op, AT.schedule_key(fields)))
        return dict(_table(op, fields))

    def ref(op, fields, cfg, shape, executor):
        return dict(_table(op, _port_fields(fields)))
    monkeypatch.setattr(AT, "_measure_one", port)
    monkeypatch.setattr(JAT, "_measure_one", ref)
    return calls


def _program(vkey: str) -> str:
    """A reference schedule's program: every ``pallas`` key of a segment
    is the port's one ``cuda`` program (the kernel field is shared by all
    of a segment's ops); each ``xla`` key is its own."""
    return "pallas" if "kernel=pallas" in vkey.split(",") else vkey


def _with_ties(run, top_k):
    """The reference's tuning at ``top_k`` with each segment's survivors
    widened to the port's rule (a departure from the reference): walk the
    reference's own ranking (a key's rank is the least k whose survivors
    hold it) and keep every key of the first ``top_k`` distinct programs,
    so tied ``pallas`` keys survive together beside the next program."""
    j = run(top_k)
    n = max([r["schedules"] for r in j.report["per_segment"].values()] +
            [1])
    rank = {}
    for k in range(1, n + 1):
        for seg, keep in run(k).surviving.items():
            for key in keep:
                rank.setdefault(seg, {}).setdefault(key, k)
    per_segment = dict(j.report["per_segment"])
    for seg, ranks in rank.items():
        progs, keep = [], set()
        for key in sorted(ranks, key=lambda key: (ranks[key], key)):
            if _program(key) not in progs:
                if len(progs) == top_k:
                    break
                progs.append(_program(key))
            keep.add(key)
        assert j.surviving[seg] <= keep
        j.surviving[seg] = keep
        per_segment[seg] = dict(per_segment[seg], kept=len(keep))
    j.report = dict(j.report, per_segment=per_segment)
    return j


def _same_tuning(t, j):
    assert t.fields == j.fields
    assert t.surviving == {s: {_port_key(k) for k in v}
                           for s, v in j.surviving.items()}
    assert t.floors == {s: {_port_key(k): f for k, f in v.items()}
                        for s, v in j.floors.items()}
    tr, jr = dict(t.report), dict(j.report)
    assert tr.pop("per_op_best") == {op: _port_key(k) for op, k in
                                     jr.pop("per_op_best").items()}
    assert tr == jr


@pytest.mark.parametrize("name", ["granite-8b", "recurrentgemma-2b",
                                  "xlstm-125m", "qwen3-moe-30b-a3b"])
def test_tune_segments_matches_reference_on_one_table(monkeypatch, name):
    calls = _patch_tables(monkeypatch)
    jcfg, tcfg = jget_arch(name).smoke(), get_arch(name).smoke()
    space = dict(JAT.DEFAULT_KERNEL_SPACE, remat=("none",))
    for sname in SHAPES:
        jsh, tsh = jget_shape(sname).smoke(), get_shape(sname).smoke()
        tdb, jdb = SweepDB(), JSweepDB()
        for top_k in (1, 2, 16):
            calls.clear()
            t = AT.tune_segments(tdb, tcfg, tsh, fragment(tcfg),
                                 TC.port_space(space), _TableHw(),
                                 top_k=top_k)
            j = _with_ties(lambda k: JAT.tune_segments(
                jdb, jcfg, jsh, jfragment(jcfg), space, _TableHw(),
                top_k=k), top_k)
            _same_tuning(t, j)
            if top_k == 1:
                # the cold run: the port runs each op's cuda program once
                n_ops = len(t.variants)
                assert len([c for c in calls if "kernel=cuda" in c[1]]) \
                    == n_ops
                assert t.report["n_timed"] == t.report["n_variants"]
            else:                  # the DB answers every later run
                assert calls == [] and t.report["n_timed"] == 0


def test_top_k_counts_tied_cuda_keys_as_one_program():
    """Two tied cuda keys are one program: at top_k=2 both survive beside
    the cheapest plain schedule, which the reference's key count drops."""
    ops = {"flash_attention": 4}
    ranked = sorted([
        (1.0, "block_k=512,block_q=256,kernel=cuda"),
        (1.0, "block_k=1024,block_q=256,kernel=cuda"),
        (3.0, "block_k=512,block_q=256,kernel=plain"),
        (4.0, "block_k=1024,block_q=256,kernel=plain")])
    assert AT._top_programs(ranked, ops, 2) == {
        "block_k=512,block_q=256,kernel=cuda",
        "block_k=1024,block_q=256,kernel=cuda",
        "block_k=512,block_q=256,kernel=plain"}
    assert AT._top_programs(ranked, ops, 1) == {
        "block_k=512,block_q=256,kernel=cuda",
        "block_k=1024,block_q=256,kernel=cuda"}
    assert len(AT._top_programs(ranked, ops, 16)) == 4
    assert AT.schedule_program(ranked[0][1], ops) == \
        AT.schedule_program(ranked[1][1], ops) == \
        (("flash_attention", "cuda"),)


def test_cuda_variants_share_one_program(monkeypatch):
    """On the CPU (the wall clock): one run of the cuda program per op,
    its outcome under every cuda key, persisted under each; a cuda key
    missing from the cache takes a cached cuda row's outcome."""
    cfg, shape = get_arch("granite-8b").smoke(), \
        get_shape("prefill_32k").smoke()
    ex = WallClockExecutor("cpu", repeats=1)
    calls = []
    measure = AT._measure_one

    def counted(op, fields, *a):
        calls.append(AT.schedule_key(fields))
        return measure(op, fields, *a)
    monkeypatch.setattr(AT, "_measure_one", counted)
    db = SweepDB()
    res, timed, cached = AT.measure_op(db, "flash_attention", cfg, shape,
                                       AT.DEFAULT_KERNEL_SPACE, ex)
    cuda = {k: e for k, e in res.items() if "kernel=cuda" in k}
    assert len(cuda) == 4 and len(calls) == 5 and (timed, cached) == (8, 0)
    assert len({(e["status"], e["time_s"]) for e in cuda.values()}) == 1
    assert sum(e["program"] != k for k, e in cuda.items()) == 3
    key = AT.cache_key("flash_attention", cfg, shape, ex.cache_tag)
    assert sorted(db.kernel_get(key)) == sorted(res)
    calls.clear()
    again, timed, cached = AT.measure_op(
        db, "flash_attention", cfg, shape, AT.DEFAULT_KERNEL_SPACE, ex)
    assert calls == [] and (timed, cached) == (0, 8)
    gone = sorted(cuda)[0]
    db.conn.execute("DELETE FROM kernel_cache WHERE variant=?", (gone,))
    res3, timed, _ = AT.measure_op(db, "flash_attention", cfg, shape,
                                   AT.DEFAULT_KERNEL_SPACE, ex)
    assert calls == [] and timed == 0
    assert res3[gone]["time_s"] == cuda[gone]["time_s"]


def _ref_rid(r):
    """The reference's row id of a port row (its clause, kernel renamed)."""
    cl = dict(vars(r["combo"].clause), kernel=KERNEL[r["combo"].clause.kernel])
    jc = JC.Combination(r["combo"].provider, r["combo"].flags, JClause(**cl))
    kn = JC.GlobalKnobs(**vars(r["knobs"])) if r["knobs"] else None
    return r["segment"], JC.row_cid(jc, kn)


@pytest.mark.parametrize("name,sname", [("granite-8b", "train_4k"),
                                        ("xlstm-125m", "prefill_32k"),
                                        ("granite-8b", "decode_32k")])
def test_kernel_sweep_registers_reference_rows(monkeypatch, name, sname):
    _patch_tables(monkeypatch)
    tune = JAT.tune_segments
    monkeypatch.setattr(JAT, "tune_segments", lambda *a, top_k=2, **k:
                        _with_ties(lambda n: tune(*a, top_k=n, **k), top_k))
    jcfg, tcfg = jget_arch(name).smoke(), get_arch(name).smoke()
    jsh, tsh = jget_shape(sname).smoke(), get_shape(sname).smoke()
    kw = dict(clause_space={"remat": ("none", "dots")}, max_flags=1,
              kernel_space={"kernel": ("xla", "pallas"), "block_q": (16, 32),
                            "mlstm_chunk": (16, 24)},
              kernel_top_k=2, static_checks="off")
    jt = JTuner(jcfg, jsh, None, executor="dryrun")
    tt = ComParTuner(tcfg, tsh, device="cpu", executor="dryrun")
    jt.executor = TableExecutor(JCM.CostTerms)
    tt.executor = TableExecutor(TCM.CostTerms)
    jplan, jrep = jt.sweep(**kw)
    tplan, trep = tt.sweep(**kw)
    jrows = {(r["segment"], r["cid"]) for r in jt.db.results(jt.project)}
    trows = {_ref_rid(r) for r in tt.db.results(tt.project)}
    assert trows == jrows and trep.n_combinations == jrep.n_combinations
    assert _plan_key(tplan) == _plan_key(jplan)
    tk, jk = dict(trep.kernel_tuning), dict(jrep.kernel_tuning)
    assert tk.pop("per_op_best") == {op: _port_key(k) for op, k in
                                     jk.pop("per_op_best").items()}
    assert tk == jk
    assert "kernel_tuning=variants:" in trep.summary()


@pytest.mark.parametrize("name,sname", [("granite-8b", "decode_32k"),
                                        ("granite-8b", "train_4k"),
                                        ("recurrentgemma-2b", "prefill_32k"),
                                        ("xlstm-125m", "prefill_32k")])
def test_dry_run_kernel_floors_stay_under_the_score(name, sname):
    """The real dry run with the kernel axis: the floors fed to the bound
    come from the op programs' counted flops (flash-decode's counted at
    the segment programs' position 0) and never overshoot a score."""
    cfg, shape = get_arch(name).smoke(), get_shape(sname).smoke()
    tuner = ComParTuner(cfg, shape, device="cpu", executor="dryrun")
    plan, rep = tuner.sweep(["fsdp"], {"remat": ("none",)},
                            kernel_space="auto", kernel_top_k=4,
                            max_flags=0, prune=True)
    assert rep.n_failed == 0 and rep.kernel_tuning["n_failed"] == 0
    assert any(tuner._kernel_tuning.floors.values())
    tuner.audit_soundness()
    if shape.kind == "decode":
        fields = {"kernel": "cuda", "block_k": 1024}
        mid = AT._count("flash_decode", fields, cfg, shape).flops
        floor = AT._measure_one("flash_decode", fields, cfg, shape,
                                tuner.executor)["flops"]
        assert floor < mid              # pos 0 counts one key, S//2 more


def test_kernel_space_arguments():
    cfg, shape = get_arch("granite-8b").smoke(), \
        get_shape("train_4k").smoke()
    tuner = ComParTuner(cfg, shape, device="cpu")
    with pytest.raises(ValueError, match="only string value is 'auto'"):
        tuner.sweep(["fsdp"], kernel_space="fast")
    spec = TC.SweepSpec.from_json({"providers": {"fsdp": []},
                                   "kernels": {"kernel": ["xla", "pallas"],
                                               "block_q": [16]}})
    assert spec.kernel_space == {"kernel": ("plain", "cuda"),
                                 "block_q": (16,)}
    assert TC.SweepSpec.from_json(spec.to_json()) == spec
    with pytest.raises(ValueError, match="kernel_space"):
        tuner.sweep(spec=spec, kernel_space="auto")
    plan, rep = tuner.sweep(spec=spec, max_flags=0)
    assert rep.kernel_tuning["n_variants"] == 2
