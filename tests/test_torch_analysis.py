"""The port's static analyzer (``analysis/``, PlanLint) against the JAX
package's, on the CPU.

The rules the two packages share give the same diagnostics, exact (rule,
severity, segment, message, evidence), over a grid of points, with the
clause ``kernel`` names mapped (``"plain"`` <-> ``"xla"``, ``"cuda"`` <->
``"pallas"``): ``microbatch``, ``attn-chunk-fallback``, ``dtype-flow``
and the abstract-trace ``trace``.  ``chunk-clamp`` has its site on the
port's plain mLSTM path and on the reference's Pallas path: the port's at
``plain`` equals the reference's at ``pallas`` on every segment with an
mLSTM block (the port's RG-LRU takes no chunk, so its ``rec`` segments
give none).  The ``cuda-*`` rules are the port's own: each predicts a
refusal of a kernel wrapper (held to the raise itself on the card in
``tests/test_torch_cuda.py``).
"""
import dataclasses
import itertools
import json

import pytest

from repro.analysis import analyze_plan as janalyze_plan
from repro.analysis import analyze_point as janalyze_point
from repro.analysis.lint import main as jlint
from repro.configs import get_arch as jget_arch
from repro.configs import get_shape as jget_shape
from repro.core import combinator as JC
from repro.core import cost_model as JCM
from repro.core.plan import Plan as JPlan
from repro.core.plan import uniform_plan as juniform_plan
from repro.core.tuner import ComParTuner as JTuner
from repro.models.context import SegmentClause as JClause
import repro_torch.kernels.autotune as AT
from repro_torch.analysis import (Diagnostic, analyze_plan, analyze_point,
                                  errors, format_diagnostics, lint_schedule)
from repro_torch.analysis import rules as R
from repro_torch.analysis.lint import main as tlint
from repro_torch.configs import get_arch, get_shape
from repro_torch.configs.registry import ARCHS
from repro_torch.core import combinator as TC
from repro_torch.core import cost_model as TCM
from repro_torch.core.executor import DryRunExecutor
from repro_torch.core.plan import Plan, uniform_plan
from repro_torch.core.segment import fragment
from repro_torch.core.tuner import ComParTuner
from repro_torch.models.context import SegmentClause

from test_torch_sweep import KERNEL, TableExecutor, _plan_key

SHAPES = ("train_4k", "prefill_32k", "decode_32k")
SHARED = ("microbatch", "attn-chunk-fallback", "dtype-flow")
PORT_RULES = SHARED + ("chunk-clamp", "trace", "cuda-dtype",
                       "cuda-head-dim", "cuda-kv-heads", "cuda-align",
                       "cuda-mlstm-dh")


def _key(d):
    return (d.rule, d.severity, d.segment, d.message,
            json.dumps(d.evidence, sort_keys=True))


def _pair(kernel, **fields):
    """A (port, reference) combination pair; ``kernel`` in port names."""
    return (TC.Combination("fsdp", frozenset(),
                           SegmentClause(kernel=kernel, **fields)),
            JC.Combination("fsdp", frozenset(),
                           JClause(kernel=KERNEL[kernel], **fields)))


KNOBS = [dict(microbatches=1), dict(microbatches=3),
         dict(microbatches=2, opt_state_dtype="bfloat16")]


@pytest.mark.parametrize("name", ["granite-8b", "xlstm-125m",
                                  "recurrentgemma-2b", "qwen3-moe-30b-a3b"])
def test_shared_rules_match_reference_over_a_grid(name):
    tcfg, jcfg = get_arch(name).smoke(), jget_arch(name).smoke()
    mlstm_segs = {s.name for s in fragment(tcfg) if "mlstm" in s.pattern}
    n = 0
    for sname in SHAPES:
        tsh, jsh = get_shape(sname).smoke(), jget_shape(sname).smoke()
        for bq, mc, cu in itertools.product((16, 24), (16, 24),
                                            (True, False)):
            fields = dict(block_q=bq, mlstm_chunk=mc, cache_upcast=cu)
            for kn in KNOBS:
                tk, jk = TC.GlobalKnobs(**kn), JC.GlobalKnobs(**kn)
                for kernel in ("plain", "cuda"):
                    tc, jc = _pair(kernel, **fields)
                    t = analyze_point(tcfg, tsh, tc, knobs=tk)
                    j = janalyze_point(jcfg, jsh, jc, knobs=jk)
                    assert {d.rule for d in t} <= set(PORT_RULES)
                    assert [_key(d) for d in t if d.rule in SHARED] == \
                        [_key(d) for d in j if d.rule in SHARED]
                    assert not [d for d in t if d.rule.startswith("cuda")]
                    n += bool(t)
                # chunk-clamp: the port's plain path, the reference's Pallas
                tc, _ = _pair("plain", **fields)
                _, jc = _pair("cuda", **fields)
                tcc = [_key(d) for d in analyze_point(tcfg, tsh, tc,
                                                      knobs=tk)
                       if d.rule == "chunk-clamp"]
                jcc = [_key(d) for d in janalyze_point(jcfg, jsh, jc,
                                                       knobs=jk)
                       if d.rule == "chunk-clamp" and d.segment in mlstm_segs]
                assert tcc == jcc
                n += bool(tcc)
    assert n > 0                      # the grid diagnoses something


def test_trace_rule_matches_reference():
    tcfg, jcfg = get_arch("granite-8b").smoke(), \
        jget_arch("granite-8b").smoke()
    tsh, jsh = get_shape("train_4k").smoke(), jget_shape("train_4k").smoke()
    tc, jc = _pair("plain", block_q=16)
    for mb in (1, 3):
        t = analyze_point(tcfg, tsh, tc, knobs=TC.GlobalKnobs(microbatches=mb),
                          trace=True)
        j = janalyze_point(jcfg, jsh, jc,
                           knobs=JC.GlobalKnobs(microbatches=mb), trace=True)
        assert [_key(d) for d in t] == [_key(d) for d in j]
        assert (mb == 3) == any(d.rule == "trace" for d in t)
    # PyTorch has no buffer donation: the port never warns about it
    t = analyze_point(tcfg, tsh, tc, knobs=TC.GlobalKnobs(donate=False),
                      trace=True)
    assert not [d for d in t if d.rule == "donate-unshaped"]


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_cuda_rules_quiet_on_every_registered_arch(name):
    for cfg in (get_arch(name), get_arch(name).smoke()):
        for sname in SHAPES:
            shape = get_shape(sname)
            for seg in fragment(cfg):
                for op in AT.segment_ops(cfg, shape, seg):
                    assert R._cuda_refusals(op, cfg, shape) == []


def _refusals(cfg, shape):
    """rule -> sites (segment, op) of each cuda error at (cfg, shape)."""
    tc, _ = _pair("cuda", block_q=16)
    out = {}
    for d in analyze_point(cfg, shape, tc):
        if d.is_error:
            out.setdefault(d.rule, []).append((d.segment, d.message))
    return out


def test_cuda_rules_predict_each_wrapper_refusal(monkeypatch):
    g = get_arch("granite-8b").smoke()
    train, dec = get_shape("train_4k").smoke(), get_shape("decode_32k").smoke()
    cases = [
        (dataclasses.replace(g, head_dim=48), "cuda-head-dim",
         "flash_attention: head_dim 48 not compiled"),
        (dataclasses.replace(g, num_heads=6, num_kv_heads=4),
         "cuda-kv-heads", "flash_attention: heads 6 not a multiple of kv "
         "heads 4"),
        (dataclasses.replace(g, dtype="float16"), "cuda-dtype",
         "flash_attention: dtype torch.float16 not supported"),
    ]
    for cfg, rule, msg in cases:
        got = _refusals(cfg, train)
        assert list(got) == [rule] and got[rule][0][1].startswith(msg)
        assert got[rule][0][0] == "g0"
        # decode reaches flash-decode's wrapper, with its own message
        assert list(_refusals(cfg, dec)) == [rule]
        # the plain path has no such refusal
        plain, _ = _pair("plain", block_q=16)
        assert not errors(analyze_point(cfg, train, plain))
    assert _refusals(dataclasses.replace(g, num_heads=6, num_kv_heads=4),
                     dec)["cuda-kv-heads"][0][1] == \
        "flash_decode: 6 heads do not divide over 4 kv heads"
    x = get_arch("xlstm-125m").smoke()
    wide = dataclasses.replace(x, d_model=512, num_heads=2)   # dh 512 ok
    assert _refusals(wide, get_shape("prefill_32k").smoke()) == {}
    wider = dataclasses.replace(x, d_model=640, num_heads=2)  # dh 640
    assert _refusals(wider, get_shape("prefill_32k").smoke()) == {
        "cuda-mlstm-dh": [("g0", "mlstm: head dim 640 > 512")]}
    # the stride rules: no compiled head dim breaks them, so a head dim
    # that is not a multiple of 8 is compiled in for the test
    import sys
    build = sys.modules["repro_torch.kernels.build"]
    # the package's attribute of that name is the op, not the module
    flash_attention = sys.modules["repro_torch.kernels.flash_attention"]
    monkeypatch.setattr(build, "HEAD_DIMS", build.HEAD_DIMS + (36,))
    monkeypatch.setattr(flash_attention, "WGMMA_HEAD_DIMS",
                        flash_attention.WGMMA_HEAD_DIMS + (36,))
    odd = dataclasses.replace(g, head_dim=36, dtype="bfloat16")
    assert list(_refusals(odd, train)) == ["cuda-align"]
    assert _refusals(odd, dec)["cuda-align"][0][1] == (
        "flash_decode: rows must be 16-byte aligned (strides "
        f"{(4 * 36, 36, 1)})")
    # f32 takes the FMA route, which takes any stride
    assert _refusals(dataclasses.replace(odd, dtype="float32"), train) == {}


def test_autotune_rejects_refused_cuda_variants_statically():
    cfg = dataclasses.replace(get_arch("granite-8b").smoke(), head_dim=48)
    shape = get_shape("prefill_32k").smoke()
    ex = DryRunExecutor()
    bad = AT._measure_one("flash_attention", {"kernel": "cuda",
                                              "block_q": 16, "block_k": 16},
                          cfg, shape, ex)
    assert bad["status"] == "failed"
    assert bad["error"].startswith("static: cuda-head-dim")
    good = AT._measure_one("flash_attention", {"kernel": "plain",
                                               "block_q": 16, "block_k": 16},
                           cfg, shape, ex)
    assert good["status"] == "done" and good["flops"] > 0
    assert [d.rule for d in lint_schedule(
        "flash_attention", {"kernel": "plain", "block_q": 24}, cfg,
        shape)] == ["attn-chunk-fallback"]


SPACE = {"remat": ("none", "dots"), "kernel": ("xla",), "block_q": (16, 24)}


def _rows(tuner):
    return [(r["segment"], r["cid"], r["status"],
             json.dumps(r["cost"], sort_keys=True))
            for r in tuner.db.results(tuner.project)]


def test_static_checks_match_reference_and_warn_equals_off():
    tcfg, jcfg = get_arch("granite-8b").smoke(), \
        jget_arch("granite-8b").smoke()
    tsh, jsh = get_shape("train_4k").smoke(), jget_shape("train_4k").smoke()
    kw = dict(clause_space=SPACE, max_flags=1,
              global_space={"microbatches": (1, 3)})
    seen = {}
    for mode in ("off", "warn", "strict"):
        tt = ComParTuner(tcfg, tsh, device="cpu", project="p")
        jt = JTuner(jcfg, jsh, None, executor="dryrun", project="p")
        tt.executor = TableExecutor(TCM.CostTerms)
        jt.executor = TableExecutor(JCM.CostTerms)
        tplan, trep = tt.sweep(static_checks=mode, **kw)
        jplan, jrep = jt.sweep(static_checks=mode, **kw)
        for f in ("n_static", "static_rules", "n_done", "n_failed",
                  "n_scored", "n_combinations"):
            assert getattr(trep, f) == getattr(jrep, f), (mode, f)
        assert _plan_key(tplan) == _plan_key(jplan)
        seen[mode] = (_rows(tt), json.dumps(tplan.to_json(), sort_keys=True))
        if mode == "strict":
            assert trep.n_static > 0 and "static=" in trep.summary()
            static = {(r["segment"], r["cid"]) for r in tt.db.results("p")
                      if r["status"] == "static"}
            assert len(static) == trep.n_static
            # a static row is a verdict of the rule set, never cached
            assert tt.db.cache_size() == trep.n_scored
    assert seen["warn"] == seen["off"]
    # with the real dry run a dropped point fails when scored, so strict
    # fuses the plan an unlinted sweep fuses, byte for byte
    plans = {}
    for mode in ("off", "strict"):
        t = ComParTuner(tcfg, tsh, device="cpu", project="p")
        plan, rep = t.sweep(["fsdp"], {"remat": ("none",), "block_q": (16,)},
                            max_flags=0, static_checks=mode,
                            global_space={"microbatches": (1, 3)})
        plans[mode] = json.dumps(plan.to_json(), sort_keys=True)
        assert rep.n_failed == (3 if mode == "off" else 0)
    assert plans["strict"] == plans["off"]
    with pytest.raises(ValueError, match="static_checks"):
        ComParTuner(tcfg, tsh, device="cpu").sweep(static_checks="loud")


def _ref_plan(plan: Plan) -> JPlan:
    d = json.loads(json.dumps(plan.to_json()))
    for c in d["segments"].values():
        c["clause"]["kernel"] = KERNEL[c["clause"]["kernel"]]
    return JPlan.from_json(d)


def test_plan_lint_matches_reference():
    tcfg, jcfg = get_arch("xlstm-125m").smoke(), \
        jget_arch("xlstm-125m").smoke()
    tsh, jsh = get_shape("train_4k").smoke(), jget_shape("train_4k").smoke()
    plans = [uniform_plan(tcfg, "fsdp", clause=SegmentClause(mlstm_chunk=24)),
             uniform_plan(tcfg, "fsdp",
                          knobs=TC.GlobalKnobs(microbatches=3)),
             uniform_plan(tcfg, "tensor_par", {"shard_vocab"},
                          SegmentClause(kernel="cuda"))]
    partial = uniform_plan(tcfg, "fsdp")
    del partial.segments["head"]
    plans.append(partial)
    for i, plan in enumerate(plans):
        trace = i == 1            # the abstract trace: the failing plan
        t = plan.lint(tcfg, tsh, trace=trace)
        assert t == analyze_plan(tcfg, tsh, plan, trace=trace)
        j = janalyze_plan(jcfg, jsh, _ref_plan(plan), trace=trace)
        shared = SHARED + ("trace", "missing-segment")
        assert [_key(d) for d in t if d.rule in shared] == \
            [_key(d) for d in j if d.rule in shared]
        if i == 1:
            assert {d.rule for d in errors(t)} == {"microbatch", "trace"}
    assert plans[0].lint(tcfg, tsh, trace=False)[0].rule == "chunk-clamp"
    assert [d.rule for d in plans[3].lint(tcfg, tsh, trace=False)] == \
        ["missing-segment"]
    d = plans[1].lint(tcfg, tsh, trace=False)[0]
    assert Diagnostic.from_json(json.loads(json.dumps(d.to_json()))) == d
    assert format_diagnostics([d]).startswith("ERROR microbatch")


def test_lint_cli_exit_codes_match_reference(tmp_path, capsys):
    jcfg = jget_arch("stablelm-3b").smoke()
    plan = tmp_path / "plan.json"
    juniform_plan(jcfg, "fsdp").save(str(plan))
    specs = {
        "clean": ({"clauses": {"kernel": ["xla"], "block_q": [16]}}, 0, 0),
        "warn": ({"clauses": {"kernel": ["xla"], "block_q": [24]}}, 0, 2),
        "error": ({"clauses": {"kernel": ["xla"]},
                   "globals": {"microbatches": [1, 3]}}, 2, 2),
    }
    cases = [([str(plan)], 0), ([str(tmp_path / "missing.json")], 1)]
    for name, (spec, rc, strict_rc) in specs.items():
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(dict(spec, providers={"fsdp": []})))
        cases += [([str(path), "--no-trace"], rc),
                  ([str(path), "--no-trace", "--strict"], strict_rc)]
    cases.append(([str(tmp_path / "error.json")], 2))       # traced
    for argv, rc in cases:
        assert tlint(argv) == rc, argv
        assert jlint(argv) == rc, argv
    out = capsys.readouterr().out
    assert "microbatch" in out and "sweep spec" in out


def test_decode_site_error_and_shardmap_demotion():
    """The reference's ``decode-tile`` demotion
    (``tests/test_analysis.py::test_decode_tile_rule_and_shardmap_demotion``)
    on the port's flash-decode site: a refusal there is an ERROR, and with
    ``decode_shardmap=True`` a WARN, because the sharded decode may route
    around the kernel (its gate also needs the cache's seq dim sharded,
    which the mesh decides)."""
    cfg = dataclasses.replace(get_arch("granite-8b").smoke(), head_dim=24)
    shape = get_shape("decode_32k").smoke()

    def site(**fields):
        combo = TC.Combination("fsdp", frozenset(),
                               SegmentClause(kernel="cuda", **fields))
        return [d for d in analyze_point(cfg, shape, combo)
                if d.rule == "cuda-head-dim"]
    bad = site()
    assert bad and bad[0].is_error and bad[0].segment == "g0"
    demoted = site(decode_shardmap=True)
    assert demoted and demoted[0].severity == "warn"
    assert not demoted[0].is_error
    assert "decode_shardmap=True may bypass" in demoted[0].message
    assert not errors(analyze_point(
        cfg, shape, TC.Combination("fsdp", frozenset(), SegmentClause(
            kernel="cuda", decode_shardmap=True))))
