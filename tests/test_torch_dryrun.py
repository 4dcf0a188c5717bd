"""The port's dry run over fake process groups (``launch/dryrun.py``,
``launch/mesh.py`` ``fake_group``) and its op-stream accounting
(``runtime/hlo.py``), held to the JAX package's where the reference has
the same function: the collectives' ring factors and the baseline plans.
Everything runs on the CPU on fake tensors."""
from __future__ import annotations

import json
import os

import pytest
import torch

from repro.runtime import hlo as JH
from repro_torch.configs import ARCHS, SHAPES, get_arch, get_shape
from repro_torch.core.executor import DryRunExecutor, WallClockExecutor
from repro_torch.core.plan import Plan
from repro_torch.core.segment import fragment
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import (FakeGroupError, destroy_group,
                                     ensure_group, fake_group)
from repro_torch.runtime import hlo as TH

from test_torch_sweep import _plan_key


@pytest.fixture(autouse=True)
def _no_group():
    destroy_group()
    yield
    destroy_group()


def _hlo_line(kind, shape, n):
    """One collective of the reference's HLO text: a bf16 result of
    ``shape`` over replica groups of ``n``."""
    dims = ",".join(map(str, shape))
    return (f"  %c = bf16[{dims}]{{{','.join(map(str, range(len(shape))))}}}"
            f" {kind}(bf16[{dims}] %x), replica_groups=[1,{n}]<=[{n}]")


@pytest.mark.parametrize("n", [2, 4, 16])
@pytest.mark.parametrize("kind", JH.COLLECTIVE_KINDS)
def test_collective_moved_matches_reference(kind, n):
    shape = (8, 2048, 8, 128)
    r = 2 * 8 * 2048 * 8 * 128
    assert TH._collective_moved(kind, r, n) == \
        JH._collective_moved(kind, _hlo_line(kind, shape, n))


def test_analyze_ops_keys_and_counts():
    recs = [TH.OpRecord("aten.mm", 100),
            TH.OpRecord("_c10d_functional.all_reduce", 0, "all-reduce", 64,
                        4),
            TH.OpRecord("_c10d_functional.all_gather_into_tensor", 0,
                        "all-gather", 64, 4)]
    res = TH.analyze_ops(recs, flops=7.0)
    assert res == {"flops": 7.0, "bytes": 100.0, "collective": 96.0 + 48.0,
                   "coll_all-reduce": 96.0, "coll_all-gather": 48.0,
                   "coll_count": 2.0}
    assert TH.collective_bytes(recs)["total"] == 144.0
    assert TH.count_ops(recs, "all_reduce") == 1
    assert TH.collective_kind("wait_tensor") is None


def test_fake_group_refuses_a_real_group_and_the_wall_clock_a_fake_one():
    ensure_group("cpu")
    with pytest.raises(FakeGroupError, match="already has a default group"):
        with fake_group(4):
            pass
    destroy_group()
    cfg, shape = get_arch("granite-8b").smoke(), get_shape("train_4k").smoke()
    seg = fragment(cfg)[0]
    from repro_torch.core.combinator import Combination
    from repro_torch.models.context import SegmentClause
    combo = Combination("fsdp", frozenset(), SegmentClause())
    with fake_group(4):
        with pytest.raises(FakeGroupError, match="fake process group"):
            WallClockExecutor("cpu").score_segment(cfg, shape, seg, combo)
        # the dry run scores a point of up to 4 devices on it
        assert DryRunExecutor().score_segment(
            cfg, shape, seg, combo, mesh={"data": 2, "model": 2}).total_s > 0


def _counts(plan=None):
    cfg, shape = get_arch("granite-8b").smoke(), \
        get_shape("decode_32k").smoke()
    with fake_group(4):
        mesh = DR.cell_mesh(False, True, "cpu")
        counter, _ = DR.lower_cell(cfg, shape, mesh, plan, "cpu")
    return cfg, shape, counter


def test_decode_shardmap_arithmetic_at_smoke_size():
    """granite smoke on the (1, 4) mesh: 2 kv heads on a model axis of 4,
    so the rules split the cache along its sequence (S_l = 8).  Without
    ``decode_shardmap`` each layer gathers both caches twice (the write
    and the attention); with it no cache is gathered, and the combine
    adds three all-reduces a layer (m and l (B,KV,G,1), o (B,KV,G,D), f32,
    at the all-reduce's 2(n-1)/n)."""
    cfg, shape, plain = _counts()
    base = DR.default_plan(cfg, shape)
    plan = Plan({k: c.__class__(c.provider, c.flags, c.clause.__class__(
        **{**vars(c.clause), "decode_shardmap": True}))
        for k, c in base.segments.items()}, base.knobs)
    _, _, dsm = _counts(plan)
    L, B, S = cfg.num_layers, shape.global_batch, shape.seq_len
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    G, n, f32 = H // KV, 4, 4
    cache = B * S * KV * D * f32
    gathers = [r for r in plain.records if r.kind == "all-gather"
               and r.result_bytes == cache]
    assert len(gathers) == 4 * L
    assert not [r for r in dsm.records if r.kind == "all-gather"
                and r.result_bytes == cache]
    a, b = plain.analysis(), dsm.analysis()
    # what stays gathered is q (heads split on model): the reference's
    # shard_map takes q whole over model too
    q = B * H * D * f32
    assert b["coll_all-gather"] == L * q * (n - 1) / n
    assert a["coll_all-gather"] == b["coll_all-gather"] + \
        4 * L * cache * (n - 1) / n
    combine = 2 * B * KV * G * f32 + B * KV * G * D * f32
    assert b["coll_all-reduce"] - a["coll_all-reduce"] == \
        L * combine * 2 * (n - 1) / n


def test_main_continue_mode_failed_cell_and_long_skip(tmp_path, capsys):
    out = str(tmp_path / "dry.json")
    argv = ["--device", "cpu", "--smoke", "--arch", "granite-8b",
            "--out", out]
    with fake_group(4):
        DR.main(argv + ["--shape", "decode_32k"])
        res = json.load(open(out))
        rec = res["granite-8b|decode_32k|single"]
        assert rec["status"] == "ok" and rec["chips"] == 4
        assert set(rec) >= {"elapsed_s", "cost", "detail", "dominant"}
        assert rec["detail"]["coll_all-gather"] > 0
        assert rec["detail"]["peak_bytes"] >= \
            rec["detail"]["argument_bytes"] > 0
        DR.main(argv + ["--shape", "decode_32k"])          # Continue mode
        assert "granite-8b|decode_32k|single: cached (ok)" in \
            capsys.readouterr().out
        DR.main(argv + ["--shape", "long_500k"])
        assert json.load(open(out))["granite-8b|long_500k|single"][
            "status"] == "skip"
        # the (2, 1, 4) two-pod mesh needs 8 ranks: a failed cell, rc 1
        with pytest.raises(SystemExit) as e:
            DR.main(argv + ["--shape", "decode_32k", "--multi-pod"])
        assert e.value.code == 1
    res = json.load(open(out))
    assert res["granite-8b|decode_32k|multi"]["status"] == "fail"
    assert "8 ranks" in res["granite-8b|decode_32k|multi"]["error"]


def _reference_default_plan():
    """The reference's ``default_plan``: its module sets XLA_FLAGS for its
    own process on import, which is put back here."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import default_plan
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return default_plan


def test_default_plan_matches_reference():
    from repro.configs import get_arch as jget_arch
    from repro.configs import get_shape as jget_shape
    jdefault = _reference_default_plan()
    for arch in ARCHS:
        for s in SHAPES:
            got = DR.default_plan(get_arch(arch), get_shape(s))
            want = jdefault(jget_arch(arch), jget_shape(s))
            assert _plan_key(got) == _plan_key(want), (arch, s)
    moe = DR.default_plan(get_arch("qwen3-moe-30b-a3b"), get_shape("train_4k"))
    assert moe.knobs.opt_state_dtype == "bfloat16"
    assert {c.provider for c in moe.segments.values()} == {"expert_par"}
