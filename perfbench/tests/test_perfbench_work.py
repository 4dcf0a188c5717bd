"""Work counted from shapes, the rate arithmetic and the readers."""
import json

import pytest

import perfbench_tiny  # noqa: F401
from perfbench.harness import cell as C
from perfbench.harness import work
from perfbench.harness.trace import _union, kernel_name


def _arch(name):
    return json.loads((C.ROOT / "configs" / f"{name}.json").read_text())["arch"]


def test_attention_pairs():
    assert work.attention_pairs(4, 4, True, 0) == 10
    assert work.attention_pairs(4, 4, False, 0) == 16
    # window 2: rows see 1, 2, 2, 2 keys
    assert work.attention_pairs(4, 4, True, 2) == 7
    assert work.attention_pairs(8192, 8192, True, 4096) == \
        4096 * 4097 // 2 + 4096 * 4096


@pytest.mark.parametrize("args,bound_ms", [
    # PERF.md's kernel table: granite's train shape and starcoder2's past
    # its window, bound by operations
    ((1, 32, 8, 4096, 128, 0), 0.1390),
    ((1, 24, 2, 8192, 128, 4096), 0.3127),
])
def test_flash_attention_bound(args, bound_ms):
    flops, nbytes = work.flash_attention_fwd(*args, "bfloat16")
    least, which = work.bound_s(nbytes, flops, "bfloat16")
    assert which == "operations"
    assert least * 1e3 == pytest.approx(bound_ms, abs=5e-5)
    B, H, KV, S, D, _ = args
    assert nbytes == 2 * B * S * D * (2 * H + 2 * KV)


def test_train_flops_per_token():
    a = _arch("granite-8b-8l")
    # 8 layers of 218.1 M product weights and the 201.3 M head
    assert work.matmul_params(a) == 8 * (4096 * 4096 * 2 + 4096 * 1024 * 2
                                         + 3 * 4096 * 14336) + 4096 * 49152
    per_tok = work.train_step_flops(a, 2, 4096) / (2 * 4096)
    assert per_tok == pytest.approx(12.48e9, rel=0.01)
    s = _arch("starcoder2-3b-15l")
    assert work.matmul_params(s) == 15 * (3072 * 3072 * 2 + 3072 * 256 * 2
                                          + 2 * 3072 * 12288) + 3072 * 49152


def _readers():
    cell = C.load_cell("granite-8b.train-4k")
    return C.readers(cell)


def test_readers_from_synthetic_readings():
    a = _arch("granite-8b-8l")
    fl, nb = work.flash_attention_fwd(2, 32, 8, 4096, 128, 0, "bfloat16")
    least, _ = work.bound_s(nb, fl, "bfloat16")
    trace = {"window_s": 10.0, "busy_s": 9.0,
             "kernels": {"fa_wgmma_kernel<128>": [16, 16 * 2 * least],
                         "gemm": [84, 1.0]},
             "ops": {}, "gaps": []}
    step_s = work.train_step_flops(a, 2, 4096) / 989e12 * 10   # 10 % MFU
    r = {"steps": 2, "batch": 2, "seq": 4096, "arch": a, "trace": trace,
         "spans_ms": {"fwd_bwd": [800.0, 900.0], "adamw": [100.0, 120.0],
                      "step": [step_s * 1e3] * 2}}
    got = {k: m.read(r) for k, m in _readers().items()}
    assert got["fa_fwd_roofline.train"] == pytest.approx(50.0)
    assert got["idle_share.train"] == pytest.approx(10.0)
    assert got["launches_per_step.train"] == 50
    assert got["fwd_bwd_ms.train"] == 850.0 and got["adamw_ms.train"] == 110
    assert got["step_mfu.train"] == pytest.approx(10.0)
    # a reader with nothing to read returns nothing, never 0
    empty = {k: m.read({"steps": 0, "arch": a, "batch": 2, "seq": 4096})
             for k, m in _readers().items()}
    assert set(empty.values()) == {None}


def test_sweep_readers():
    cell = C.load_cell("granite-8b.sweep-4k")
    rd = C.readers(cell)
    r = {"sweeps": [{"n_scored": 6}, {"n_scored": 6}],
         "spans_host_s": {"sweep": 20.0, "score_segment": 17.0},
         "trace": {"window_s": 20.0, "busy_s": 15.0}}
    assert rd["programs_per_sweep.sweep"].read(r) == 6
    assert rd["scoring_share.sweep"].read(r) == pytest.approx(85.0)
    assert rd["idle_share.sweep"].read(r) == pytest.approx(25.0)


def test_trace_arithmetic():
    assert _union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [[0, 3], [5, 8]]
    assert kernel_name("void (anonymous namespace)::fa_wgmma_kernel<128>"
                       "(CUtensorMap, int)") == "fa_wgmma_kernel<128>"
