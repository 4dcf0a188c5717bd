"""The port's CUDA kernels and model on the card (skipped without one).

Torch only (no JAX), so the file also runs on a machine without JAX:
    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
Inputs come from a numpy seed; tolerances are those of
tests/test_kernels.py: 2e-5 f32 and 2e-2 bf16 for attention, 1e-5 / 1e-4
for rglru, 5e-4 / 5e-3 for mlstm, 1e-5 f32 and 2e-2 bf16 for rmsnorm.
Gradients (every op but flash-decode is an autograd Function whose
backward is autograd of the plain math, or flash-attention's backward
kernel in bf16) are held to the same tolerances.
"""
import dataclasses
import statistics

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, get_shape
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.combinator import Combination
from repro_torch.core.executor import WallClockExecutor
from repro_torch.core.plan import uniform_plan
from repro_torch.core.segment import fragment
from repro_torch.core.tuner import ComParTuner
from repro_torch.kernels import LAUNCHES, ops, ref, reset_launches
from repro_torch.kernels.flash_attention import bwd_route as fa_bwd_route
from repro_torch.kernels.flash_attention import route as fa_route
from repro_torch.models.context import SegmentClause
from repro_torch.models.model import model_specs
from repro_torch.models.params import init_params, tree_leaves
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.step import make_prefill
from repro_torch.train.step import (init_train_state, make_grads,
                                    make_train_step)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dev).to(dtype)


def _close(got, want, dtype):
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,H,KV,D", [
    (1, 128, 4, 4, 32), (2, 100, 4, 2, 64), (1, 77, 8, 1, 16),
    (1, 300, 32, 8, 128), (1, 65, 4, 4, 80), (1, 200, 10, 1, 256),
    # the wgmma route's head dims at G = 1, 4 and 10: ragged S, and S
    # shorter than one tile
    (1, 1000, 8, 2, 128), (1, 2047, 4, 4, 80), (1, 2047, 10, 1, 256),
    (1, 1, 8, 2, 128), (1, 1, 4, 4, 80), (1, 1, 10, 1, 256),
    (1, 65, 8, 2, 128), (2, 65, 10, 1, 256), (1, 1000, 8, 2, 80),
    # kimi-k2's head_dim 112 (G = 8), qwen3-moe's G = 8 at D = 128
    (1, 300, 16, 2, 112), (1, 1, 8, 1, 112), (1, 1000, 32, 4, 128),
    # phi-3-vision's head_dim 96 (G = 1): ragged S and one row;
    # chatglm3's G = 16 and starcoder2's G = 12 at D = 128; musicgen's
    # D = 64 at G = 1
    (1, 2047, 8, 8, 96), (1, 1, 4, 4, 96), (2, 300, 4, 4, 96),
    (1, 1000, 32, 2, 128), (1, 700, 24, 2, 128), (1, 1000, 8, 8, 64)])
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_cuda_vs_plain(dev, B, S, H, KV, D, window, dtype):
    if dtype == torch.bfloat16 and D in (64, 80, 96, 112, 128, 256):
        assert fa_route(dtype, D) == "wgmma"
    rng = np.random.default_rng(0)
    q = _t(rng, (B, S, H, D), dtype, dev)
    k = _t(rng, (B, S, KV, D), dtype, dev)
    v = _t(rng, (B, S, KV, D), dtype, dev)
    n0 = LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == n0 + 1
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), window=window)
    _close(got, want.transpose(1, 2), dtype)


@pytest.mark.parametrize("Sq,Sk,window", [(100, 300, 0), (100, 300, 48),
                                           (300, 100, 0)])
@pytest.mark.parametrize("D", [80, 96, 112, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_cuda_sq_ne_sk(dev, Sq, Sk, window, D, dtype):
    """Queries and keys of different lengths, the mask on absolute
    positions as in the reference (every query row keeps a key)."""
    rng = np.random.default_rng(6)
    q = _t(rng, (1, Sq, 8, D), dtype, dev)
    k = _t(rng, (1, Sk, 2, D), dtype, dev)
    v = _t(rng, (1, Sk, 2, D), dtype, dev)
    got = ops.flash_attention(q, k, v, window=window)
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), window=window)
    _close(got, want.transpose(1, 2), dtype)


@pytest.mark.parametrize("D", [80, 96, 112, 128, 256])
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_cuda_non_causal(dev, D, window, dtype):
    """causal=False: every key of the window, before and after the row."""
    rng = np.random.default_rng(8)
    q = _t(rng, (1, 200, 8, D), dtype, dev)
    k = _t(rng, (1, 200, 2, D), dtype, dev)
    v = _t(rng, (1, 200, 2, D), dtype, dev)
    got = ops.flash_attention(q, k, v, causal=False, window=window)
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=False,
                                   window=window)
    _close(got, want.transpose(1, 2), dtype)


@pytest.mark.parametrize("D", [80, 96, 112, 128, 256])
def test_flash_attention_cuda_fused_qkv_views(dev, D):
    """q, k and v as slices of one (B,S,H+2KV,D) projection: model-layout
    views that are not contiguous, read by TMA through their strides."""
    rng = np.random.default_rng(7)
    B, S, H, KV = 2, 300, 8, 2
    qkv = _t(rng, (B, S, H + 2 * KV, D), torch.bfloat16, dev)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    assert not q.is_contiguous()
    got = ops.flash_attention(q, k, v, window=0)
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2))
    _close(got, want.transpose(1, 2), torch.bfloat16)


def test_flash_attention_wgmma_rejects_unaligned_strides(dev):
    """TMA takes strides of whole 16 bytes only: a head stride of 84 bf16
    elements is refused before launch (the f32-FMA route takes it)."""
    x = torch.zeros((1, 64, 4, 84), device=dev, dtype=torch.bfloat16)
    q = x[..., :80]
    with pytest.raises(ValueError, match="TMA"):
        ops.flash_attention(q, q, q)
    got = ops.flash_attention(q.float(), q.float(), q.float())
    assert got.shape == q.shape


@pytest.mark.parametrize("B,Smax,H,KV,D", [
    (2, 256, 4, 2, 32), (1, 300, 8, 1, 16), (3, 1024, 32, 8, 128),
    (1, 129, 4, 4, 80), (1, 300, 8, 1, 256),
    # recurrentgemma-2b's G = 10 (three head slices, several chunks per
    # CTA); granite-8b's heads at Smax 4096 (a cluster of CTAs per kv head)
    (1, 300, 10, 1, 256), (1, 4096, 32, 8, 128),
    # qwen3-moe's heads (G = 8) and kimi-k2's (D = 112)
    (1, 2048, 32, 4, 128), (1, 2048, 64, 8, 112),
    # chatglm3-6b's (G = 16), phi-3-vision's (D = 96), musicgen's (D = 64)
    (1, 2048, 32, 2, 128), (1, 2048, 32, 32, 96), (1, 2048, 32, 32, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_cuda_vs_plain(dev, B, Smax, H, KV, D, dtype):
    rng = np.random.default_rng(1)
    q = _t(rng, (B, H, D), dtype, dev)
    kc = _t(rng, (B, Smax, KV, D), dtype, dev)
    vc = _t(rng, (B, Smax, KV, D), dtype, dev)
    for pos in (0, 17, 127, 128, Smax - 1):
        if pos >= Smax:
            continue
        got, lse = ops.flash_decode(q, kc, vc, pos, return_lse=True)
        want, lse_want = ref.flash_decode_ref(q, kc, vc, pos,
                                              return_lse=True)
        _close(got, want, dtype)
        _close(lse, lse_want, torch.float32)


def _device_kernels(fn):
    """Device kernels and memsets one call of ``fn`` runs, from
    torch.profiler: {name: count}.  The profiler now and then records no
    device event at all (seen on cluster launches); it is asked again, up
    to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        found = {a.key: a.count for a in prof.key_averages()
                 if a.device_type == DeviceType.CUDA}
        if found:
            return found
    return found


@pytest.mark.parametrize("B,pos", [(1, 0), (1, 63), (1, 4095), (8, 4095)])
def test_flash_decode_cuda_one_kernel_per_call(dev, B, pos):
    """One op call is one LAUNCHES count and one CUDA kernel at every pos,
    split over CTAs or not (no second combine kernel, no memset)."""
    from repro_torch.kernels.flash_decode import plan
    rng = np.random.default_rng(5)
    H, KV, D, Smax = 32, 8, 128, 4096
    q = _t(rng, (B, H, D), torch.bfloat16, dev)
    kc = _t(rng, (B, Smax, KV, D), torch.bfloat16, dev)
    vc = _t(rng, (B, Smax, KV, D), torch.bfloat16, dev)
    n0 = LAUNCHES["flash_decode"]
    got = ops.flash_decode(q, kc, vc, pos)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_decode"] == n0 + 1
    _close(got, ref.flash_decode_ref(q, kc, vc, pos), torch.bfloat16)
    kernels = _device_kernels(lambda: ops.flash_decode(q, kc, vc, pos))
    assert sum(kernels.values()) == 1, kernels
    assert plan(B, H, KV, pos + 1, D) == {0: (1, 4, 1), 63: (1, 4, 1)}.get(
        pos, (4, 1, 8) if B == 1 else (4, 1, 4))


def test_flash_decode_cuda_any_group(dev):
    """G = 10 and G = 13 query heads per kv head (no cap), f32, against
    the plain version; and at G <= 8 the same call as before."""
    rng = np.random.default_rng(6)
    for H, KV in ((10, 1), (26, 2), (8, 1)):
        q = _t(rng, (2, H, 256), torch.float32, dev)
        kc = _t(rng, (2, 700, KV, 256), torch.float32, dev)
        vc = _t(rng, (2, 700, KV, 256), torch.float32, dev)
        for pos in (0, 450, 699):
            got, lse = ops.flash_decode(q, kc, vc, pos, return_lse=True)
            want, lse_want = ref.flash_decode_ref(q, kc, vc, pos,
                                                  return_lse=True)
            _close(got, want, torch.float32)
            _close(lse, lse_want, torch.float32)


def _gates(rng, shape, dev):
    li = rng.standard_normal(shape).astype(np.float32)
    lf = -np.logaddexp(0.0, -rng.standard_normal(shape)).astype(np.float32)
    return torch.from_numpy(li).to(dev), torch.from_numpy(lf).to(dev)


@pytest.mark.parametrize("B,S,dr", [(1, 64, 32), (2, 128, 96), (1, 100, 48),
                                    (1, 2048, 2560),
                                    # one step; odd S over 8 and 17 tiles
                                    (3, 1, 2560), (3, 2047, 2560),
                                    (3, 4097, 200)])
def test_rglru_cuda_vs_plain(dev, B, S, dr):
    rng = np.random.default_rng(2)
    la = -_t(rng, (B, S, dr), torch.float32, dev).abs() * 0.2
    b = _t(rng, (B, S, dr), torch.float32, dev)
    n0 = LAUNCHES["rglru"]
    got = ops.rglru(la, b)
    torch.cuda.synchronize()
    assert LAUNCHES["rglru"] == n0 + 1
    torch.testing.assert_close(got, ref.rglru_ref(la, b), atol=1e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("S", [300, 4097])
def test_rglru_cuda_slow_decay(dev, S):
    """log_a ~ -1e-4: the carry crosses every tile almost undamped.  b is
    scaled by sqrt(1 - a^2), as the model makes it (models/rglru.py), so
    that h stays O(1): with unscaled N(0, 1) inputs h grows to tens and
    f32 rounding alone, of the plain sequential recurrence too, exceeds
    the 1e-5 atol against float64."""
    rng = np.random.default_rng(8)
    la = torch.from_numpy((-1e-4 * rng.uniform(0.5, 1.5, (2, S, 2560))
                           ).astype(np.float32)).to(dev)
    b = _t(rng, (2, S, 2560), torch.float32, dev) * torch.sqrt(
        -torch.expm1(2.0 * la))
    n0 = LAUNCHES["rglru"]
    got = ops.rglru(la, b)
    torch.cuda.synchronize()
    assert LAUNCHES["rglru"] == n0 + 1 and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ref.rglru_ref(la, b), atol=1e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("B,H,S,dh", [(1, 2, 64, 16), (2, 2, 128, 32),
                                      (1, 1, 96, 16), (1, 2, 200, 100),
                                      (1, 4, 512, 384),
                                      # one row, one row past a chunk
                                      (1, 2, 1, 16), (2, 2, 65, 384),
                                      # dh not a multiple of 4 (element
                                      # copies), dh > 384 (two value tiles)
                                      (1, 2, 150, 30), (1, 1, 130, 512)])
def test_mlstm_cuda_vs_plain(dev, B, H, S, dh):
    rng = np.random.default_rng(3)
    q = _t(rng, (B, H, S, dh), torch.float32, dev) * dh ** -0.5
    k = _t(rng, (B, H, S, dh), torch.float32, dev)
    v = _t(rng, (B, H, S, dh), torch.float32, dev)
    li, lf = _gates(rng, (B, H, S), dev)
    n0 = LAUNCHES["mlstm"]
    got = ops.mlstm_chunkwise(q, k, v, li, lf)
    torch.cuda.synchronize()
    assert LAUNCHES["mlstm"] == n0 + 1 and bool(torch.isfinite(got).all())
    # the step-recurrent oracle, and the chunkwise plain version at two
    # chunks other than the kernel's own
    for want in (ref.mlstm_ref(q, k, v, li, lf),
                 ref.mlstm_chunkwise_ref(q, k, v, li, lf, chunk=256),
                 ref.mlstm_chunkwise_ref(q, k, v, li, lf, chunk=16)):
        torch.testing.assert_close(got, want, atol=5e-4, rtol=5e-3)


@pytest.mark.parametrize("dh", [32, 30, 384])
def test_mlstm_cuda_strided_inputs(dev, dh):
    """The model passes q/k/v as permuted einsum outputs and the gates as
    transposed views: the kernel reads them through their strides (in
    16-byte copies, or element by element where dh is not a multiple of
    4)."""
    rng = np.random.default_rng(4)
    B, S, H = 2, 130, 3
    q = _t(rng, (B, S, H, dh), torch.float32, dev).transpose(1, 2)
    k = _t(rng, (B, S, H, dh), torch.float32, dev).transpose(1, 2)
    v = _t(rng, (B, S, H, dh), torch.float32, dev).transpose(1, 2)
    li, lf = (g.transpose(1, 2) for g in _gates(rng, (B, S, H), dev))
    n0 = LAUNCHES["mlstm"]
    got = ops.mlstm_chunkwise(q, k, v, li, lf)
    torch.cuda.synchronize()
    assert LAUNCHES["mlstm"] == n0 + 1 and bool(torch.isfinite(got).all())
    want = ref.mlstm_chunkwise_ref(*(t.contiguous()
                                     for t in (q, k, v, li, lf)))
    torch.testing.assert_close(got, want, atol=5e-4, rtol=5e-3)


def test_mlstm_cuda_long_sequence(dev):
    """S=4096 (64 chunks) at xlstm-125m's heads, B=2: the state kernel's
    scan over 63 chunks against the plain version and the oracle."""
    rng = np.random.default_rng(9)
    B, H, S, dh = 2, 4, 4096, 384
    q = _t(rng, (B, H, S, dh), torch.float32, dev) * dh ** -0.5
    k = _t(rng, (B, H, S, dh), torch.float32, dev)
    v = _t(rng, (B, H, S, dh), torch.float32, dev)
    li, lf = _gates(rng, (B, H, S), dev)
    n0 = LAUNCHES["mlstm"]
    got = ops.mlstm_chunkwise(q, k, v, li, lf)
    torch.cuda.synchronize()
    assert LAUNCHES["mlstm"] == n0 + 1 and bool(torch.isfinite(got).all())
    for want in (ref.mlstm_chunkwise_ref(q, k, v, li, lf, chunk=256),
                 ref.mlstm_ref(q, k, v, li, lf)):
        torch.testing.assert_close(got, want, atol=5e-4, rtol=5e-3)


@pytest.mark.parametrize("dh", [16, 384])
def test_mlstm_cuda_stabilizer_stress(dev, dh):
    """Large input gates (li in [5, 10]) and forget gates near 1 (lf ~
    -1e-3) over 18 chunks: every exponent of the rescaling stays <= 0, so
    the output is finite.  q and k are positive, so that q.n does not
    cancel (tests/test_torch_kernels.py says why)."""
    rng = np.random.default_rng(12)
    B, H, S = 1, 2, 18 * 64 - 5
    q = _t(rng, (B, H, S, dh), torch.float32, dev).abs() * dh ** -0.5
    k = _t(rng, (B, H, S, dh), torch.float32, dev).abs()
    v = _t(rng, (B, H, S, dh), torch.float32, dev)
    li = torch.from_numpy(rng.uniform(5.0, 10.0, (B, H, S)).astype(
        np.float32)).to(dev)
    lf = torch.from_numpy((-1e-3 * rng.uniform(0.5, 1.5, (B, H, S))).astype(
        np.float32)).to(dev)
    n0 = LAUNCHES["mlstm"]
    got = ops.mlstm_chunkwise(q, k, v, li, lf)
    torch.cuda.synchronize()
    assert LAUNCHES["mlstm"] == n0 + 1 and bool(torch.isfinite(got).all())
    for want in (ref.mlstm_chunkwise_ref(q, k, v, li, lf, chunk=64),
                 ref.mlstm_ref(q, k, v, li, lf)):
        torch.testing.assert_close(got, want, atol=5e-4, rtol=5e-3)


@pytest.mark.parametrize("N,d", [(32, 64), (128, 96), (2048, 2560)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_cuda_vs_plain(dev, N, d, dtype):
    rng = np.random.default_rng(5)
    x = _t(rng, (N, d), dtype, dev)
    s = _t(rng, (d,), dtype, dev)
    n0 = LAUNCHES["rmsnorm"]
    got = ops.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert LAUNCHES["rmsnorm"] == n0 + 1 and got.dtype == dtype
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), ref.rmsnorm_ref(x, s).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("N,d,col0", [
    (64, 100, 0), (33, 2561, 0),     # d not a multiple of the vector width
    (64, 2560, 1), (17, 100, 3),     # rows x[:, col0:] not 16-byte aligned
    (1, 2560, 0), (1, 9000, 1),      # one row; wider than the registers
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_cuda_any_width_and_alignment(dev, N, d, col0, dtype,
                                              scale_dtype):
    rng = np.random.default_rng(d + col0)
    x = _t(rng, (N, d + col0), dtype, dev)[:, col0:]
    s = _t(rng, (d,), scale_dtype, dev)
    n0 = LAUNCHES["rmsnorm"]
    got = ops.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert LAUNCHES["rmsnorm"] == n0 + 1 and got.dtype == dtype
    assert got.is_contiguous() and bool(torch.isfinite(got).all())
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), ref.rmsnorm_ref(x, s).float(),
                               atol=tol, rtol=tol)


def test_kernels_raise_on_bad_input(dev):
    q = torch.zeros((1, 8, 2, 48), device=dev)     # head_dim 48 not built
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, q[:, :, :1], q[:, :, :1])
    x = torch.zeros((4, 8, 16), device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="dtype"):
        ops.rglru(x, x)
    with pytest.raises(ValueError, match="contiguous"):
        ops.rglru(x.float().transpose(0, 1), x.float().transpose(0, 1))
    q = torch.zeros((1, 4, 32), device=dev, dtype=torch.float16)
    with pytest.raises(TypeError, match="dtype"):
        ops.flash_decode(q, torch.zeros((1, 8, 4, 32), device=dev,
                                        dtype=torch.float16),
                         torch.zeros((1, 8, 4, 32), device=dev,
                                     dtype=torch.float16), 3)


def _plan(cfg, kernel):
    return uniform_plan(cfg, "tensor_par", set(),
                        SegmentClause(kernel=kernel))


# smoke launches per prefill: granite 2 attn layers; recurrentgemma one
# rec, rec, attn group; xlstm 3 mlstm + 1 slstm layers; qwen3-moe 2
# attn_moe layers; kimi-k2 one attn and 2 attn_moe layers; the other
# dense archs 2 attn layers each
SMOKE_LAUNCHES = {"granite-8b": {"flash_attention": 2},
                  "chatglm3-6b": {"flash_attention": 2},
                  "starcoder2-3b": {"flash_attention": 2},
                  "phi-3-vision-4.2b": {"flash_attention": 2},
                  "musicgen-large": {"flash_attention": 2},
                  "recurrentgemma-2b": {"rglru": 2, "flash_attention": 1},
                  "xlstm-125m": {"mlstm": 3},
                  "qwen3-moe-30b-a3b": {"flash_attention": 2},
                  "kimi-k2-1t-a32b": {"flash_attention": 3}}


@pytest.mark.parametrize("name", sorted(SMOKE_LAUNCHES))
def test_model_cuda_plan_matches_plain_plan(dev, name):
    cfg = get_arch(name).smoke()
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(0),
                         dev)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 40))).to(dev)
    reset_launches()
    a = make_prefill(cfg, _plan(cfg, "cuda"), device=dev)(
        params, {"tokens": toks})
    assert {k: v for k, v in LAUNCHES.items() if v} == SMOKE_LAUNCHES[name]
    b = make_prefill(cfg, _plan(cfg, "plain"), device=dev)(
        params, {"tokens": toks})
    torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["phi-3-vision-4.2b", "musicgen-large"])
def test_model_cuda_plan_embeds_match_plain_plan(dev, name):
    """A stub frontend's ``embeds`` (B,S,d_model) as the residual stream's
    input, through the cuda plan's flash-attention."""
    cfg = get_arch(name).smoke()
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(0),
                         dev)
    x = torch.from_numpy((np.random.default_rng(2).standard_normal(
        (2, 40, cfg.d_model)) * 0.02).astype(np.float32)).to(dev)
    reset_launches()
    a = make_prefill(cfg, _plan(cfg, "cuda"), device=dev)(
        params, {"embeds": x})
    assert {k: v for k, v in LAUNCHES.items() if v} == \
        {"flash_attention": cfg.num_layers}
    b = make_prefill(cfg, _plan(cfg, "plain"), device=dev)(
        params, {"embeds": x})
    torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", sorted(SMOKE_LAUNCHES))
def test_engine_cuda_batched_equals_sequential(dev, name):
    cfg = get_arch(name).smoke()
    eng = ServeEngine(cfg, _plan(cfg, "cuda"), capacity=4, cache_len=32,
                      device=dev)
    rng = np.random.RandomState(0)
    reqs = [Request(rid=f"r{i}", prompt=tuple(rng.randint(0, 128, 3 + i)),
                    max_new_tokens=5 + i) for i in range(6)]
    reset_launches()
    batched = eng.run(reqs)
    # admission decodes at a scalar pos: flash-decode in every full-causal
    # attention layer; windowed and recurrent layers decode plain
    n_fd = 0 if cfg.window_size else sum(
        k in ("attn", "attn_moe") for k in cfg.block_kinds())
    assert LAUNCHES["flash_decode"] == n_fd * sum(len(r.prompt)
                                                  for r in reqs)
    sequential = eng.run(reqs, max_active=1)
    for r in reqs:
        assert batched[r.rid].tokens == sequential[r.rid].tokens, r.rid


# --- gradients -------------------------------------------------------------

def _grad_case(name, rng, dev):
    """(the op on CUDA inputs, its plain version, inputs, the kernel it
    launches, (atol, rtol))."""
    f32, bf16 = torch.float32, torch.bfloat16
    if name.startswith("flash_attention"):
        dt, D, H, KV, window, causal, S = {
            "flash_attention_fma": (f32, 128, 8, 2, 0, True, 300),
            "flash_attention_wgmma": (bf16, 128, 8, 2, 0, True, 300),
            "flash_attention_wgmma_d256_window": (bf16, 256, 10, 1, 48,
                                                  True, 300),
            "flash_attention_fma_non_causal": (f32, 128, 8, 2, 0, False,
                                               300),
            "flash_attention_wgmma_non_causal_window": (bf16, 128, 8, 2, 48,
                                                        False, 300),
            # granite-8b's train heads; starcoder2-3b's heads past their
            # window (cut to 512)
            "flash_attention_wgmma_granite": (bf16, 128, 32, 8, 0, True,
                                              1024),
            "flash_attention_wgmma_starcoder2_window": (bf16, 128, 24, 2,
                                                        512, True, 1536),
            # the other head dims of the backward kernel, S ragged (not a
            # multiple of its 64-row q tile or 128-key k tile)
            "flash_attention_wgmma_d64": (bf16, 64, 8, 8, 0, True, 333),
            "flash_attention_wgmma_d80": (bf16, 80, 8, 2, 48, True, 333),
            "flash_attention_wgmma_d96": (bf16, 96, 8, 8, 0, True, 333),
            "flash_attention_wgmma_d112": (bf16, 112, 16, 2, 0, True, 333),
            "flash_attention_wgmma_one_row": (bf16, 128, 8, 2, 0, True, 1),
        }[name]
        xs = [_t(rng, (1, S, h, D), dt, dev) for h in (H, KV, KV)]

        def plain(q, k, v):
            return ref.flash_attention_ref(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=causal, window=window).transpose(1, 2)
        return (lambda *a: ops.flash_attention(*a, causal=causal,
                                               window=window), plain,
                xs, "flash_attention", (TOL[dt], TOL[dt]))
    if name == "rglru":
        xs = [-_t(rng, (2, 300, 96), f32, dev).abs() * 0.2,
              _t(rng, (2, 300, 96), f32, dev)]
        return ops.rglru, ref.rglru_ref, xs, "rglru", (1e-4, 1e-3)
    if name == "mlstm":
        B, H, S, dh = 1, 2, 200, 64
        xs = [_t(rng, (B, H, S, dh), f32, dev) * dh ** -0.5,
              _t(rng, (B, H, S, dh), f32, dev),
              _t(rng, (B, H, S, dh), f32, dev), *_gates(rng, (B, H, S), dev)]
        return (lambda *a: ops.mlstm_chunkwise(*a, chunk=64),
                lambda *a: ref.mlstm_chunkwise_ref(*a, chunk=64), xs,
                "mlstm", (5e-4, 5e-3))
    dt = {"rmsnorm_f32": f32, "rmsnorm_bf16": bf16}[name]
    xs = [_t(rng, (4, 32, 2560), dt, dev), _t(rng, (2560,), dt, dev)]
    return (ops.rmsnorm, ref.rmsnorm_ref, xs, "rmsnorm",
            (1e-5, 1e-5) if dt == f32 else (2e-2, 2e-2))


@pytest.mark.parametrize("name", [
    "flash_attention_fma", "flash_attention_wgmma",
    "flash_attention_wgmma_d256_window", "flash_attention_fma_non_causal",
    "flash_attention_wgmma_non_causal_window",
    "flash_attention_wgmma_granite",
    "flash_attention_wgmma_starcoder2_window", "flash_attention_wgmma_d64",
    "flash_attention_wgmma_d80", "flash_attention_wgmma_d96",
    "flash_attention_wgmma_d112", "flash_attention_wgmma_one_row", "rglru",
    "mlstm", "rmsnorm_f32", "rmsnorm_bf16"])
def test_op_grads_cuda_vs_plain_autograd(dev, name):
    """The kernel's Function against autograd of its plain version (f32
    math) on the same card inputs: the forward launches the kernel once;
    the backward launches flash-attention's backward kernel once where
    ``bwd_route`` says ``"wgmma"`` (bf16 at D <= 128) and nothing else.

    The backward kernel rounds P and dS to bf16 before their products (as
    the forward rounds p), 2^-9 relative a term, and writes bf16: inside
    the bf16 tolerance of 2e-2."""
    rng = np.random.default_rng(9)
    op, plain, xs, kernel, (atol, rtol) = _grad_case(name, rng, dev)
    xs = [x.requires_grad_() for x in xs]
    n0, b0 = LAUNCHES[kernel], LAUNCHES["flash_attention_bwd"]
    out = op(*xs)
    ct = _t(rng, tuple(out.shape), out.dtype, dev)
    got = torch.autograd.grad(out, xs, ct)
    torch.cuda.synchronize()
    assert LAUNCHES[kernel] == n0 + 1
    q = xs[0]
    kernel_bwd = (kernel == "flash_attention"
                  and fa_bwd_route(q.dtype, q.shape[-1]) == "wgmma")
    assert kernel_bwd == (q.dtype == torch.bfloat16 and name.startswith(
        "flash_attention") and q.shape[-1] <= 128)
    assert LAUNCHES["flash_attention_bwd"] == b0 + kernel_bwd
    want = torch.autograd.grad(plain(*xs), xs, ct)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.float(), w.float(), atol=atol,
                                   rtol=rtol, msg=lambda m: f"input {i}: {m}")


@pytest.mark.parametrize("Sq,Sk,causal,window,D", [
    (300, 300, True, 0, 128), (100, 300, True, 0, 128),
    (300, 100, True, 48, 80), (200, 200, False, 0, 64),
    (257, 257, True, 130, 112), (200, 200, False, 48, 96)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_cuda_lse_and_bwd_kernel(dev, Sq, Sk, causal, window,
                                                 D, dtype):
    """The forward's log-sum-exp on both routes against the plain one; in
    bf16 the backward kernel against its arithmetic emulated in f32
    (``ref.flash_attention_bwd_ref`` with P and dS rounded to bf16), on
    the kernel's own output and log-sum-exp: Sq != Sk, non-causal, ragged
    tiles."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)
    rng = np.random.default_rng(11)
    q, k, v = (_t(rng, (1, S, h, D), dtype, dev).transpose(1, 2)
               for S, h in ((Sq, 8), (Sk, 2), (Sk, 2)))
    out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   return_lse=True)
    _, want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                      return_lse=True)
    torch.testing.assert_close(lse, want, atol=1e-3, rtol=1e-4)
    if dtype != torch.bfloat16:
        return
    dout = _t(rng, (1, Sq, 8, D), dtype, dev).transpose(1, 2)
    n0 = LAUNCHES["flash_attention_bwd"]
    got = flash_attention_bwd(dout, q, k, v, out, lse, causal=causal,
                              window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_bwd"] == n0 + 1
    emul = ref.flash_attention_bwd_ref(dout, q, k, v, out, lse,
                                       causal=causal, window=window,
                                       bf16_products=True)
    for g, w in zip(got, emul):
        assert g.shape == w.shape and g.dtype == w.dtype
        _close(g, w, dtype)


def test_flash_decode_cuda_raises_under_grad(dev):
    rng = np.random.default_rng(0)
    q = _t(rng, (1, 8, 128), torch.bfloat16, dev).requires_grad_()
    kc = _t(rng, (1, 64, 2, 128), torch.bfloat16, dev)
    n0 = LAUNCHES["flash_decode"]
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_decode(q, kc, kc, 10)
    assert LAUNCHES["flash_decode"] == n0


def _rel_l2(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


# per-leaf relative L2 error of the step-0 grads, "cuda" plan against
# "plain" plan on the same weights and batch: in f32 the plans differ by
# the kernels' f32 error only; in bf16 the two attention paths round the
# residual stream differently (one bf16 ulp is 2^-8 relative).  A dropped
# gradient reads 1.0.
GRAD_REL_L2 = {"float32": 1e-4, "bfloat16": 0.1}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_grads_cuda_plan_match_plain_plan(dev, dtype):
    """granite-8b at full width cut to 2 layers, B=1, S=256."""
    cfg = dataclasses.replace(get_arch("granite-8b"), num_layers=2,
                              dtype=dtype)
    params, _ = init_train_state(cfg, _plan(cfg, "plain"),
                                 torch.Generator().manual_seed(0), dev)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, 257))).to(dev)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    reset_launches()
    _, _, cuda = make_grads(cfg, _plan(cfg, "cuda"), device=dev)(params,
                                                                 batch)
    assert LAUNCHES["flash_attention"] == cfg.num_layers
    assert LAUNCHES["flash_attention_bwd"] == (
        cfg.num_layers if dtype == "bfloat16" else 0)
    _, _, plain = make_grads(cfg, _plan(cfg, "plain"), device=dev)(params,
                                                                   batch)
    for g, w in zip(tree_leaves(cuda), tree_leaves(plain)):
        assert float(g.float().norm()) > 0
        assert _rel_l2(g, w) < GRAD_REL_L2[dtype]


def test_train_step_spans_on_the_card(dev):
    """The program's tracer on one granite-8b step (full width, 2 layers,
    bf16, B=1, S=1024) under a cuda plan: every flash-attention backward
    span sits under ``train.backward`` with device time and the backward
    kernel's route, and the device ms
    of ``train.forward`` and ``train.backward`` come within 5 % of
    ``train.grads``'s."""
    from repro_torch.runtime import trace
    cfg = dataclasses.replace(get_arch("granite-8b"), num_layers=2,
                              dtype="bfloat16")
    plan = _plan(cfg, "cuda")
    params, opt = init_train_state(cfg, plan,
                                   torch.Generator().manual_seed(0), dev)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, 1025))).to(dev)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    step = make_train_step(cfg, plan, device=dev, warmup=0)
    params, opt, _ = step(params, opt, batch)       # builds the kernels
    trace.clear()
    trace.enable(device_timing=True)
    try:
        step(params, opt, batch)
        spans = trace.export()
    finally:
        trace.disable()
        trace.clear()
    by_id = {s["id"]: s for s in spans}
    one = {s["name"]: s for s in spans}
    fa = [s for s in spans if s["name"] == "kernels.flash_attention.bwd"]
    assert len(fa) == cfg.num_layers
    for s in fa:
        assert by_id[s["parent"]]["name"] == "train.backward"
        assert s["device_ms"] > 0 and s["attrs"]["route"] == "wgmma"
    assert one["train.step"]["counters"]["alloc.device_mallocs"] >= 0
    parts = one["train.forward"]["device_ms"] + \
        one["train.backward"]["device_ms"]
    assert parts == pytest.approx(one["train.grads"]["device_ms"], rel=0.05)


def test_moe_train_grads_cuda_plan_match_plain_plan(dev):
    """qwen3-moe-30b-a3b at full width cut to 2 layers, f32, B=1, S=256:
    logits and step-0 grads of the "cuda" plan against the "plain" plan,
    every leaf's grad > 0 (the routers' through the gates and the aux
    loss), and the same expert choices in both plans."""
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_arch("qwen3-moe-30b-a3b"), num_layers=2,
                              dtype="float32")
    params, _ = init_train_state(cfg, _plan(cfg, "plain"),
                                 torch.Generator().manual_seed(0), dev)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, 257))).to(dev)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    routes, route = {}, moe.route

    def run(kernel):
        def rec(router, xf, k):
            out = route(router, xf, k)
            routes.setdefault(kernel, []).append(out[2].clone())
            return out
        moe.route = rec
        try:
            with torch.no_grad():
                logits = make_prefill(cfg, _plan(cfg, kernel), device=dev)(
                    params, {"tokens": batch["tokens"]})
            return logits, make_grads(cfg, _plan(cfg, kernel),
                                      device=dev)(params, batch)
        finally:
            moe.route = route
    reset_launches()
    a, (loss_a, m_a, cuda) = run("cuda")
    assert LAUNCHES["flash_attention"] == 2 * cfg.num_layers
    b, (loss_b, m_b, plain) = run("plain")
    for x, y in zip(routes["cuda"], routes["plain"]):
        assert torch.equal(x.sort(-1).values, y.sort(-1).values)
    torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    assert float(m_a["aux_loss"]) == pytest.approx(float(m_b["aux_loss"]),
                                                   rel=1e-5)
    for g, w in zip(tree_leaves(cuda), tree_leaves(plain)):
        assert float(g.float().norm()) > 0
        assert _rel_l2(g, w) < GRAD_REL_L2["float32"]


@pytest.mark.parametrize("remat,per_step", [("none", 1), ("dots", 2),
                                            ("full", 2)])
def test_train_step_cuda_launches_under_remat(dev, remat, per_step):
    """A rematerialized layer reruns its forward in the backward, and with
    it the kernel: flash-attention launches per_step x layers a step."""
    cfg = get_arch("granite-8b").smoke()
    plan = uniform_plan(cfg, "tensor_par", set(),
                        SegmentClause(kernel="cuda", remat=remat))
    params, opt = init_train_state(cfg, plan,
                                   torch.Generator().manual_seed(0), dev)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 33))).to(dev)
    step = make_train_step(cfg, plan, device=dev)
    reset_launches()
    for _ in range(2):
        params, opt, m = step(params, opt, {"tokens": toks[:, :-1],
                                            "targets": toks[:, 1:]})
    assert bool(torch.isfinite(m["total_loss"]))
    assert LAUNCHES["flash_attention"] == 2 * per_step * cfg.num_layers
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(params))


# --- the sweep on the card ---------------------------------------------------------

def test_wallclock_executor_times_with_cuda_events(dev):
    """Medians of CUDA-event times, the card's peak memory over the job,
    and the card's name in the score-cache tag."""
    cfg, shape = get_arch("granite-8b").smoke(), \
        get_shape("train_4k").smoke()
    ex = WallClockExecutor(dev, repeats=3)
    assert ex.cache_tag == \
        f"wallclock:r3:cuda:{torch.cuda.get_device_name(dev)}"
    seg = fragment(cfg)[1]
    reset_launches()
    t = ex.score_segment(cfg, shape, seg, Combination(
        "fsdp", frozenset(), SegmentClause(kernel="cuda")))
    times = t.detail["repeats_s"]
    assert len(times) == 3 and t.total_s == statistics.median(times) > 0
    assert t.detail["peak_bytes"] > 0
    assert LAUNCHES["flash_attention"] == 4 * cfg.num_layers   # 1 + 3 calls


def test_oversized_segment_is_a_failed_row_and_frees_its_memory(dev):
    """granite-8b, one layer at full width, B=16, S=16384: the layer's
    and the head's train programs do not fit the card; their rows fail
    with the OOM, and every block the jobs took is handed back."""
    cfg = dataclasses.replace(get_arch("granite-8b"), num_layers=1)
    shape = ShapeConfig("huge", 16384, 16, "train")
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    tuner = ComParTuner(cfg, shape, device=dev, executor="wallclock")
    tuner.executor.repeats = 1
    with pytest.raises(ValueError, match="no valid combination"):
        tuner.sweep(["fsdp"], {"remat": ("none",), "kernel": ("plain",)})
    rows = {r["segment"]: r for r in tuner.db.results(tuner.project)}
    assert rows["g0"]["status"] == "failed"
    assert "OutOfMemoryError" in rows["g0"]["error"]
    assert not tuner.db.pending(tuner.project)
    torch.cuda.synchronize(dev)
    assert torch.cuda.memory_allocated(dev) - base < 64 * 2**20


@pytest.mark.parametrize("name,shape_name,kernels", [
    ("granite-8b", "train_4k", {"flash_attention"}),
    ("recurrentgemma-2b", "prefill_32k", {"rglru", "flash_attention"}),
    ("xlstm-125m", "prefill_32k", {"mlstm"})])
def test_cuda_clause_sweep_launches_the_kernels(dev, name, shape_name,
                                                kernels):
    cfg, shape = get_arch(name).smoke(), get_shape(shape_name).smoke()
    tuner = ComParTuner(cfg, shape, device=dev, executor="wallclock")
    tuner.executor.repeats = 1
    reset_launches()
    plan, rep = tuner.sweep(["fsdp"], {"kernel": ("plain", "cuda"),
                                       "block_q": (16,), "mlstm_chunk": (16,)})
    assert rep.n_done == rep.n_combinations and rep.n_failed == 0
    assert {k for k, n in LAUNCHES.items() if n} == kernels


# --- the tuned-plan loop: calibration, autotuner, lint ----------------------

def test_calibration_readings_on_the_card(dev):
    """Readings, not speed: above 0 and no more than 1.05x the H100 SXM
    data sheet (989 TFLOP/s bf16, 67 f32, 3.35 TB/s); bf16 and HBM at
    least 0.3 and 0.5 of it, or the profile would mislead the dry run."""
    from repro_torch.core import machine as M
    prof = M.calibrate(device=dev)
    sheet = {"bfloat16": 989e12, "float32": 67e12}
    for dt, peak in sheet.items():
        assert 0 < prof.peak_flops[dt] <= 1.05 * peak, dt
    assert prof.peak_flops["bfloat16"] >= 0.3 * sheet["bfloat16"]
    assert 0.5 * 3.35e12 <= prof.hbm_bw <= 1.05 * 3.35e12
    assert prof.key == M.profile_key("cuda", torch.cuda.get_device_name(dev),
                                     torch.cuda.device_count())
    hw = M.hardware_from_profile(prof)
    assert hw.peak_flops == prof.peak_flops["bfloat16"]
    assert hw.name == f"cal1-cuda-{prof.pid[:8]}"


def test_autotune_one_op_on_the_card(dev):
    """flash-attention at granite-8b's heads, S=1024: the cuda variants
    run one program (one launch a call) and share its outcome; the plain
    variants launch nothing; a second measurement is the cache's."""
    import repro_torch.kernels.autotune as AT
    from repro_torch.core.db import SweepDB
    cfg = dataclasses.replace(get_arch("granite-8b"), num_layers=1)
    shape = ShapeConfig("prefill-1x1024", 1024, 1, "prefill")
    ex = WallClockExecutor(dev, repeats=3)
    db = SweepDB()
    reset_launches()
    res, timed, _ = AT.measure_op(db, "flash_attention", cfg, shape,
                                  AT.DEFAULT_KERNEL_SPACE, ex)
    assert LAUNCHES["flash_attention"] == 1 + ex.repeats and timed == 8
    cuda = [e for k, e in res.items() if "kernel=cuda" in k]
    plain = [e for k, e in res.items() if "kernel=plain" in k]
    assert len({e["time_s"] for e in cuda}) == 1
    assert all(e["status"] == "done" for e in res.values())
    assert min(e["time_s"] for e in plain) > cuda[0]["time_s"]
    reset_launches()
    _, timed, cached = AT.measure_op(db, "flash_attention", cfg, shape,
                                     AT.DEFAULT_KERNEL_SPACE, ex)
    assert (timed, cached) == (0, 8) and not any(LAUNCHES.values())


def _refused(base, **change):
    return dataclasses.replace(base, **change)


@pytest.mark.parametrize("case", ["head_dim", "kv_heads", "dtype",
                                  "mlstm_dh"])
def test_cuda_lint_errors_match_the_wrapper_raises(dev, case):
    """Each cuda-* ERROR of the lint is the refusal the kernel's wrapper
    raises on the op program's tensors, message for message; the same
    config without the change runs."""
    import repro_torch.kernels.autotune as AT
    from repro_torch.analysis.rules import lint_schedule
    g = get_arch("granite-8b").smoke()
    x = get_arch("xlstm-125m").smoke()
    prefill = get_shape("prefill_32k").smoke()
    decode = get_shape("decode_32k").smoke()
    cases = {
        "head_dim": (g, dict(head_dim=48),
                     [("flash_attention", prefill), ("flash_decode", decode)]),
        "kv_heads": (g, dict(num_heads=6, num_kv_heads=4),
                     [("flash_attention", prefill), ("flash_decode", decode)]),
        "dtype": (g, dict(dtype="float16"),
                  [("flash_attention", prefill), ("flash_decode", decode)]),
        "mlstm_dh": (x, dict(d_model=640, num_heads=2),
                     [("mlstm_chunkwise", prefill)]),
    }
    base, change, sites = cases[case]
    for op, shape in sites:
        fields = {f: v for f, v in (("kernel", "cuda"), ("block_q", 16),
                                    ("block_k", 16), ("mlstm_chunk", 16))
                  if f in AT.OP_FIELDS[op]}
        for cfg, refused in ((base, False), (_refused(base, **change), True)):
            errs = [d for d in lint_schedule(op, fields, cfg, shape)
                    if d.is_error]
            fn, args = AT._op_program(op, fields, cfg, shape, dev)
            with torch.no_grad():
                if not refused:
                    assert errs == []
                    fn(*args)
                    continue
                assert len(errs) == 1 and errs[0].rule.startswith("cuda-")
                with pytest.raises((ValueError, TypeError)) as exc:
                    fn(*args)
            assert str(exc.value) == errs[0].message


# --- the process and remote backends on the card -------------------------------

def _stack_job(cfg, kernel="cuda"):
    from repro_torch.core.backends import JobSpec
    seg = next(s for s in fragment(cfg) if s.kind == "stack")
    return JobSpec(f"g/{kernel}", seg, Combination(
        "fsdp", frozenset(), SegmentClause(kernel=kernel)),
        segments=(seg.name,))


def _free_after(dev, free0, slack=64 * 2**20, wait_s=20.0):
    """The card's free memory, polled until it is back within ``slack``
    of ``free0`` (a dead process's context is freed as it exits)."""
    import time
    t0 = time.monotonic()
    while True:
        torch.cuda.empty_cache()
        free = torch.cuda.mem_get_info(dev)[0]
        if abs(free - free0) <= slack or time.monotonic() - t0 > wait_s:
            return free
        time.sleep(0.2)


def test_process_worker_scores_a_cuda_job_after_the_parent_used_cuda(dev):
    """The parent holds a CUDA context; "auto" never forks it: the spawned
    worker times the cuda job on the card and its flash-attention launches
    ride back on its shutdown acknowledgement."""
    from repro_torch.core.backends import ProcessBackend
    torch.zeros(1, device=dev).add_(1)
    torch.cuda.synchronize(dev)
    cfg, shape = get_arch("granite-8b").smoke(), \
        get_shape("train_4k").smoke()
    backend = ProcessBackend(WallClockExecutor(dev, repeats=3), cfg, shape,
                             workers=1, timeout_s=120, start_method="auto")
    try:
        outs = list(backend.run([_stack_job(cfg)]))
    finally:
        backend.close()
    assert [(o.status, o.attempts) for o in outs] == [("done", 1)], outs
    assert outs[0].cost["total_s"] > 0
    assert backend.launches["flash_attention"] == 4 * cfg.num_layers


def test_killed_worker_requeues_and_its_memory_comes_back(dev):
    """A FaultPlan kills the worker holding a wall-clock cuda job: the job
    completes on a fresh worker, the card's free memory after close()
    matches the reading before the pool, and the parent's CUDA works."""
    from repro_torch.core.backends import ProcessBackend
    from repro_torch.core.backends.faults import KILL, FaultPlan, FaultRule
    cfg, shape = get_arch("granite-8b").smoke(), \
        get_shape("train_4k").smoke()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info(dev)[0]
    plan = FaultPlan({"process.kill_worker": [FaultRule(KILL, at=(1,))]})
    backend = ProcessBackend(WallClockExecutor(dev, repeats=3), cfg, shape,
                             workers=1, timeout_s=120, fault_plan=plan)
    try:
        outs = list(backend.run([_stack_job(cfg)]))
    finally:
        backend.close()
    assert [(o.status, o.attempts) for o in outs] == [("done", 2)], outs
    assert plan.events == [("process.kill_worker", 1, KILL)]
    assert len({w for _, w in backend.dispatch_log}) == 2
    free = _free_after(dev, free0)
    assert abs(free - free0) <= 64 * 2**20, (free0, free)
    x = torch.ones(256, device=dev)
    assert float(x.sum()) == 256.0


def test_deadline_interrupted_job_then_a_clean_median(dev):
    """SIGALRM interrupts a wall-clock job between launches with device
    work still queued; the next job's synchronize and the collection after
    the failure keep that tail out of its median and its memory."""
    from repro_torch.core.executor import CombinationFailed
    cfg = dataclasses.replace(get_arch("granite-8b"), num_layers=1)
    shape = ShapeConfig("train-1x2048", 2048, 1, "train")
    seg = fragment(cfg)[1]
    combo = Combination("fsdp", frozenset(), SegmentClause(kernel="cuda"))
    ex = WallClockExecutor(dev, repeats=5, timeout_s=120)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    m0 = ex.score_segment(cfg, shape, seg, combo).total_s
    heavy = dataclasses.replace(cfg, num_layers=4)
    cut = WallClockExecutor(dev, repeats=50, timeout_s=1.0)
    with pytest.raises(CombinationFailed, match="deadline") as ei:
        cut.score_segment(heavy, ShapeConfig("train-1x4096", 4096, 1,
                                             "train"),
                          fragment(heavy)[1], combo)
    assert ei.value.transient
    torch.cuda.synchronize(dev)
    assert torch.cuda.memory_allocated(dev) - base < 64 * 2**20
    m1 = ex.score_segment(cfg, shape, seg, combo).total_s
    assert 0.67 < m1 / m0 < 1.5, (m0, m1)


def test_cuda_wallclock_spec_scored_by_the_server(dev, tmp_path):
    """A client's wall-clock cuda spec shipped to a loopback scoring
    server is timed on the server's card (its cache tag names that card)
    and served from its cache to a second client."""
    from repro_torch.core.backends import RemoteBackend, env_key, shape_key
    from repro_torch.core.backends.server import SweepScoringServer
    cfg, shape = get_arch("granite-8b").smoke(), \
        get_shape("train_4k").smoke()
    ex = WallClockExecutor(dev, repeats=3)
    srv = SweepScoringServer(str(tmp_path / "srv.db"), workers=1)
    srv.start()
    try:
        job = dataclasses.replace(_stack_job(cfg), signature="sig",
                                  eff_cid="ec")
        outs = []
        for _ in range(2):
            client = RemoteBackend(ex, cfg, shape, url=srv.url,
                                   shape_key=shape_key(shape),
                                   mesh_key=env_key(None, ex))
            outs += list(client.run([job]))
        stats = srv.stats()
    finally:
        srv.close()
    assert [(o.status, o.cached) for o in outs] == \
        [("done", False), ("done", True)], outs
    assert outs[0].cost["total_s"] > 0
    assert stats["n_compiled"] == 1 and stats["n_cache_hits"] == 1


# --- the ops' sharding rules on a one-card NCCL mesh ---------------------------

@pytest.fixture
def nccl_mesh(dev):
    """A (1, 1) ``data x model`` DeviceMesh of a world-size-1 NCCL group
    (NCCL puts no two ranks on one card), destroyed after the test."""
    from repro_torch.launch.mesh import destroy_group, device_mesh
    try:
        yield device_mesh((1, 1), ("data", "model"), "cuda")
    finally:
        destroy_group()


def _dt(t, mesh, placements):
    from repro_torch.runtime.sharding import Sharding, distribute
    return distribute(t, Sharding(mesh, tuple(placements)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_op_rules_on_nccl_mesh_run_the_kernels(nccl_mesh, dtype):
    """Each kernel op handed DTensors (batch on ``data``, heads on
    ``model``, and a layout it must gather) runs its hand kernel on the
    local shard: the result equals the meshless kernel call, one launch
    per call, and the op's backward runs through the placements."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.runtime.sharding import full
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    mesh = nccl_mesh
    bh = (Shard(0), Shard(2))
    q, k, v = (_t(rng, (2, 256, h, 128), dtype, dev) for h in (8, 2, 2))
    reset_launches()
    got = ops.flash_attention(*(_dt(t, mesh, bh) for t in (q, k, v)))
    assert isinstance(got, DTensor) and LAUNCHES["flash_attention"] == 1
    _close(full(got), ops.flash_attention(q, k, v), dtype)
    # sequence-sharded K/V: gathered to the kernel's whole sequence
    got = ops.flash_attention(_dt(q, mesh, bh),
                              *(_dt(t, mesh, (Shard(1), Replicate()))
                                for t in (k, v)))
    _close(full(got), ops.flash_attention(q, k, v), dtype)
    qg = _dt(q.clone().requires_grad_(), mesh, bh).requires_grad_()
    ops.flash_attention(qg, _dt(k, mesh, bh), _dt(v, mesh, bh)).sum().backward()
    assert qg.grad is not None and torch.isfinite(full(qg.grad)).all()

    q1 = _t(rng, (2, 8, 128), dtype, dev)
    kc, vc = (_t(rng, (2, 512, 2, 128), dtype, dev) for _ in range(2))
    reset_launches()
    with torch.no_grad():
        got = ops.flash_decode(_dt(q1, mesh, (Shard(0), Shard(1))),
                               _dt(kc, mesh, (Shard(0), Shard(1))),
                               _dt(vc, mesh, (Shard(0), Shard(2))), 300)
    assert LAUNCHES["flash_decode"] == 1
    _close(full(got), ops.flash_decode(q1, kc, vc, 300), dtype)

    la = -torch.rand((2, 300, 64), generator=torch.Generator().manual_seed(1)
                     ).to(dev)
    b = _t(rng, (2, 300, 64), torch.float32, dev)
    got = ops.rglru(_dt(la, mesh, (Shard(0), Shard(2))),
                    _dt(b, mesh, (Shard(0), Shard(2))))
    torch.testing.assert_close(full(got), ops.rglru(la, b), atol=1e-5,
                               rtol=1e-4)

    qm, km, vm = (_t(rng, (2, 4, 256, 64), torch.float32, dev) * 0.1
                  for _ in range(3))
    li, lf = (_t(rng, (2, 4, 256), torch.float32, dev) for _ in range(2))
    lf = torch.nn.functional.logsigmoid(lf)
    pl = (Shard(0), Shard(1))
    got = ops.mlstm_chunkwise(*(_dt(t, mesh, pl)
                                for t in (qm, km, vm, li, lf)))
    torch.testing.assert_close(full(got),
                               ops.mlstm_chunkwise(qm, km, vm, li, lf),
                               atol=5e-4, rtol=5e-3)


def test_meshed_prefill_and_engine_on_nccl_mesh(nccl_mesh):
    """granite at smoke width on the card's (1, 1) mesh, ``tensor_par``,
    ``cuda`` plan: prefill logits equal the meshless run's, the engine's
    batched streams equal its sequential ones."""
    from repro_torch.core.plan import segment_rules
    from repro_torch.models.params import place_params
    cfg = get_arch("granite-8b").smoke()
    plan = uniform_plan(cfg, "tensor_par", clause=SegmentClause(kernel="cuda"))
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(0))
    placed = place_params(params, model_specs(cfg),
                          segment_rules(cfg, plan, nccl_mesh))
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(1)).cuda()
    with torch.no_grad():
        want = make_prefill(cfg, plan)(params, {"tokens": toks})
        got = make_prefill(cfg, plan, mesh=nccl_mesh)(placed,
                                                      {"tokens": toks})
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)
    eng = ServeEngine(cfg, plan, capacity=4, cache_len=64, params=placed,
                      mesh=nccl_mesh)
    reqs = [Request(f"r{i}", tuple(range(1, 4 + i)), 4) for i in range(5)]
    a, b = eng.run(reqs), eng.run(reqs, max_active=1)
    assert all(a[r.rid].tokens == b[r.rid].tokens for r in reqs)
