"""The port's CUDA kernels and model on the card (skipped without one).

Torch only (no JAX), so the file also runs on a machine without JAX:
    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
Inputs come from a numpy seed; tolerances are those of
tests/test_kernels.py: 2e-5 f32 and 2e-2 bf16 for attention, 1e-5 / 1e-4
for rglru, 5e-4 / 5e-3 for mlstm, 1e-5 f32 and 2e-2 bf16 for rmsnorm.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core.plan import uniform_plan
from repro_torch.kernels import LAUNCHES, ops, ref, reset_launches
from repro_torch.models.context import SegmentClause
from repro_torch.models.model import model_specs
from repro_torch.models.params import init_params
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.step import make_prefill

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
    (1, 300, 32, 8, 128), (1, 65, 4, 4, 80), (1, 200, 10, 1, 256)])
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_cuda_vs_plain(dev, B, S, H, KV, D, window, dtype):
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


@pytest.mark.parametrize("B,Smax,H,KV,D", [
    (2, 256, 4, 2, 32), (1, 300, 8, 1, 16), (3, 1024, 32, 8, 128),
    (1, 129, 4, 4, 80), (1, 300, 8, 1, 256)])
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


def _gates(rng, shape, dev):
    li = rng.standard_normal(shape).astype(np.float32)
    lf = -np.logaddexp(0.0, -rng.standard_normal(shape)).astype(np.float32)
    return torch.from_numpy(li).to(dev), torch.from_numpy(lf).to(dev)


@pytest.mark.parametrize("B,S,dr", [(1, 64, 32), (2, 128, 96), (1, 100, 48),
                                    (1, 2048, 2560)])
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


@pytest.mark.parametrize("B,H,S,dh", [(1, 2, 64, 16), (2, 2, 128, 32),
                                      (1, 1, 96, 16), (1, 2, 200, 100),
                                      (1, 4, 512, 384)])
def test_mlstm_cuda_vs_plain(dev, B, H, S, dh):
    rng = np.random.default_rng(3)
    q = _t(rng, (B, H, S, dh), torch.float32, dev) * dh ** -0.5
    k = _t(rng, (B, H, S, dh), torch.float32, dev)
    v = _t(rng, (B, H, S, dh), torch.float32, dev)
    li, lf = _gates(rng, (B, H, S), dev)
    n0 = LAUNCHES["mlstm"]
    got = ops.mlstm_chunkwise(q, k, v, li, lf)
    torch.cuda.synchronize()
    assert LAUNCHES["mlstm"] == n0 + 1
    # the step-recurrent oracle, and the chunkwise plain version at two
    # chunks other than the kernel's own
    for want in (ref.mlstm_ref(q, k, v, li, lf),
                 ref.mlstm_chunkwise_ref(q, k, v, li, lf, chunk=256),
                 ref.mlstm_chunkwise_ref(q, k, v, li, lf, chunk=16)):
        torch.testing.assert_close(got, want, atol=5e-4, rtol=5e-3)


def test_mlstm_cuda_strided_inputs(dev):
    """The model passes q/k/v as permuted einsum outputs and the gates as
    transposed views: the kernel reads them through their strides."""
    rng = np.random.default_rng(4)
    B, S, H, dh = 2, 130, 3, 32
    q = _t(rng, (B, S, H, dh), torch.float32, dev).transpose(1, 2)
    k = _t(rng, (B, S, H, dh), torch.float32, dev).transpose(1, 2)
    v = _t(rng, (B, S, H, dh), torch.float32, dev).transpose(1, 2)
    li, lf = (g.transpose(1, 2) for g in _gates(rng, (B, S, H), dev))
    got = ops.mlstm_chunkwise(q, k, v, li, lf)
    want = ref.mlstm_chunkwise_ref(*(t.contiguous()
                                     for t in (q, k, v, li, lf)))
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
# rec, rec, attn group; xlstm 3 mlstm + 1 slstm layers
SMOKE_LAUNCHES = {"granite-8b": {"flash_attention": 2},
                  "recurrentgemma-2b": {"rglru": 2, "flash_attention": 1},
                  "xlstm-125m": {"mlstm": 3}}


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
    n_fd = 0 if cfg.window_size else cfg.block_kinds().count("attn")
    assert LAUNCHES["flash_decode"] == n_fd * sum(len(r.prompt)
                                                  for r in reqs)
    sequential = eng.run(reqs, max_active=1)
    for r in reqs:
        assert batched[r.rid].tokens == sequential[r.rid].tokens, r.rid
