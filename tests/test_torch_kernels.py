"""The port's kernel ops on the CPU (their plain versions) against the JAX
package's Pallas kernels in interpret mode and its pure-jnp oracles.

Inputs are made once with numpy from a seed and handed to both packages;
bf16 inputs are rounded from the same f32 values on both sides.
Tolerances are those of tests/test_kernels.py: 2e-5 in f32, 2e-2 in bf16
for attention; 1e-5 / 1e-4 for rglru; 5e-4 / 5e-3 for mlstm; 1e-5 in f32
and 2e-2 in bf16 for rmsnorm.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_fwd
from repro.kernels.mlstm import mlstm_chunkwise_fwd
from repro.kernels.rglru import rglru_fwd
from repro.kernels.rmsnorm import rmsnorm_fwd
from repro_torch.kernels import LAUNCHES, ops, ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _pair(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(JDT[dtype]), torch.from_numpy(x).to(
        TDT[dtype])


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


# --- flash attention ---------------------------------------------------------

@pytest.mark.parametrize("B,H,KV,S,D", [
    (1, 4, 4, 128, 32),     # MHA
    (2, 4, 2, 128, 32),     # GQA 2:1
    (1, 8, 1, 256, 16),     # MQA
])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas(B, H, KV, S, D, window, dtype):
    rng = np.random.default_rng(S + H + window)
    jq, tq = _pair(rng, (B, S, H, D), dtype)        # model layout
    jk, tk = _pair(rng, (B, S, KV, D), dtype)
    jv, tv = _pair(rng, (B, S, KV, D), dtype)
    n0 = LAUNCHES["flash_attention"]
    got = ops.flash_attention(tq, tk, tv, window=window, block_q=64,
                              block_k=64)
    assert LAUNCHES["flash_attention"] == n0      # CPU: no kernel launch
    assert got.shape == (B, S, H, D) and got.dtype == TDT[dtype]
    hm = lambda x: jnp.moveaxis(x, 2, 1)            # noqa: E731
    oracle = jref.flash_attention_ref(hm(jq), hm(jk), hm(jv), causal=True,
                                      window=window)
    _close(got, jnp.moveaxis(oracle, 1, 2), dtype)
    if (B, H, KV) == (2, 4, 2):
        # the Pallas kernel itself (interpret mode) on the GQA shape only:
        # each interpret-mode compile costs about a second here
        pallas = flash_attention_fwd(hm(jq), hm(jk), hm(jv), causal=True,
                                     window=window, block_q=64, block_k=64,
                                     interpret=True)
        _close(got, jnp.moveaxis(pallas, 1, 2), dtype)
    _close(ref.flash_attention_ref(tq.transpose(1, 2), tk.transpose(1, 2),
                                   tv.transpose(1, 2), window=window),
           oracle, dtype)


def test_flash_attention_route():
    """The route the CUDA wrapper takes: bf16 at the head_dim of every
    attention arch the port serves runs on the tensor cores (wgmma); f32,
    and bf16 at the other compiled head dims, keep the f32-FMA kernel."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels.build import HEAD_DIMS
    from repro_torch.kernels.flash_attention import WGMMA_HEAD_DIMS, route
    served = {c.head_dim_ for c in ARCHS.values()
              if "attn" in c.block_kinds()}
    assert served == {80, 128, 256}   # stablelm-3b, granite-8b, recurrentgemma
    for D in served:
        assert route(torch.bfloat16, D) == "wgmma"
    for D in HEAD_DIMS:
        assert route(torch.float32, D) == "fma"
        assert route(torch.bfloat16, D) == (
            "wgmma" if D in WGMMA_HEAD_DIMS else "fma")


def _attention_bf16_p(q, k, v, *, window, block_k):
    """The wgmma route's arithmetic, emulated: f32 scores, online softmax
    over key tiles of ``block_k``, p rounded to bf16 before P V (products
    of bf16 values summed in f32), l summed from the f32 p.

    q: (B,H,S,D), k/v: (B,KV,S,D) -> (B,H,S,D) in q's dtype."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    qf = q.float().reshape(B, KV, H // KV, S, D)
    kf, vf = k.float(), v.float()
    m = torch.full((B, KV, H // KV, S), ref.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    iq = torch.arange(S)[:, None]
    for k0 in range(0, S, block_k):
        jk = torch.arange(k0, min(k0 + block_k, S))[None, :]
        live = (iq >= jk) & ((iq - jk < window) if window else True)
        s = torch.einsum("bkgqd,bksd->bkgqs", qf,
                         kf[:, :, k0:k0 + block_k]) * D ** -0.5
        s = torch.where(live, s, ref.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(live, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqs,bksd->bkgqd", p.to(torch.bfloat16).float(),
            vf[:, :, k0:k0 + block_k])
        m = m_new
    o = acc / l.clamp_min(1e-30)[..., None]
    return o.reshape(B, H, S, D).to(q.dtype)


@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("block_k", [64, 128])
def test_flash_attention_bf16_p_contract(window, block_k):
    """The bf16 contract of the wgmma route against the Pallas kernel
    (interpret mode) on the GQA shape, at the bf16 tolerance.  Rounding p
    to bf16 moves an output element by at most about 2^-9 max|v|; the
    largest difference seen here is 0.0078 (one bf16 ulp of the output)."""
    B, H, KV, S, D = 2, 4, 2, 128, 32
    rng = np.random.default_rng(S + H + window)
    jq, tq = _pair(rng, (B, S, H, D), "bfloat16")
    jk, tk = _pair(rng, (B, S, KV, D), "bfloat16")
    jv, tv = _pair(rng, (B, S, KV, D), "bfloat16")
    got = _attention_bf16_p(tq.transpose(1, 2), tk.transpose(1, 2),
                            tv.transpose(1, 2), window=window,
                            block_k=block_k)
    hm = lambda x: jnp.moveaxis(x, 2, 1)            # noqa: E731
    pallas = flash_attention_fwd(hm(jq), hm(jk), hm(jv), causal=True,
                                 window=window, block_q=64, block_k=64,
                                 interpret=True)
    err = float(np.abs(_np(got) - _np(pallas)).max())
    assert err <= TOL["bfloat16"] / 2, err
    _close(got, pallas, "bfloat16")


# --- flash decode ------------------------------------------------------------

@pytest.mark.parametrize("pos", [0, 17, 255])
@pytest.mark.parametrize("KV", [1, 2, 4])
def test_flash_decode_matches_pallas(pos, KV):
    B, H, S, D = 2, 4, 256, 32
    rng = np.random.default_rng(pos * 7 + KV)
    jq, tq = _pair(rng, (B, H, D), "float32")
    jk, tk = _pair(rng, (B, S, KV, D), "float32")
    jv, tv = _pair(rng, (B, S, KV, D), "float32")
    got, lse = ops.flash_decode(tq, tk, tv, pos, return_lse=True)
    want, jlse = jops.flash_decode(jq, jk, jv, jnp.int32(pos), block_k=64,
                                   return_lse=True)
    _close(got, want, "float32")
    _close(lse, jlse, "float32")
    _close(got, jref.flash_decode_ref(jq, jk, jv, pos), "float32")


@pytest.mark.parametrize("pos", [5, 200])
def test_flash_decode_bf16_matches_oracle(pos):
    B, H, KV, S, D = 2, 8, 2, 256, 32
    rng = np.random.default_rng(pos)
    jq, tq = _pair(rng, (B, H, D), "bfloat16")
    jk, tk = _pair(rng, (B, S, KV, D), "bfloat16")
    jv, tv = _pair(rng, (B, S, KV, D), "bfloat16")
    got = ops.flash_decode(tq, tk, tv, pos)
    assert got.dtype == torch.bfloat16
    _close(got, jref.flash_decode_ref(jq, jk, jv, pos), "bfloat16")


def test_flash_decode_lse_combine():
    """Two sequence shards combined through their LSEs equal the unsharded
    result: the contract a sequence-sharded decode relies on."""
    B, H, S, D = 1, 2, 128, 16
    rng = np.random.default_rng(3)
    jq, tq = _pair(rng, (B, H, D), "float32")
    jk, tk = _pair(rng, (B, S, 1, D), "float32")
    jv, tv = _pair(rng, (B, S, 1, D), "float32")
    pos, half = 127, S // 2
    o1, l1 = ops.flash_decode(tq, tk[:, :half], tv[:, :half], pos,
                              return_lse=True)
    o2, l2 = ops.flash_decode(tq, tk[:, half:], tv[:, half:], pos - half,
                              return_lse=True)
    w1 = torch.exp(l1 - torch.logaddexp(l1, l2))[..., None]
    combined = o1 * w1 + o2 * (1 - w1)
    _close(combined, jref.flash_decode_ref(jq, jk, jv, pos), "float32")
    # each shard's LSE is the reference kernel's
    _, jl1 = jops.flash_decode(jq, jk[:, :half], jv[:, :half],
                               jnp.int32(pos), block_k=32, return_lse=True)
    _close(l1, jl1, "float32")


def test_flash_attention_head_dim_256_mqa_window():
    """recurrentgemma's attention: D=256, 10 query heads over 1 kv head, a
    window shorter than the sequence (the CUDA kernel's BQ=32 variant)."""
    B, S, H, KV, D, window = 1, 24, 10, 1, 256, 4
    rng = np.random.default_rng(256)
    jq, tq = _pair(rng, (B, S, H, D), "float32")
    jk, tk = _pair(rng, (B, S, KV, D), "float32")
    jv, tv = _pair(rng, (B, S, KV, D), "float32")
    got = ops.flash_attention(tq, tk, tv, window=window)
    hm = lambda x: jnp.moveaxis(x, 2, 1)            # noqa: E731
    pallas = flash_attention_fwd(hm(jq), hm(jk), hm(jv), causal=True,
                                 window=window, block_q=8, block_k=8,
                                 interpret=True)
    _close(got, jnp.moveaxis(pallas, 1, 2), "float32")


# --- rglru -------------------------------------------------------------------

def _gates(rng, shape):
    li = rng.standard_normal(shape).astype(np.float32)
    lf = -np.logaddexp(0.0, -rng.standard_normal(shape)).astype(np.float32)
    return li, lf


@pytest.mark.parametrize("B,S,dr,chunk", [
    (1, 64, 32, 16), (2, 128, 96, 64), (1, 100, 48, 32),  # odd S
])
def test_rglru_matches_pallas(B, S, dr, chunk):
    rng = np.random.default_rng(S + dr)
    la = -np.abs(rng.standard_normal((B, S, dr)).astype(np.float32)) * 0.2
    b = rng.standard_normal((B, S, dr)).astype(np.float32)
    n0 = LAUNCHES["rglru"]
    got = ops.rglru(torch.from_numpy(la), torch.from_numpy(b))
    assert LAUNCHES["rglru"] == n0 and got.dtype == torch.float32
    pallas = rglru_fwd(jnp.asarray(la), jnp.asarray(b), chunk=chunk,
                       interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=1e-5,
                               rtol=1e-4)
    # the oracle's associative scan, jitted (eager, it takes seconds)
    oracle = jax.jit(jref.rglru_ref)(jnp.asarray(la), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=1e-5,
                               rtol=1e-4)


# --- mlstm -------------------------------------------------------------------

def _mlstm_inputs(rng, B, H, S, dh):
    q = rng.standard_normal((B, H, S, dh)).astype(np.float32) * dh ** -0.5
    k = rng.standard_normal((B, H, S, dh)).astype(np.float32)
    v = rng.standard_normal((B, H, S, dh)).astype(np.float32)
    return (q, k, v) + _gates(rng, (B, H, S))


@pytest.mark.parametrize("B,H,S,dh,chunk", [
    (1, 2, 64, 16, 16), (2, 2, 128, 32, 32), (1, 1, 96, 16, 32),
])
def test_mlstm_matches_pallas(B, H, S, dh, chunk):
    ins = _mlstm_inputs(np.random.default_rng(S + dh), B, H, S, dh)
    n0 = LAUNCHES["mlstm"]
    got = ops.mlstm_chunkwise(*map(torch.from_numpy, ins), chunk=chunk)
    assert LAUNCHES["mlstm"] == n0 and got.shape == (B, H, S, dh)
    pallas = mlstm_chunkwise_fwd(*map(jnp.asarray, ins), chunk=chunk,
                                 interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=5e-4,
                               rtol=5e-3)
    # the step-recurrent oracles of both packages
    oracle = np.asarray(jref.mlstm_ref(*map(jnp.asarray, ins)))
    np.testing.assert_allclose(got.numpy(), oracle, atol=5e-4, rtol=5e-3)
    np.testing.assert_allclose(ref.mlstm_ref(*map(torch.from_numpy, ins)),
                               oracle, atol=5e-4, rtol=5e-3)


def test_mlstm_chunk_invariance():
    """The chunk is a performance knob (the CUDA kernel uses its own 64):
    the plain version's result must not change with it."""
    ins = tuple(map(torch.from_numpy, _mlstm_inputs(
        np.random.default_rng(7), 1, 2, 64, 16)))
    o16 = ops.mlstm_chunkwise(*ins, chunk=16)
    for c in (64, 100):          # 100 is clamped to a divisor of S (32)
        np.testing.assert_allclose(ops.mlstm_chunkwise(*ins, chunk=c), o16,
                                   atol=5e-4, rtol=5e-3)


def test_mlstm_chunk_invariance_exact_in_float64():
    """In float64 the chunkwise math does not depend on the chunk beyond
    rounding (and the e^-30 mask terms): the f32 differences between
    chunks are rounding of the in-chunk cumulative log-forget sums."""
    ins = tuple(torch.from_numpy(a).double() for a in _mlstm_inputs(
        np.random.default_rng(8), 1, 2, 512, 32))
    o256 = ref.mlstm_chunkwise_ref(*ins, chunk=256)
    assert o256.dtype == torch.float64
    np.testing.assert_allclose(ref.mlstm_chunkwise_ref(*ins, chunk=64),
                               o256, atol=1e-9, rtol=1e-9)
    np.testing.assert_allclose(ref.mlstm_ref(*ins), o256, atol=1e-9,
                               rtol=1e-9)


def _tf32(x):
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32``: add half of the dropped part to the
    magnitude bits, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the CUDA kernel's split product: a = hi + lo with hi =
    tf32(a), lo = tf32(a - hi), a b ~ lo hi' + hi lo' + hi hi'."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mlstm_chunk_parallel(q, k, v, li, lf, *, chunk=64, split=True):
    """Plain-torch emulation of the chunk-parallel CUDA kernel
    (``csrc/mlstm.cu``), in q's dtype.

    1. per full chunk, the chunk-local state update dC with its local key
       max mx (no incoming state); 2. the rescaling scan across chunks,
       which keeps the state *entering* each chunk; 3. every chunk's
       outputs from its entering state.  ``split``: products as 3xTF32
       (f32 only), else plain matmuls."""
    mm = _mm_3xtf32 if split else torch.matmul
    B, H, S, dh = q.shape
    nc = -(-S // chunk)
    C = q.new_zeros((B, H, dh, dh))
    n = q.new_zeros((B, H, dh))
    m = q.new_zeros((B, H))
    entering = [(C, n, m)]
    for c in range(nc - 1):                  # steps 1 and 2
        sl = slice(c * chunk, (c + 1) * chunk)
        b = torch.cumsum(lf[..., sl], -1)
        total = b[..., -1]
        kwlog = li[..., sl] + (total[..., None] - b)
        mx = kwlog.amax(-1)
        kw = k[:, :, sl] * torch.exp(kwlog - mx[..., None])[..., None]
        dC, dn = mm(kw.transpose(-1, -2), v[:, :, sl]), kw.sum(-2)
        m_new = torch.maximum(m + total, mx)
        a = torch.exp(m + total - m_new)     # exponents <= 0
        bw = torch.exp(mx - m_new)
        C = a[..., None, None] * C + bw[..., None, None] * dC
        n = a[..., None] * n + bw[..., None] * dn
        m = m_new
        entering.append((C, n, m))
    hs = []
    for c, (C, n, m) in enumerate(entering):  # step 3
        sl = slice(c * chunk, min((c + 1) * chunk, S))
        qc, kc, vc = q[:, :, sl], k[:, :, sl], v[:, :, sl]
        cl = qc.shape[2]
        b = torch.cumsum(lf[..., sl], -1)
        D = li[..., sl][..., None, :] + b[..., :, None] - b[..., None, :]
        D = torch.where(torch.ones(cl, cl, dtype=torch.bool).tril(), D,
                        ref.LOG_EPS)
        m_j = torch.maximum(D.amax(-1), m[..., None] + b)
        P = torch.exp(D - m_j[..., None]) * mm(qc, kc.transpose(-1, -2))
        sw = torch.exp(m[..., None] + b - m_j)
        num = mm(P, vc) + sw[..., None] * mm(qc, C)
        den = torch.maximum(((qc @ n[..., None])[..., 0] * sw
                             + P.sum(-1)).abs(), torch.exp(-m_j))
        hs.append(num / den[..., None])
    return torch.cat(hs, 2)


@pytest.mark.parametrize("B,H,S,dh", [
    (2, 2, 150, 24),      # ragged last chunk (64, 64, 22), dh % 16 != 0
    (1, 2, 40, 20),       # S < the chunk
    (2, 1, 128, 32),      # whole chunks
])
def test_mlstm_chunk_parallel_contract(B, H, S, dh):
    """The CUDA kernel's chunk-parallel arithmetic (local maxima, the
    rescaling scan, 3xTF32 products) against the Pallas kernel in
    interpret mode and the reference's step-recurrent oracle, at the
    mlstm tolerance."""
    ins = _mlstm_inputs(np.random.default_rng(S * dh + B), B, H, S, dh)
    got = _mlstm_chunk_parallel(*map(torch.from_numpy, ins)).numpy()
    assert np.isfinite(got).all()
    pallas = mlstm_chunkwise_fwd(*map(jnp.asarray, ins), chunk=64,
                                 interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=5e-4,
                               rtol=5e-3)
    oracle = np.asarray(jref.mlstm_ref(*map(jnp.asarray, ins)))
    np.testing.assert_allclose(got, oracle, atol=5e-4, rtol=5e-3)


@pytest.mark.parametrize("S", [150, 40])
def test_mlstm_chunk_parallel_exact_in_float64(S):
    """In float64 the rescaled chunk-local states are the step-recurrent
    oracle's to 1e-9: the rescaling is exact math, not an approximation."""
    ins = tuple(torch.from_numpy(a).double() for a in _mlstm_inputs(
        np.random.default_rng(S), 2, 2, S, 24))
    got = _mlstm_chunk_parallel(*ins, split=False)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got, ref.mlstm_ref(*ins), atol=1e-9,
                               rtol=1e-9)


def test_mlstm_chunk_parallel_stabilizer_stress():
    """Large input gates (li in [5, 10]) and forget gates near 1 (lf ~
    -1e-3) over 18 chunks: the stabilizer's exponents stay <= 0, so the
    output is finite and within the mlstm tolerance of the Pallas kernel
    and the oracle.  q and k are taken positive so that q.n, summed over
    ~1000 remembered keys, does not cancel: with signed keys the
    denominator passes near 0 and even the f32 oracle is off its float64
    self by more than the tolerance there."""
    rng = np.random.default_rng(12)
    B, H, S, dh = 1, 2, 18 * 64 - 5, 16
    q, k, v = _mlstm_inputs(rng, B, H, S, dh)[:3]
    q, k = np.abs(q), np.abs(k)
    li = rng.uniform(5.0, 10.0, (B, H, S)).astype(np.float32)
    lf = (-1e-3 * rng.uniform(0.5, 1.5, (B, H, S))).astype(np.float32)
    ins = (q, k, v, li, lf)
    got = _mlstm_chunk_parallel(*map(torch.from_numpy, ins)).numpy()
    assert np.isfinite(got).all()
    oracle = np.asarray(jref.mlstm_ref(*map(jnp.asarray, ins)))
    np.testing.assert_allclose(got, oracle, atol=5e-4, rtol=5e-3)
    pallas = mlstm_chunkwise_fwd(*map(jnp.asarray, ins), chunk=64,
                                 interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=5e-4,
                               rtol=5e-3)
    np.testing.assert_allclose(ref.mlstm_chunkwise_ref(
        *map(torch.from_numpy, ins), chunk=64), oracle, atol=5e-4,
        rtol=5e-3)


# --- rmsnorm -----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(32, 64), (128, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_pallas(shape, dtype):
    rng = np.random.default_rng(shape[0])
    jx, tx = _pair(rng, shape, dtype)
    js, ts = _pair(rng, shape[-1:], dtype)
    n0 = LAUNCHES["rmsnorm"]
    got = ops.rmsnorm(tx, ts)
    assert LAUNCHES["rmsnorm"] == n0 and got.dtype == TDT[dtype]
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    want = rmsnorm_fwd(jx, js, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    # leading axes are flattened into rows, as the reference's op does
    got3 = ops.rmsnorm(tx.reshape(2, -1, shape[-1]), ts)
    np.testing.assert_allclose(_np(got3).reshape(shape), _np(want),
                               atol=tol, rtol=tol)


def test_ops_reject_other_devices():
    q = torch.empty((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.flash_decode(q[:, 0], q, q, 1)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.rglru(q[0], q[0])
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.mlstm_chunkwise(q, q, q, q[..., 0], q[..., 0])
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.rmsnorm(q, q[0, 0, 0])
