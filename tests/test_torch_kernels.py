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
from repro.kernels.flash_decode import flash_decode_fwd
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
              if {"attn", "attn_moe"} & set(c.block_kinds())}
    # stablelm-3b, kimi-k2, granite-8b and qwen3-moe, recurrentgemma
    assert served == {80, 112, 128, 256}
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


# The CUDA flash-decode kernel's schedule (csrc/flash_decode.cu): its
# constants and split policy, mirrored here to emulate its order of work.
FD_NW, FD_T, FD_GMAX, FD_CLUSTER, H100_SMS = 8, 4, 4, 8, 132


def _fd_geometry(D):
    """(lanes of a row group, row groups of a CTA, keys of an iteration)."""
    lpr = max(2, 1 << (D // 8 - 1).bit_length())
    nsg = FD_NW * (32 // lpr)
    return lpr, nsg, nsg * FD_T


def _fd_splits(ctas, nchunks, n_sm=H100_SMS):
    cap = min(-(-2 * n_sm // ctas), nchunks, FD_CLUSTER)
    n = 1
    while 2 * n <= cap:
        n *= 2
    return n


def _fd_plan(B, KV, G, nchunks, n_sm=H100_SMS):
    """(heads per CTA, slices per kv head, CTAs per slice): slices of 4
    heads, or of one head where every CTA would walk a single chunk and
    the card would still be idle."""
    nslice = -(-G // FD_GMAX)
    nsplit = _fd_splits(B * KV * nslice, nchunks, n_sm)
    if G > 1 and nsplit >= nchunks and B * KV * nslice * nsplit < n_sm:
        return 1, G, _fd_splits(B * KV * G, nchunks, n_sm)
    return FD_GMAX, nslice, nsplit


def _softmax_merge(a, b):
    """Two (m, l, acc) partials of the same heads, in the log2 domain."""
    (ma, la, aa), (mb, lb, ab) = a, b
    mx = torch.maximum(ma, mb)
    wa, wb = torch.exp2(ma - mx), torch.exp2(mb - mx)
    return mx, la * wa + lb * wb, aa * wa[..., None] + ab * wb[..., None]


def _flash_decode_schedule(q, k, v, pos, *, n_sm=H100_SMS):
    """Plain-torch emulation of the one-launch CUDA kernel, f32.

    q (B,H,D); k/v (B,Smax,KV,D).  Per (batch, kv head, slice of the
    group's heads, by the kernel's plan): the keys in chunks of one CTA
    iteration, the chunks split over ``nsplit`` CTAs; in a CTA, key j of
    an iteration goes to row group j % NSG, T keys at a time, each row
    group with its own online softmax in exp2; then the row groups of a
    warp by the xor butterfly, the warps of the CTA, and the CTAs of the
    cluster.  Returns (out in q's dtype, lse f32, the plan)."""
    B, H, D = q.shape
    Smax, KV = k.shape[1], k.shape[2]
    G = H // KV
    n_keys = min(pos + 1, Smax)
    lpr, nsg, ch = _fd_geometry(D)
    rpw = 32 // lpr
    nchunks = -(-n_keys // ch)
    fd_plan = _fd_plan(B, KV, G, nchunks, n_sm)
    _, nslice, nsplit = fd_plan
    out = torch.empty((B, H, D))
    lse = torch.empty((B, H))
    for b, kvh, sl in np.ndindex(B, KV, nslice):
        g0, g1 = sl * G // nslice, (sl + 1) * G // nslice
        heads = slice(kvh * G + g0, kvh * G + g1)
        qs = q[b, heads].float() * (D ** -0.5 * np.log2(np.e))
        kk, vv = k[b, :, kvh].float(), v[b, :, kvh].float()
        ctas = []
        for r in range(nsplit):
            c0, c1 = r * nchunks // nsplit, (r + 1) * nchunks // nsplit
            kbeg, kend = c0 * ch, min(c1 * ch, n_keys)
            m = torch.full((nsg, g1 - g0), ref.NEG_INF)
            l = torch.zeros_like(m)
            acc = torch.zeros((nsg, g1 - g0, D))
            for base in range(kbeg, kend, ch):
                j = base + torch.arange(FD_T)[:, None] * nsg + \
                    torch.arange(nsg)[None, :]            # (T, NSG)
                ok = j < kend
                jc = j.clamp(max=kend - 1)
                s = torch.einsum("gd,tnd->tng", qs, kk[jc])
                s = torch.where(ok[..., None], s, ref.NEG_INF)
                mx = torch.maximum(m, s.amax(0))
                p = torch.where(ok[..., None], torch.exp2(s - mx), 0.0)
                alpha = torch.exp2(m - mx)
                l = l * alpha + p.sum(0)
                acc = acc * alpha[..., None] + torch.einsum(
                    "tng,tnd->ngd", p, vv[jc])
                m = mx
            part = (m.reshape(FD_NW, rpw, -1), l.reshape(FD_NW, rpw, -1),
                    acc.reshape(FD_NW, rpw, g1 - g0, D))
            step = 1
            while step < rpw:         # the xor butterfly inside a warp
                idx = torch.arange(rpw) ^ step
                part = _softmax_merge(part, tuple(x[:, idx] for x in part))
                step *= 2
            wm, wl, wacc = (x[:, 0] for x in part)      # per warp
            M = wm.amax(0)
            x = torch.exp2(wm - M)
            ctas.append((M, (wl * x).sum(0), (wacc * x[..., None]).sum(0)))
        cm = torch.stack([c[0] for c in ctas])
        M = cm.amax(0)
        x = torch.exp2(cm - M)
        L = (torch.stack([c[1] for c in ctas]) * x).sum(0).clamp_min(1e-30)
        A = (torch.stack([c[2] for c in ctas]) * x[..., None]).sum(0)
        out[b, heads] = A / L[:, None]
        lse[b, heads] = (M + torch.log2(L)) * np.log(2.0)
    return out.to(q.dtype), lse, fd_plan


@pytest.mark.parametrize("B,H,KV,Smax,D,pos,want_plan", [
    # recurrentgemma-2b's heads: pos 0, the last key of the first chunk
    # and the first of the second (one-head slices: one chunk a CTA), the
    # last slot (10 chunks on a cluster of 8: slices of 4, 3 and 3 heads)
    (1, 10, 1, 320, 256, 0, (1, 10, 1)),
    (1, 10, 1, 320, 256, 31, (1, 10, 1)),
    (1, 10, 1, 320, 256, 32, (1, 10, 2)),
    (1, 10, 1, 320, 256, 319, (4, 3, 8)),
    (2, 8, 2, 256, 128, 63, (1, 4, 1)),     # granite's G=4 at D=128
    (2, 8, 2, 256, 128, 64, (1, 4, 2)),
    (1, 4, 1, 1024, 128, 1023, (4, 1, 8)),  # 16 chunks, two per CTA of 8
    (1, 4, 2, 512, 32, 511, (1, 2, 2)),     # D=32: 256-key chunks, G=2
])
def test_flash_decode_schedule_matches_pallas(B, H, KV, Smax, D, pos,
                                              want_plan):
    """The one-launch CUDA kernel's order of work (key slices per row
    group, splits per CTA, the in-launch combine), emulated, against the
    Pallas kernel in interpret mode at two key blocks and the oracle:
    2e-5, the LSE in f32."""
    rng = np.random.default_rng(Smax + pos + H)
    jq, tq = _pair(rng, (B, H, D), "float32")
    jk, tk = _pair(rng, (B, Smax, KV, D), "float32")
    jv, tv = _pair(rng, (B, Smax, KV, D), "float32")
    got, lse, fd_plan = _flash_decode_schedule(tq, tk, tv, pos)
    assert fd_plan == want_plan
    hm = lambda x: jnp.moveaxis(x, 2, 1)            # noqa: E731
    for block_k in (32, 64):
        pallas, plse = flash_decode_fwd(jq, hm(jk), hm(jv), jnp.int32(pos),
                                        block_k=block_k, interpret=True,
                                        return_lse=True)
        _close(got, pallas, "float32")
        _close(lse, plse, "float32")
    _close(got, jref.flash_decode_ref(jq, jk, jv, pos), "float32")


def test_flash_decode_schedule_bf16():
    """bf16 cache at recurrentgemma-2b's heads, split over 8 CTAs: the
    emulated kernel against the oracle at 2e-2, its LSE at 2e-5."""
    rng = np.random.default_rng(7)
    jq, tq = _pair(rng, (1, 10, 256), "bfloat16")
    jk, tk = _pair(rng, (1, 320, 1, 256), "bfloat16")
    jv, tv = _pair(rng, (1, 320, 1, 256), "bfloat16")
    got, lse, fd_plan = _flash_decode_schedule(tq, tk, tv, 300)
    assert fd_plan == (4, 3, 8) and got.dtype == torch.bfloat16
    _close(got, jref.flash_decode_ref(jq, jk, jv, 300), "bfloat16")
    _, want_lse = ref.flash_decode_ref(tq, tk, tv, 300, return_lse=True)
    _close(lse, want_lse, "float32")


def test_flash_decode_schedule_plan():
    """The plan: one-head CTAs at granite-8b's admission (pos 63: 32 CTAs
    of one chunk), slices of 4 heads on 4 CTAs each at B=8 and pos 4095,
    on the 8 of a full cluster at B=1; never more CTAs than chunks; any G
    is sliced into groups of <= 4 heads."""
    _, _, ch = _fd_geometry(128)
    assert ch == 64
    assert _fd_plan(1, 8, 4, -(-64 // ch)) == (1, 4, 1)
    assert _fd_plan(8, 8, 4, -(-4096 // ch)) == (4, 1, 4)
    assert _fd_plan(1, 8, 4, -(-4096 // ch)) == (4, 1, 8)
    assert _fd_plan(1, 1, 10, -(-2048 // 32)) == (4, 3, 8)
    assert _fd_splits(1, 3) == 2
    assert _fd_geometry(256)[2] == 32 and _fd_geometry(80)[2] == 64
    for G in (1, 4, 5, 8, 10, 13):
        ns = -(-G // FD_GMAX)
        sizes = [(s + 1) * G // ns - s * G // ns for s in range(ns)]
        assert sum(sizes) == G and max(sizes) <= FD_GMAX


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


# The CUDA rglru kernel's tiles (csrc/rglru.cu): 16 warps of 16 steps each.
RG_NW, RG_L = 16, 16


def _rglru_tiles(log_a, b, *, lookback):
    """Plain-torch emulation of the split-sequence CUDA kernel, f32.

    Each warp scans its 16 steps from h = 0 (cum = running sum of log_a,
    h_local); a tile composes its 16 warps' aggregates (A, H); the carry
    into tile ti is composed from the tiles before it: ``lookback=1``
    reads tile ti-1's inclusive prefix (its predecessor finished first),
    ``lookback=None`` composes every predecessor's aggregate back to h_0
    = 0 (no inclusive prefix published yet), the two ends of what the
    kernel's look-back may meet.  Then h = h_local + exp(cum) * carry."""
    B, S, dr = log_a.shape
    tile = RG_NW * RG_L
    nT = -(-S // tile)
    pad = nT * tile - S
    la = torch.nn.functional.pad(log_a, (0, 0, 0, pad))
    bb = torch.nn.functional.pad(b, (0, 0, 0, pad))
    la = la.reshape(B, nT, RG_NW, RG_L, dr)
    bb = bb.reshape(B, nT, RG_NW, RG_L, dr)
    cum = torch.cumsum(la, 3)
    hl = torch.empty_like(bb)
    h = torch.zeros_like(bb[:, :, :, 0])
    for i in range(RG_L):                     # the warps' local scans
        h = torch.exp(la[:, :, :, i]) * h + bb[:, :, :, i]
        hl[:, :, :, i] = h
    wA, wH = cum[:, :, :, -1], hl[:, :, :, -1]          # (B, nT, NW, dr)
    A = torch.zeros_like(wA[:, :, 0])
    H = torch.zeros_like(wH[:, :, 0])
    for w in range(RG_NW):                    # each tile's aggregate
        H = torch.exp(wA[:, :, w]) * H + wH[:, :, w]
        A = A + wA[:, :, w]
    incl = torch.zeros_like(H)                # h at each tile's end
    h_in = torch.zeros_like(H)
    for ti in range(nT):
        if lookback == 1:
            h_in[:, ti] = incl[:, ti - 1] if ti else 0.0
        else:
            Aacc = torch.zeros_like(A[:, 0])
            Hacc = torch.zeros_like(H[:, 0])
            for j in range(ti - 1, -1, -1):
                Hacc = torch.exp(Aacc) * H[:, j] + Hacc
                Aacc = Aacc + A[:, j]
            h_in[:, ti] = Hacc
        incl[:, ti] = torch.exp(A[:, ti]) * h_in[:, ti] + H[:, ti]
    carry = torch.empty_like(wA)              # each warp's carry-in
    c = h_in
    for w in range(RG_NW):
        carry[:, :, w] = c
        c = torch.exp(wA[:, :, w]) * c + wH[:, :, w]
    out = hl + torch.exp(cum) * carry[:, :, :, None]
    return out.reshape(B, nT * tile, dr)[:, :S]


@pytest.mark.parametrize("B,S,dr,decay", [
    (2, 1, 40, "model"),          # S = 1: one step of one warp
    (1, 300, 48, "model"),        # S not a multiple of a warp or a tile
    (2, 1000, 33, "model"),       # four tiles, dr not a multiple of 32
    (1, 1100, 32, "slow"),        # log_a ~ -1e-4 over five tiles
])
@pytest.mark.parametrize("lookback", [1, None])
def test_rglru_tiles_match_pallas(B, S, dr, decay, lookback):
    """The split-sequence CUDA kernel's order of work (chunk-local scans,
    carry across tiles, fix-up), emulated, against the Pallas kernel in
    interpret mode at chunks 16 and 32 and the oracle: 1e-5 / 1e-4."""
    rng = np.random.default_rng(S + dr)
    if decay == "slow":
        la = (-1e-4 * rng.uniform(0.5, 1.5, (B, S, dr))).astype(np.float32)
    else:    # as the model makes it: -8 softplus(1) sigmoid(x)
        la = (-8.0 * np.log1p(np.e) / (1.0 + np.exp(
            -rng.standard_normal((B, S, dr))))).astype(np.float32)
    b = rng.standard_normal((B, S, dr)).astype(np.float32)
    got = _rglru_tiles(torch.from_numpy(la), torch.from_numpy(b),
                       lookback=lookback).numpy()
    assert got.shape == (B, S, dr) and np.isfinite(got).all()
    for chunk in (16, 32):
        pallas = rglru_fwd(jnp.asarray(la), jnp.asarray(b), chunk=chunk,
                           interpret=True)
        np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-5,
                                   rtol=1e-4)
    oracle = jax.jit(jref.rglru_ref)(jnp.asarray(la), jnp.asarray(b))
    np.testing.assert_allclose(got, np.asarray(oracle), atol=1e-5,
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
