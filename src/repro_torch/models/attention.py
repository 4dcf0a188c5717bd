"""Attention: GQA/MHA with RoPE, causal + sliding-window masks.

Execution paths, selected by the segment clause as in the reference:
  * ``naive``   — full score matrix; oracle + tiny shapes.
  * ``chunked`` — q-chunked attention, memory O(block_q x S).
  * ``cuda``    — the hand-written flash-attention / flash-decode kernels
                  (``repro_torch.kernels``).

Decode writes the new token's K/V into the caches in place (the reference
returns updated copies); the caches are returned all the same.  Under a
mesh the caches are DTensors, and the write lands on each rank's local
shard (:func:`_write_slot`); where the rules shard ``kv_seq`` the cache is
gathered, written and resharded, as the reference's pure path does,
unless the clause sets ``decode_shardmap``: then each rank keeps its
block of the sequence, writes the token only where it lands and combines
its partial attention with the others' through their log-sum-exp
(:func:`attn_decode_shardmap`, the reference's), and no cache is
gathered.  Meshless ``decode_shardmap`` changes nothing, as the
reference's needs a sharded ``kv_seq``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.context import ModelContext
from repro_torch.models.layers import apply_rope, dense
from repro_torch.models.params import ParamSpec, TensorSpec, DTYPES

NEG_INF = -1e30


def attn_specs(cfg: ArchConfig, dtype: Optional[str] = None):
    dt = dtype or cfg.dtype
    d, H, KV, D = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    s = d ** -0.5
    return {
        "wq": ParamSpec((d, H, D), ("embed", "heads", "head_dim"), "normal", s, dt),
        "wk": ParamSpec((d, KV, D), ("embed", "kv_heads", "head_dim"), "normal", s, dt),
        "wv": ParamSpec((d, KV, D), ("embed", "kv_heads", "head_dim"), "normal", s, dt),
        "wo": ParamSpec((H, D, d), ("heads", "head_dim", "embed"), "normal",
                        (H * D) ** -0.5, dt),
    }


# --- core math ---------------------------------------------------------------

def _mask(pos_q, pos_k, window: int):
    m = pos_q[:, None] >= pos_k[None, :]
    if window:
        m &= pos_q[:, None] - pos_k[None, :] < window
    return m


def _heads_first(t):
    """(B,S,KV,D) -> f32 (B,KV,S,D), contiguous: the layout the score and
    output products read without a copy of their own."""
    return t.float().transpose(1, 2).contiguous()


def _attend(q, kh, vh, *, pos_q, pos_k, window: int):
    """q: (B,Sq,H,D), kh/vh: f32 (B,KV,Sk,D) -> (B,Sq,H,D)."""
    B, Sq, H, D = q.shape
    KV = kh.shape[1]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, D).float()
    s = torch.einsum("bqkgd,bksd->bkgqs", qg, kh) * (D ** -0.5)
    m = _mask(pos_q, pos_k, window)
    s = torch.where(m, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bqkgd", p, vh)
    return o.reshape(B, Sq, H, D).to(q.dtype)


def naive_attention(q, k, v, *, pos_q, pos_k, window: int = 0):
    """q: (B,Sq,H,D), k/v: (B,Sk,KV,D) -> (B,Sq,H,D)."""
    return _attend(q, _heads_first(k), _heads_first(v), pos_q=pos_q,
                   pos_k=pos_k, window=window)


def chunked_attention(q, k, v, *, pos_q, pos_k, window: int = 0,
                      q_chunk: int = 512):
    """Streaming q-chunked attention (same math as naive, bounded memory).

    For sliding-window attention only a (window + q_chunk)-wide K slice is
    read per chunk.
    """
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if Sq % q_chunk or Sq <= q_chunk:
        return naive_attention(q, k, v, pos_q=pos_q, pos_k=pos_k,
                               window=window)
    nq = Sq // q_chunk
    k_span = min(Sk, window + q_chunk) if window else Sk
    k_span = max(k_span, q_chunk)
    # a window covering the whole K range reads K/V directly
    slice_k = bool(window) and k_span < Sk
    # upcast and lay out K/V once: per chunk, each product would copy them
    # and autograd would keep every copy (nq x S memory; the reference's
    # scan keeps its loop-invariant residuals once)
    kh, vh = _heads_first(k), _heads_first(v)
    outs = []
    for i in range(nq):
        lo = i * q_chunk
        qs, pq = q[:, lo:lo + q_chunk], pos_q[lo:lo + q_chunk]
        if slice_k:
            start = min(max(lo + q_chunk - k_span, 0), Sk - k_span)
            ks = kh[:, :, start:start + k_span]
            vs = vh[:, :, start:start + k_span]
            pk = pos_k[start:start + k_span]
        else:
            ks, vs, pk = kh, vh, pos_k
        outs.append(_attend(qs, ks, vs, pos_q=pq, pos_k=pk, window=window))
    return torch.cat(outs, dim=1)


def _is_vector(pos) -> bool:
    return isinstance(pos, torch.Tensor) and pos.ndim > 0


def decode_attention(q1, k_cache, v_cache, pos, *, window: int = 0,
                     upcast: bool = True):
    """One-token attention against a KV cache.

    q1: (B,H,D); caches: (B,Smax,KV,D); pos: a scalar index of the new
    token, or a (B,) tensor of per-row positions (continuous batching).

    ``upcast=False`` rounds q and p to the cache dtype before the two
    contractions, as the reference's bf16-read path does; both paths
    accumulate in f32.
    """
    B, H, D = q1.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qg = q1.reshape(B, KV, G, D)
    if not upcast:
        qg = qg.to(k_cache.dtype)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float())
    s = s * (D ** -0.5)
    ks = torch.arange(Smax, device=q1.device)
    if _is_vector(pos):
        # per-row positions: row b masks against its own pos, so its output
        # depends on row b's inputs alone
        m = ks[None, :] <= pos[:, None]                 # (B,Smax)
        if window:
            m &= ks[None, :] > pos[:, None] - window
        m = m[:, None, None, :]
    else:
        m = ks <= pos
        if window:
            m &= ks > pos - window
    s = torch.where(m, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if not upcast:
        p = p.to(v_cache.dtype)
    o = torch.einsum("bkgs,bskd->bkgd", p.float(), v_cache.float())
    return o.reshape(B, H, D).to(q1.dtype)


# --- module-level apply ------------------------------------------------------

def _project_qkv(p, x, cfg: ArchConfig, ctx: ModelContext, positions):
    q = dense(x, p["wq"])                              # (B,S,H,D)
    k = dense(x, p["wk"])                              # (B,S,KV,D)
    v = dense(x, p["wv"])
    q = apply_rope(q, positions, cfg.rope)
    k = apply_rope(k, positions, cfg.rope)
    q = ctx.constrain(q, ("batch", "seq", "heads", None))
    k = ctx.constrain(k, ("batch", "seq", "kv_heads", None))
    v = ctx.constrain(v, ("batch", "seq", "kv_heads", None))
    return q, k, v


def attn_apply(p, x, cfg: ArchConfig, ctx: ModelContext, positions):
    """Full-sequence attention (train / prefill). x: (B,S,d_model)."""
    q, k, v = _project_qkv(p, x, cfg, ctx, positions)
    cl = ctx.clause
    if cl.kernel == "cuda":
        from repro_torch import kernels as kops
        o = kops.flash_attention(q, k, v, causal=True, window=cfg.window_size,
                                 block_q=cl.block_q, block_k=cl.block_k)
    else:
        o = _local(ctx, lambda q, k, v: chunked_attention(
            q, k, v, pos_q=positions, pos_k=positions,
            window=cfg.window_size, q_chunk=cl.block_q),
            [q, k, v], [(0, 2)] * 3, (0, 2))
    o = ctx.constrain(o, ("batch", "seq", "heads", None))
    y = torch.tensordot(o, p["wo"], dims=([2, 3], [0, 1])).to(x.dtype)
    return ctx.constrain(y, ("batch", "seq", "embed"))


def attn_cache_spec(cfg: ArchConfig, batch: int, smax: int):
    """KV cache shapes for one layer."""
    KV, D = cfg.num_kv_heads, cfg.head_dim_
    cache_len = min(smax, cfg.window_size) if cfg.window_size else smax
    spec = TensorSpec((batch, cache_len, KV, D), DTYPES[cfg.dtype])
    return {"k": spec, "v": spec}


def attn_decode(p, x1, cache, pos, cfg: ArchConfig, ctx: ModelContext):
    """One-token decode. x1: (B,d_model); cache: {"k","v"} (B,Smax,KV,D).

    ``pos`` is a scalar (an ``int``: every row at the same position) or a
    ``(B,)`` tensor of per-row positions (continuous batching).  The vector
    path writes each row's slot and masks per row, so row ``b`` of every
    output is a function of row ``b``'s inputs alone.  The flash-decode
    kernel takes one scalar position, so vector-pos calls take the plain
    path, as in the reference.
    """
    q = dense(x1, p["wq"])                             # (B,H,D)
    k = dense(x1, p["wk"])                             # (B,KV,D)
    v = dense(x1, p["wv"])
    q = apply_rope(q, pos, cfg.rope)
    k = apply_rope(k, pos, cfg.rope)
    vector_pos = _is_vector(pos)
    if (not vector_pos and ctx.clause.decode_shardmap
            and not cfg.window_size and _seq_sharded(ctx, cache)):
        o, new_cache = attn_decode_shardmap(q, k, v, cache, pos, ctx)
        y = torch.tensordot(o, p["wo"], dims=([1, 2], [0, 1])).to(x1.dtype)
        return ctx.constrain(y, ("batch", "embed")), new_cache
    k_cache, v_cache = cache["k"], cache["v"]
    cache_len = k_cache.shape[1]
    slot = pos % cache_len if cfg.window_size else pos  # ring buffer if windowed
    k_cache = _write_slot(ctx, k_cache, k, slot)
    v_cache = _write_slot(ctx, v_cache, v, slot)
    k_cache = ctx.constrain(k_cache, ("batch", "kv_seq", "kv_heads", None))
    v_cache = ctx.constrain(v_cache, ("batch", "kv_seq", "kv_heads", None))
    if cfg.window_size:
        # ring buffer: all valid entries attendable except future ones
        last = (torch.clamp(pos, max=cache_len - 1) if vector_pos
                else min(pos, cache_len - 1))
        o = _decode_attention(ctx, q, k_cache, v_cache, last)
    elif ctx.clause.kernel == "cuda" and not vector_pos:
        from repro_torch import kernels as kops
        o = kops.flash_decode(q, k_cache, v_cache, pos,
                              block_k=ctx.clause.block_k)
    else:
        o = _decode_attention(ctx, q, k_cache, v_cache, pos)
    y = torch.tensordot(o, p["wo"], dims=([1, 2], [0, 1])).to(x1.dtype)
    y = ctx.constrain(y, ("batch", "embed"))
    return y, {"k": k_cache, "v": v_cache}


def _seq_sharded(ctx: ModelContext, cache) -> bool:
    """True when the rules shard the KV cache's sequence dim (on the
    ``model`` axis) under a mesh."""
    if not ctx.meshed:
        return False
    ps = ctx.rules.pspec(("batch", "kv_seq", "kv_heads", None),
                         cache["k"].shape)
    return len(ps) > 1 and ps[1] == "model"


def attn_decode_shardmap(q, k, v, cache, pos, ctx: ModelContext):
    """Sequence-sharded KV decode, the reference's ``attn_decode_shardmap``.

    The caches stay split along their sequence on the ``model`` axis: each
    rank holds its (B_l, S_l, KV, D) block, S_l = Smax / tp, writes the new
    token only when ``pos`` lands in its block (a clipped slot and a
    select: no collective), and attends to its block under the global
    position mask.  The ranks then combine their partial softmaxes by
    their log-sum-exp: ``m = pmax(m_l)``, ``l = psum(exp(m_l - m) l_l)``,
    ``o = psum(o_l exp(m_l - m)) / l`` (flash-decode's LSE combine).  A
    rank whose block lies wholly past ``pos`` has ``m_l = NEG_INF``, a
    finite value, so its share ``exp(m_l - m)`` is 0, not NaN.  q, k, v are
    split on the batch axes where B divides, and whole over ``model``.
    """
    from repro_torch.runtime.sharding import (all_reduce, batch_axes,
                                              has_layout, map_local)
    mesh = ctx.rules.mesh
    sizes = ctx.rules.axis_sizes
    tp = sizes["model"]
    b_axes = batch_axes(mesh)
    B, Smax, KV, D = cache["k"].shape
    H = q.shape[1]
    G = H // KV
    S_l = Smax // tp
    dp = math.prod(sizes[a] for a in b_axes)
    b_ax = (b_axes if len(b_axes) > 1 else b_axes[0]) \
        if b_axes and B % dp == 0 else None
    lo = mesh.get_local_rank("model") * S_l

    def local(q, k, v, ck, cv):
        p = torch.as_tensor(pos, device=ck.device)
        slot = torch.clamp(p - lo, 0, S_l - 1)
        hit = (p >= lo) & (p < lo + S_l)
        for c, new in ((ck, k), (cv, v)):
            c[:, slot] = torch.where(hit, new.to(c.dtype), c[:, slot])
        qg = q.reshape(q.shape[0], KV, G, D)
        s = torch.einsum("bkgd,bskd->bkgs", qg.to(ck.dtype).float(),
                         ck.float()) * (D ** -0.5)
        ks = lo + torch.arange(S_l, device=ck.device)
        s = torch.where(ks <= p, s, NEG_INF)
        m_l = s.amax(dim=-1, keepdim=True)               # (B_l,KV,G,1)
        p_l = torch.exp(s - m_l)
        l_l = p_l.sum(dim=-1, keepdim=True)
        o_l = torch.einsum("bkgs,bskd->bkgd", p_l.to(cv.dtype).float(),
                           cv.float())
        m_g = all_reduce(m_l, "max", mesh, "model")
        share = torch.exp(m_l - m_g)
        l_g = all_reduce(share * l_l, "sum", mesh, "model")
        o = all_reduce(o_l * share, "sum", mesh, "model")
        o = o / torch.clamp(l_g, min=1e-30)
        return (o.reshape(q.shape[0], H, D).to(q.dtype), ck, cv)

    row = (b_ax, None, None)
    cache_spec = (b_ax, "model", None, None)
    o, ck, cv = map_local(local, mesh, (row, row, row, cache_spec,
                                        cache_spec),
                          (row, cache_spec, cache_spec),
                          q, k, v, cache["k"], cache["v"])
    # the writes landed in the caches' own shards where they were laid
    # out so already: hand those back, not copies to write over them
    if has_layout(cache["k"], cache_spec):
        ck, cv = cache["k"], cache["v"]
    return o, {"k": ck, "v": cv}


def _local(ctx: ModelContext, fn, tensors, dims, out_dims):
    """``fn(*tensors)``, on each rank's local shards under a mesh
    (``runtime.sharding.on_shards``: batch and heads stay sharded where
    the kv heads are too, every other dim is gathered), as the kernel ops
    run."""
    if not ctx.meshed:
        return fn(*tensors)
    from repro_torch.runtime.sharding import on_shards
    return on_shards(lambda *t: [fn(*t)], tensors, dims, [out_dims])[0]


def _decode_attention(ctx: ModelContext, q, k_cache, v_cache, pos):
    """``decode_attention`` at the clause's upcast, on local shards under
    a mesh; a vector ``pos`` is split with the batch.  The cache leads
    (``on_shards`` keeps the first tensor's batch and head splits): q is
    small and follows it, where q leading would gather the cache to q's
    layout (a q whole over the batch axes gathers every row)."""
    up = ctx.clause.cache_upcast
    if _is_vector(pos):
        return _local(ctx, lambda k, v, q, p: decode_attention(
            q, k, v, p, upcast=up), [k_cache, v_cache, q, pos],
            [(0, 2), (0, 2), (0, 1), (0,)], (0, 1))
    return _local(ctx, lambda k, v, q: decode_attention(
        q, k, v, pos, upcast=up), [k_cache, v_cache, q],
        [(0, 2), (0, 2), (0, 1)], (0, 1))


def _write_slot(ctx: ModelContext, cache, new, slot):
    """Set row b's ``slot`` (an int or a (B,) tensor) of the (B,Smax,KV,D)
    ``cache`` to ``new[b]``, in place, and return the cache.  Under a mesh
    the write runs on each rank's local shard (batch and kv heads stay
    sharded); a sharded ``kv_seq`` is gathered first, and the caller's
    ``constrain`` reshards it.  With ``decode_shardmap`` a scalar-pos
    decode does not come here: :func:`attn_decode_shardmap` writes each
    rank's own block and gathers nothing."""
    def write(c, n, *rows_slot):
        if rows_slot:                       # a slot per row
            rows = torch.arange(c.shape[0], device=c.device)
            c[rows, rows_slot[0]] = n.to(c.dtype)
        else:
            c[:, slot] = n.to(c.dtype)
        return c
    if _is_vector(slot):
        return _local(ctx, write, [cache, new, slot],
                      [(0, 2), (0, 1), (0,)], (0, 2))
    return _local(ctx, write, [cache, new], [(0, 2), (0, 1)], (0, 2))
