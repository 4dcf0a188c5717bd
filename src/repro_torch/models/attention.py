"""Attention: GQA/MHA with RoPE, causal + sliding-window masks.

Execution paths, selected by the segment clause as in the reference:
  * ``naive``   — full score matrix; oracle + tiny shapes.
  * ``chunked`` — q-chunked attention, memory O(block_q x S).
  * ``cuda``    — the hand-written flash-attention / flash-decode kernels
                  (``repro_torch.kernels``).

Decode writes the new token's K/V into the caches in place (the reference
returns updated copies); the caches are returned all the same.
"""
from __future__ import annotations

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


def naive_attention(q, k, v, *, pos_q, pos_k, window: int = 0):
    """q: (B,Sq,H,D), k/v: (B,Sk,KV,D) -> (B,Sq,H,D)."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, D).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * (D ** -0.5)
    m = _mask(pos_q, pos_k, window)
    s = torch.where(m, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


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
    outs = []
    for i in range(nq):
        lo = i * q_chunk
        qs, pq = q[:, lo:lo + q_chunk], pos_q[lo:lo + q_chunk]
        if slice_k:
            start = min(max(lo + q_chunk - k_span, 0), Sk - k_span)
            ks, vs = k[:, start:start + k_span], v[:, start:start + k_span]
            pk = pos_k[start:start + k_span]
        else:
            ks, vs, pk = k, v, pos_k
        outs.append(naive_attention(qs, ks, vs, pos_q=pq, pos_k=pk,
                                    window=window))
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

def _project_qkv(p, x, cfg: ArchConfig, positions):
    q = dense(x, p["wq"])                              # (B,S,H,D)
    k = dense(x, p["wk"])                              # (B,S,KV,D)
    v = dense(x, p["wv"])
    q = apply_rope(q, positions, cfg.rope)
    k = apply_rope(k, positions, cfg.rope)
    return q, k, v


def attn_apply(p, x, cfg: ArchConfig, ctx: ModelContext, positions):
    """Full-sequence attention (train / prefill). x: (B,S,d_model)."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    cl = ctx.clause
    if cl.kernel == "cuda":
        from repro_torch import kernels as kops
        o = kops.flash_attention(q, k, v, causal=True, window=cfg.window_size,
                                 block_q=cl.block_q, block_k=cl.block_k)
    else:
        o = chunked_attention(q, k, v, pos_q=positions, pos_k=positions,
                              window=cfg.window_size, q_chunk=cl.block_q)
    return torch.tensordot(o, p["wo"], dims=([2, 3], [0, 1])).to(x.dtype)


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
    k_cache, v_cache = cache["k"], cache["v"]
    cache_len = k_cache.shape[1]
    slot = pos % cache_len if cfg.window_size else pos  # ring buffer if windowed
    if vector_pos:
        rows = torch.arange(x1.shape[0], device=x1.device)
        k_cache[rows, slot] = k
        v_cache[rows, slot] = v
    else:
        k_cache[:, slot] = k
        v_cache[:, slot] = v
    if cfg.window_size:
        # ring buffer: all valid entries attendable except future ones
        last = (torch.clamp(pos, max=cache_len - 1) if vector_pos
                else min(pos, cache_len - 1))
        o = decode_attention(q, k_cache, v_cache, last, window=0,
                             upcast=ctx.clause.cache_upcast)
    elif ctx.clause.kernel == "cuda" and not vector_pos:
        from repro_torch import kernels as kops
        o = kops.flash_decode(q, k_cache, v_cache, pos,
                              block_k=ctx.clause.block_k)
    else:
        o = decode_attention(q, k_cache, v_cache, pos,
                             upcast=ctx.clause.cache_upcast)
    y = torch.tensordot(o, p["wo"], dims=([1, 2], [0, 1])).to(x1.dtype)
    return y, {"k": k_cache, "v": v_cache}
