"""Block-kind dispatcher: specs / apply / decode / cache-spec per kind.

Kinds: ``attn`` (attention + dense FFN), ``attn_moe`` (attention + MoE
FFN), ``rec`` (RG-LRU + FFN), ``mlstm``, ``slstm``.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import mlp as M
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import xlstm as X
from repro_torch.models.context import ModelContext
from repro_torch.models.layers import norm_apply, norm_specs

BLOCK_KINDS = ("attn", "attn_moe", "rec", "mlstm", "slstm")
ATTN_KINDS = ("attn", "attn_moe")


def _check(kind: str):
    if kind not in BLOCK_KINDS:
        raise ValueError(kind)


def block_specs(kind: str, cfg: ArchConfig):
    _check(kind)
    dt, d = cfg.dtype, cfg.d_model
    if kind in ATTN_KINDS:
        return {"ln1": norm_specs(d, cfg.norm, dt),
                "attn": A.attn_specs(cfg),
                "ln2": norm_specs(d, cfg.norm, dt),
                "ffn": MOE.moe_specs(cfg) if kind == "attn_moe"
                else M.mlp_specs(cfg)}
    if kind == "rec":
        return {"rec": RG.rec_specs(cfg),
                "ln2": norm_specs(d, cfg.norm, dt),
                "ffn": M.mlp_specs(cfg)}
    if kind == "mlstm":
        return X.mlstm_specs(cfg)
    return X.slstm_specs(cfg)


def block_apply(kind: str, p, x, cfg: ArchConfig, ctx: ModelContext,
                positions):
    """Full-sequence forward. Returns (x, aux_loss): the MoE FFN's
    load-balancing loss (an f32 tensor) for ``attn_moe``, 0.0 for every
    other kind."""
    _check(kind)
    if kind in ATTN_KINDS:
        h = norm_apply(p["ln1"], x, cfg.norm)
        x = x + A.attn_apply(p["attn"], h, cfg, ctx, positions)
        h = norm_apply(p["ln2"], x, cfg.norm)
        if kind == "attn_moe":
            y, aux = MOE.moe_apply(p["ffn"], h, cfg, ctx)
            return x + y, aux
        return x + M.mlp_apply(p["ffn"], h, cfg, ctx), 0.0
    if kind == "rec":
        x = RG.rec_apply(p["rec"], x, cfg, ctx)
        h = norm_apply(p["ln2"], x, cfg.norm)
        return x + M.mlp_apply(p["ffn"], h, cfg, ctx), 0.0
    if kind == "mlstm":
        return X.mlstm_apply(p, x, cfg, ctx), 0.0
    return X.slstm_apply(p, x, cfg, ctx), 0.0


def block_cache_spec(kind: str, cfg: ArchConfig, batch: int, smax: int):
    """Per-layer decode cache (attention kinds) or recurrent state
    shapes."""
    _check(kind)
    if kind in ATTN_KINDS:
        return A.attn_cache_spec(cfg, batch, smax)
    if kind == "rec":
        return RG.rec_state_spec(cfg, batch)
    if kind == "mlstm":
        return X.mlstm_state_spec(cfg, batch)
    return X.slstm_state_spec(cfg, batch)


def block_decode(kind: str, p, x1, cache, pos, cfg: ArchConfig,
                 ctx: ModelContext):
    """One-token decode. x1: (B,d). Returns (x1, new_cache); the attention
    kinds update their caches in place, the recurrent kinds return new state
    tensors (``model.decode_step`` copies them into the cache).  The MoE
    FFN's aux loss is discarded."""
    _check(kind)
    if kind in ATTN_KINDS:
        h = norm_apply(p["ln1"], x1[:, None], cfg.norm)[:, 0]
        y, new_cache = A.attn_decode(p["attn"], h, cache, pos, cfg, ctx)
        x1 = x1 + y
        h = norm_apply(p["ln2"], x1[:, None], cfg.norm)
        if kind == "attn_moe":
            y, _ = MOE.moe_apply(p["ffn"], h, cfg, ctx)
        else:
            y = M.mlp_apply(p["ffn"], h, cfg, ctx)
        return x1 + y[:, 0], new_cache
    if kind == "rec":
        x1, new_cache = RG.rec_decode(p["rec"], x1, cache, cfg, ctx)
        h = norm_apply(p["ln2"], x1[:, None], cfg.norm)
        y = M.mlp_apply(p["ffn"], h, cfg, ctx)
        return x1 + y[:, 0], new_cache
    if kind == "mlstm":
        return X.mlstm_decode(p, x1, cache, cfg, ctx)
    return X.slstm_decode(p, x1, cache, cfg, ctx)
