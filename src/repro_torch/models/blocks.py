"""Block-kind dispatcher: specs / apply / decode / cache-spec per kind.

The port runs the ``attn`` kind (attention + dense FFN).  The other kinds
of the reference raise ``NotImplementedError`` naming the ROADMAP item
that brings them.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import mlp as M
from repro_torch.models.context import ModelContext
from repro_torch.models.layers import norm_apply, norm_specs

BLOCK_KINDS = ("attn",)

#: reference block kinds the port does not run yet -> ROADMAP item
PENDING_KINDS = {
    "attn_moe": "ROADMAP Queue 1 item 9 (MoE FFN, models/moe.py)",
    "rec": "ROADMAP Queue 1 item 9 (RG-LRU, models/rglru.py)",
    "mlstm": "ROADMAP Queue 1 item 9 (xLSTM, models/xlstm.py)",
    "slstm": "ROADMAP Queue 1 item 9 (xLSTM, models/xlstm.py)",
}


def _check(kind: str):
    if kind in PENDING_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet: {PENDING_KINDS[kind]}")
    if kind not in BLOCK_KINDS:
        raise ValueError(kind)


def block_specs(kind: str, cfg: ArchConfig):
    _check(kind)
    dt, d = cfg.dtype, cfg.d_model
    return {"ln1": norm_specs(d, cfg.norm, dt),
            "attn": A.attn_specs(cfg),
            "ln2": norm_specs(d, cfg.norm, dt),
            "ffn": M.mlp_specs(cfg)}


def block_apply(kind: str, p, x, cfg: ArchConfig, ctx: ModelContext,
                positions):
    """Full-sequence forward. Returns (x, aux_loss); a dense FFN has no
    auxiliary loss, so it is 0.0."""
    _check(kind)
    h = norm_apply(p["ln1"], x, cfg.norm)
    x = x + A.attn_apply(p["attn"], h, cfg, ctx, positions)
    h = norm_apply(p["ln2"], x, cfg.norm)
    x = x + M.mlp_apply(p["ffn"], h, cfg, ctx)
    return x, 0.0


def block_cache_spec(kind: str, cfg: ArchConfig, batch: int, smax: int):
    """Per-layer decode cache shapes."""
    _check(kind)
    return A.attn_cache_spec(cfg, batch, smax)


def block_decode(kind: str, p, x1, cache, pos, cfg: ArchConfig,
                 ctx: ModelContext):
    """One-token decode. x1: (B,d). Returns (x1, new_cache)."""
    _check(kind)
    h = norm_apply(p["ln1"], x1[:, None], cfg.norm)[:, 0]
    y, new_cache = A.attn_decode(p["attn"], h, cache, pos, cfg, ctx)
    x1 = x1 + y
    h = norm_apply(p["ln2"], x1[:, None], cfg.norm)
    y = M.mlp_apply(p["ffn"], h, cfg, ctx)
    return x1 + y[:, 0], new_cache
