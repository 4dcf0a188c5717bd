"""Dense FFN (optionally gated / GLU)."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models.context import ModelContext
from repro_torch.models.layers import act_fn, dense
from repro_torch.models.params import ParamSpec


def mlp_specs(cfg: ArchConfig, d_ff: int = 0, dtype=None):
    dt = dtype or cfg.dtype
    d, f = cfg.d_model, d_ff or cfg.d_ff
    s = {"wi": ParamSpec((d, f), ("embed", "ffn"), "normal", d ** -0.5, dt),
         "wo": ParamSpec((f, d), ("ffn", "embed"), "normal", f ** -0.5, dt)}
    if cfg.glu:
        s["wg"] = ParamSpec((d, f), ("embed", "ffn"), "normal", d ** -0.5, dt)
    return s


def mlp_apply(p, x, cfg: ArchConfig, ctx: ModelContext):
    act = act_fn(cfg.act)
    h = dense(x, p["wi"])
    if cfg.glu:
        h = act(dense(x, p["wg"])) * h
    else:
        h = act(h)
    return dense(h, p["wo"])
