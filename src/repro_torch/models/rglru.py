"""Griffin/RecurrentGemma recurrent block: gated branch x (conv + RG-LRU).

RG-LRU: ``h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)`` with
``a_t = exp(-c * softplus(L) * r_t)``, ``r_t/i_t`` input-dependent sigmoid
gates.  Prefill runs the recurrence over the whole sequence: under a
``"cuda"`` clause through the hand-written scan kernel
(``repro_torch.kernels.rglru``), else through its plain version
``kernels.ref.rglru_ref``, a log-depth scan in PyTorch.
Decode is a single-step update.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ref import rglru_ref
from repro_torch.models.context import ModelContext
from repro_torch.models.layers import (act_fn, causal_conv1d, dense,
                                       norm_apply, norm_specs)
from repro_torch.models.params import DTYPES, ParamSpec, TensorSpec

RGLRU_C = 8.0


def rglru_dims(cfg: ArchConfig) -> int:
    return int(cfg.expand_factor * cfg.d_model)


def rec_specs(cfg: ArchConfig, dtype=None):
    dt = dtype or cfg.dtype
    d = cfg.d_model
    dr = rglru_dims(cfg)
    s = d ** -0.5
    sr = dr ** -0.5
    return {
        "ln": norm_specs(d, cfg.norm, dt),
        "w_gate": ParamSpec((d, dr), ("embed", "rnn"), "normal", s, dt),
        "w_x": ParamSpec((d, dr), ("embed", "rnn"), "normal", s, dt),
        "conv": ParamSpec((cfg.conv_width, dr), ("conv", "rnn"), "normal",
                          cfg.conv_width ** -0.5, dt),
        "w_a": ParamSpec((dr, dr), ("rnn", None), "normal", sr, "float32"),
        "w_i": ParamSpec((dr, dr), ("rnn", None), "normal", sr, "float32"),
        "lam": ParamSpec((dr,), ("rnn",), "ones", dtype="float32"),
        "w_out": ParamSpec((dr, d), ("rnn", "embed"), "normal", sr, dt),
    }


def rec_state_spec(cfg: ArchConfig, batch: int):
    dr = rglru_dims(cfg)
    return {
        "h": TensorSpec((batch, dr), torch.float32),
        "conv": TensorSpec((batch, cfg.conv_width - 1, dr),
                           DTYPES[cfg.dtype]),
    }


def _rglru_coeffs(p, u):
    """u: (..., dr) post-conv input -> (log_a, b) recurrence coefficients,
    f32."""
    uf = u.float()
    r = torch.sigmoid(uf @ p["w_a"])
    i = torch.sigmoid(uf @ p["w_i"])
    log_a = -RGLRU_C * F.softplus(p["lam"]) * r
    # sqrt(1 - a^2) computed stably via expm1
    scale = torch.sqrt(-torch.expm1(2.0 * log_a))
    b = scale * (i * uf)
    return log_a, b


def rec_apply(p, x, cfg: ArchConfig, ctx: ModelContext):
    """Full-sequence recurrent block (pre-norm residual). x: (B,S,d)."""
    xn = norm_apply(p["ln"], x, cfg.norm)
    gate = act_fn("gelu")(dense(xn, p["w_gate"]))
    u = dense(xn, p["w_x"])
    u, _ = causal_conv1d(u, p["conv"])
    log_a, b = _rglru_coeffs(p, u)
    if ctx.clause.kernel == "cuda":
        from repro_torch import kernels as kops
        h = kops.rglru(log_a, b)
    else:
        h = rglru_ref(log_a, b)
    y = dense(h.to(x.dtype) * gate, p["w_out"])
    return x + y


def rec_decode(p, x1, state, cfg: ArchConfig, ctx: ModelContext):
    """One-token recurrent step. x1: (B,d). Returns (x1, new state)."""
    xn = norm_apply(p["ln"], x1[:, None], cfg.norm)
    gate = act_fn("gelu")(dense(xn, p["w_gate"]))
    u = dense(xn, p["w_x"])
    u, new_conv = causal_conv1d(u, p["conv"], state["conv"])
    log_a, b = _rglru_coeffs(p, u)
    h = torch.exp(log_a[:, 0]) * state["h"] + b[:, 0]
    y = dense(h[:, None].to(x1.dtype) * gate, p["w_out"])[:, 0]
    return x1 + y, {"h": h, "conv": new_conv}
