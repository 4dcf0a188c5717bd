"""xLSTM blocks: chunkwise-parallel mLSTM and recurrent sLSTM.

The mLSTM is a gated linear-attention cell with matrix state
``C (dk x dv)``; prefill runs its chunkwise-parallel form (intra-chunk
quadratic + inter-chunk recurrent state), under a ``"cuda"`` clause through
the hand-written kernel (``repro_torch.kernels.mlstm``), else as a loop of
``mlstm_chunk`` in PyTorch.  States are kept log-stabilized: the semantic
state is ``(C e^m, n e^m)``.  The sLSTM cell is sequential by nature and
has no kernel in the reference either: prefill loops over the sequence.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ref import mlstm_chunk, mlstm_chunkwise_ref
from repro_torch.models.context import ModelContext
from repro_torch.models.layers import (act_fn, causal_conv1d, dense,
                                       norm_apply, norm_specs)
from repro_torch.models.params import DTYPES, ParamSpec, TensorSpec


# =====================================================================
# mLSTM
# =====================================================================

def mlstm_dims(cfg: ArchConfig):
    di = int(cfg.expand_factor * cfg.d_model)
    H = cfg.num_heads
    if di % H:
        raise ValueError(f"{cfg.name}: inner dim {di} not a multiple of "
                         f"{H} heads")
    return di, H, di // H


def mlstm_specs(cfg: ArchConfig, dtype=None):
    dt = dtype or cfg.dtype
    d = cfg.d_model
    di, H, dh = mlstm_dims(cfg)
    s = d ** -0.5
    si = di ** -0.5
    return {
        "ln": norm_specs(d, cfg.norm, dt),
        "w_up": ParamSpec((d, 2 * di), ("embed", "rnn"), "normal", s, dt),
        "conv": ParamSpec((cfg.conv_width, di), ("conv", "rnn"), "normal",
                          cfg.conv_width ** -0.5, dt),
        "wq": ParamSpec((di, H, dh), ("rnn", "heads", "head_dim"), "normal", si, dt),
        "wk": ParamSpec((di, H, dh), ("rnn", "heads", "head_dim"), "normal", si, dt),
        "wv": ParamSpec((di, H, dh), ("rnn", "heads", "head_dim"), "normal", si, dt),
        "w_if": ParamSpec((d, 2, H), ("embed", None, "heads"), "normal", s, "float32"),
        "b_if": ParamSpec((2, H), (None, "heads"), "zeros", dtype="float32"),
        "gn": {"scale": ParamSpec((di,), ("rnn",), "ones", dtype=dt)},
        "w_down": ParamSpec((di, d), ("rnn", "embed"), "normal", si, dt),
    }


def mlstm_state_spec(cfg: ArchConfig, batch: int):
    di, H, dh = mlstm_dims(cfg)
    f32 = torch.float32
    return {
        "C": TensorSpec((batch, H, dh, dh), f32),
        "n": TensorSpec((batch, H, dh), f32),
        "m": TensorSpec((batch, H), f32),
        "conv": TensorSpec((batch, cfg.conv_width - 1, di),
                           DTYPES[cfg.dtype]),
    }


def _mlstm_qkvif(p, x, cfg: ArchConfig, conv_state=None):
    """Shared projection path. x: (B,S,d) -> q,k,v (B,H,S,dh) f32 (q
    pre-scaled), li/lf (B,H,S) f32, the output gate and the new conv
    history."""
    di, H, dh = mlstm_dims(cfg)
    u = dense(x, p["w_up"])                            # (B,S,2*di)
    z, gate = u.split(di, dim=-1)
    cz, new_conv = causal_conv1d(z, p["conv"], conv_state)
    cz = F.silu(cz)
    q = torch.einsum("bsi,ihd->bhsd", cz, p["wq"].to(cz.dtype)).float()
    k = torch.einsum("bsi,ihd->bhsd", cz, p["wk"].to(cz.dtype)).float()
    v = torch.einsum("bsi,ihd->bhsd", z, p["wv"].to(z.dtype)).float()
    q = q * dh ** -0.5
    gif = torch.einsum("bsd,dgh->bgsh", x.float(), p["w_if"]) \
        + p["b_if"][None, :, None, :]
    li = gif[:, 0].transpose(1, 2)                     # (B,H,S)
    lf = F.logsigmoid(gif[:, 1].transpose(1, 2))
    return q, k, v, li, lf, gate, new_conv


def _mlstm_out(p, h, gate, x):
    """h: (B,H,S,dh) -> residual output (B,S,d) in x's dtype."""
    B, H, S, dh = h.shape
    hb = h.transpose(1, 2).reshape(B, S, H * dh).to(x.dtype)
    hb = norm_apply(p["gn"], hb, "rmsnorm")
    hb = hb * F.silu(gate)
    return dense(hb, p["w_down"])


def mlstm_apply(p, x, cfg: ArchConfig, ctx: ModelContext):
    """Full-sequence mLSTM block (pre-norm residual)."""
    xn = norm_apply(p["ln"], x, cfg.norm)
    q, k, v, li, lf, gate, _ = _mlstm_qkvif(p, xn, cfg)
    c = ctx.clause.mlstm_chunk
    if ctx.clause.kernel == "cuda":
        from repro_torch import kernels as kops
        h = kops.mlstm_chunkwise(q, k, v, li, lf, chunk=c)
    else:
        h = mlstm_chunkwise_ref(q, k, v, li, lf, chunk=c)
    y = ctx.constrain(_mlstm_out(p, h, gate, x), ("batch", "seq", "embed"))
    return x + y


def mlstm_decode(p, x1, state, cfg: ArchConfig, ctx: ModelContext):
    """One-token mLSTM step. x1: (B,d). Returns (x1, new state)."""
    xn = norm_apply(p["ln"], x1[:, None], cfg.norm)
    q, k, v, li, lf, gate, new_conv = _mlstm_qkvif(
        p, xn, cfg, conv_state=state["conv"])
    h, (C, n, m) = mlstm_chunk(q, k, v, li, lf,
                               (state["C"], state["n"], state["m"]))
    y = _mlstm_out(p, h, gate, xn)[:, 0]
    return x1 + y, {"C": C, "n": n, "m": m, "conv": new_conv}


# =====================================================================
# sLSTM
# =====================================================================

def slstm_dims(cfg: ArchConfig):
    H = cfg.num_heads
    if cfg.d_model % H:
        raise ValueError(f"{cfg.name}: d_model {cfg.d_model} not a multiple "
                         f"of {H} heads")
    return H, cfg.d_model // H


def slstm_specs(cfg: ArchConfig, dtype=None):
    dt = dtype or cfg.dtype
    d = cfg.d_model
    H, dh = slstm_dims(cfg)
    ff = max(64, int(round(d * 4 / 3 / 64)) * 64)
    s = d ** -0.5
    return {
        "ln": norm_specs(d, cfg.norm, dt),
        "conv": ParamSpec((cfg.conv_width, d), ("conv", "embed"), "normal",
                          cfg.conv_width ** -0.5, dt),
        "w": ParamSpec((d, 4, H, dh), ("embed", None, "heads", "head_dim"),
                       "normal", s, "float32"),
        "r": ParamSpec((H, 4, dh, dh), ("heads", None, "head_dim", None),
                       "normal", dh ** -0.5, "float32"),
        "b": ParamSpec((4, H, dh), (None, "heads", "head_dim"), "zeros",
                       dtype="float32"),
        "gn": {"scale": ParamSpec((d,), ("embed",), "ones", dtype=dt)},
        "w_up": ParamSpec((d, 2 * ff), ("embed", "ffn"), "normal", s, dt),
        "w_down": ParamSpec((ff, d), ("ffn", "embed"), "normal",
                            ff ** -0.5, dt),
    }


def slstm_state_spec(cfg: ArchConfig, batch: int):
    H, dh = slstm_dims(cfg)
    f32 = TensorSpec((batch, H, dh), torch.float32)
    return {"h": f32, "c": f32, "n": f32, "m": f32,
            "conv": TensorSpec((batch, cfg.conv_width - 1, cfg.d_model),
                               DTYPES[cfg.dtype])}


def _slstm_cell(zx, r, state):
    """zx: (B,4,H,dh) pre-activations from input; recurrent r: (H,4,dh,dh)."""
    h, c, n, m = state
    zr = torch.einsum("bhe,hged->bghd", h, r)          # (B,4,H,dh)
    zi, zf, zz, zo = (zx[:, g] + zr[:, g] for g in range(4))
    m_new = torch.maximum(zf + m, zi)
    i = torch.exp(zi - m_new)
    f = torch.exp(zf + m - m_new)
    c_new = f * c + i * torch.tanh(zz)
    n_new = torch.clamp_min(f * n + i, 1e-6)
    h_new = torch.sigmoid(zo) * c_new / n_new
    return h_new, (h_new, c_new, n_new, m_new)


def _slstm_gates(p, xn, conv_state=None):
    cz, new_conv = causal_conv1d(xn, p["conv"], conv_state)
    cz = F.silu(cz).float()
    zx = torch.einsum("bsd,dghe->bsghe", cz, p["w"]) + p["b"]
    return zx, new_conv                                 # (B,S,4,H,dh)


def _slstm_out(p, h_seq, x):
    """h_seq: (B,S,H,dh) -> residual (B,S,d) in x's dtype."""
    B, S = h_seq.shape[:2]
    hb = h_seq.reshape(B, S, -1).to(x.dtype)
    hb = norm_apply(p["gn"], hb, "rmsnorm")
    u, g = dense(hb, p["w_up"]).chunk(2, dim=-1)
    return dense(act_fn("gelu")(g) * u, p["w_down"])


def slstm_apply(p, x, cfg: ArchConfig, ctx: ModelContext):
    """Full-sequence sLSTM block: the cell is sequential, so a loop."""
    xn = norm_apply(p["ln"], x, cfg.norm)
    zx, _ = _slstm_gates(p, xn)
    B, S = x.shape[:2]
    H, dh = slstm_dims(cfg)
    z0 = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
    state = (z0, z0, torch.full_like(z0, 1e-6), z0)
    hs = []
    for t in range(S):
        h, state = _slstm_cell(zx[:, t], p["r"], state)
        hs.append(h)
    y = ctx.constrain(_slstm_out(p, torch.stack(hs, dim=1), x),
                      ("batch", "seq", "embed"))
    return x + y


def slstm_decode(p, x1, state, cfg: ArchConfig, ctx: ModelContext):
    """One-token sLSTM step. x1: (B,d). Returns (x1, new state)."""
    xn = norm_apply(p["ln"], x1[:, None], cfg.norm)
    zx, new_conv = _slstm_gates(p, xn, conv_state=state["conv"])
    h_new, (h, c, n, m) = _slstm_cell(
        zx[:, 0], p["r"], (state["h"], state["c"], state["n"], state["m"]))
    y = _slstm_out(p, h_new[:, None], xn)[:, 0]
    return x1 + y, {"h": h, "c": c, "n": n, "m": m, "conv": new_conv}
