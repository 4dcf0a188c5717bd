"""Shared layer primitives: norms, activations, RoPE, dense application,
the causal temporal conv."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamSpec


# --- activations -----------------------------------------------------------

def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu,
            "relu": F.relu, "tanh": torch.tanh}[name]


# --- norms ------------------------------------------------------------------

def norm_specs(d: int, kind: str, dtype: str):
    s = {"scale": ParamSpec((d,), ("embed",), "ones", dtype=dtype)}
    if kind == "layernorm":
        s["bias"] = ParamSpec((d,), ("embed",), "zeros", dtype=dtype)
    return s


def norm_apply(p, x, kind: str, eps: float = 1e-6):
    xf = x.float()
    if kind == "layernorm":
        xf = xf - xf.mean(dim=-1, keepdim=True)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    y = y * p["scale"].float()
    if kind == "layernorm":
        y = y + p["bias"].float()
    return y.to(x.dtype)


# --- dense -----------------------------------------------------------------

def dense(x, w):
    """Contract the last dim of x with the first dim of w.

    The output stays in the activation dtype, as in the reference.
    """
    return torch.tensordot(x, w.to(x.dtype), dims=([x.ndim - 1], [0]))


# --- RoPE -------------------------------------------------------------------

def rope_freqs(head_dim: int, rotary_dim: Optional[int] = None,
               base: float = 10000.0, device=None):
    rd = rotary_dim or head_dim
    exps = torch.arange(0, rd, 2, dtype=torch.float32, device=device) / rd
    return 1.0 / (base ** exps)                       # (rd//2,)


def apply_rope(x, positions, style: str = "full", base: float = 10000.0):
    """x: (..., S, H, D) with positions (S,), or (B, H, D) with a scalar
    position or a (B,) vector of per-row positions.

    ``full`` rotates all of D; ``2d`` rotates only the first half; ``none``
    is identity.  Pairs are interleaved, ``(x[..., 0::2], x[..., 1::2])``,
    as in the reference (not the half-split layout).
    """
    if style == "none":
        return x
    D = x.shape[-1]
    rd = D // 2 if style == "2d" else D
    rd -= rd % 2
    inv = rope_freqs(D, rd, base, device=x.device)    # (rd//2,)
    positions = torch.as_tensor(positions, device=x.device)
    theta = positions[..., None].float() * inv        # (..., rd//2)
    # broadcast over the head axis, which sits between seq and head_dim
    cos = torch.cos(theta)[..., None, :]
    sin = torch.sin(theta)[..., None, :]
    xr = x[..., :rd].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rot = torch.stack([r1, r2], dim=-1).reshape(xr.shape)
    return torch.cat([rot.to(x.dtype), x[..., rd:]], dim=-1)


# --- temporal conv (decode-friendly) ----------------------------------------

def causal_conv1d(x, w, state=None):
    """Depthwise causal conv along the seq axis, accumulated in f32 over the
    W taps.

    x: (B, S, D); w: (W, D).  ``state`` (B, W-1, D) is the decode-time
    history (zeros when None).  Returns (y in x's dtype, the new history
    (B, W-1, D): the last W-1 inputs).
    """
    W = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], W - 1) + tuple(x.shape[2:]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                   # (B, S+W-1, D)
    S = x.shape[1]
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(W):
        y = y + xp[:, i:i + S].float() * w[i].float()
    new_state = xp[:, xp.shape[1] - (W - 1):] if W > 1 else pad
    return y.to(x.dtype), new_state
