"""Plain PyTorch versions of the hand-written kernels (the allclose oracle).

The CPU tests use them, ``chip_smoke.py`` holds each kernel against them on
the card, and the op wrappers in ``kernels/ops.py`` take them for tensors
that lie on the CPU.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """q: (B,H,Sq,D), k/v: (B,KV,Sk,D) -> (B,H,Sq,D). f32 math."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, KV, G, Sq, D)
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, k.float()) * (D ** -0.5)
    iq = torch.arange(Sq, device=q.device)[:, None]
    ik = torch.arange(Sk, device=q.device)[None, :]
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        m &= iq >= ik
    if window:
        m &= iq - ik < window
    s = torch.where(m, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(B, H, Sq, D).to(q.dtype)


def flash_decode_ref(q, k, v, pos, *, return_lse=False):
    """q: (B,H,D); k/v: (B,Smax,KV,D); pos scalar -> (B,H,D).

    With ``return_lse`` also the per-head log-sum-exp (B,H) f32, as
    ``m + log(max(l, 1e-30))`` of the masked scores.
    """
    B, H, D = q.shape
    Smax, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, KV, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k.float()) * (D ** -0.5)
    m = torch.arange(Smax, device=q.device) <= int(pos)
    s = torch.where(m, s, NEG_INF)
    mx = s.amax(dim=-1, keepdim=True)
    p = torch.where(m, torch.exp(s - mx), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bskd->bkgd", p / l.clamp_min(1e-30), v.float())
    out = o.reshape(B, H, D).to(q.dtype)
    if not return_lse:
        return out
    lse = (mx + torch.log(l.clamp_min(1e-30))).reshape(B, H)
    return out, lse
