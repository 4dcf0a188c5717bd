"""Plain PyTorch versions of the hand-written kernels (the allclose oracle).

The CPU tests use them, ``chip_smoke.py`` holds each kernel against them on
the card, and the op wrappers in ``kernels/ops.py`` take them for tensors
that lie on the CPU.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _attention_mask(Sq, Sk, causal, window, device):
    """(Sq, Sk) bool: which keys each query keeps, both at positions 0,
    1, ... (causal: k <= q; window: q - k < window)."""
    iq = torch.arange(Sq, device=device)[:, None]
    ik = torch.arange(Sk, device=device)[None, :]
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        m &= iq >= ik
    if window:
        m &= iq - ik < window
    return m


def flash_attention_ref(q, k, v, *, causal=True, window=0,
                        return_lse=False):
    """q: (B,H,Sq,D), k/v: (B,KV,Sk,D) -> (B,H,Sq,D). f32 math.

    With ``return_lse`` also each row's log-sum-exp (B,H,Sq) f32, as
    ``m + log(max(l, 1e-30))`` of the scaled, masked scores (the kernels'
    and :func:`flash_decode_ref`'s)."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, KV, G, Sq, D)
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, k.float()) * (D ** -0.5)
    m = _attention_mask(Sq, Sk, causal, window, q.device)
    s = torch.where(m, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    out = o.reshape(B, H, Sq, D).to(q.dtype)
    if not return_lse:
        return out
    mx = s.amax(dim=-1)
    l = torch.where(m, torch.exp(s - mx[..., None]), 0.0).sum(dim=-1)
    return out, (mx + torch.log(l.clamp_min(1e-30))).reshape(B, H, Sq)


def flash_attention_bwd_ref(dout, q, k, v, out, lse, *, causal=True,
                            window=0, bf16_products=False):
    """Gradients (dq, dk, dv) of :func:`flash_attention_ref` at cotangent
    ``dout`` (like q), from its ``out`` and ``lse``, in the backward
    kernel's arithmetic: f32 P = exp(S - lse), Delta = rowsum(dO * O),
    dS = P (dP - Delta), dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K.
    With ``bf16_products`` P and dS are rounded to bf16 before their
    products, as the kernel does.  Head-major layouts as the forward's;
    results in the inputs' dtypes."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    scale = D ** -0.5
    qf = q.float().reshape(B, KV, G, Sq, D)
    do = dout.float().reshape(B, KV, G, Sq, D)
    kf, vf = k.float(), v.float()
    m = _attention_mask(Sq, Sk, causal, window, q.device)
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, kf) * scale
    p = torch.where(m, torch.exp(s - lse.float().reshape(B, KV, G, Sq, 1)),
                    0.0)
    delta = (do * out.float().reshape(B, KV, G, Sq, D)).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bkgqd,bksd->bkgqs", do, vf) - delta)
    if bf16_products:
        p, ds = (t.to(torch.bfloat16).float() for t in (p, ds))
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, do)
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qf) * scale
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * scale
    return (dq.reshape(B, H, Sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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


def rglru_ref(log_a, b):
    """h_t = exp(log_a_t) * h_{t-1} + b_t over axis 1. (B,S,dr) f32.

    The reference's associative scan in log space, as a log-depth
    (Hillis-Steele) scan: step ``off`` combines each element with the one
    ``off`` before it.
    """
    la, h = log_a.float(), b.float()
    off = 1
    while off < la.shape[1]:
        h = torch.cat([h[:, :off],
                       torch.exp(la[:, off:]) * h[:, :-off] + h[:, off:]], 1)
        la = torch.cat([la[:, :off], la[:, off:] + la[:, :-off]], 1)
        off *= 2
    return h


LOG_EPS = -30.0


def mlstm_chunk(q, k, v, li, lf, state):
    """One chunk of the stabilized chunkwise mLSTM (the reference's
    ``repro.models.xlstm.mlstm_chunk``).

    q,k,v: (B,H,c,dh) f32 (q pre-scaled by dh**-0.5); li,lf: (B,H,c) f32;
    state: (C (B,H,dk,dv), n (B,H,dk), m (B,H)).
    Returns h (B,H,c,dh) and the new state.
    """
    C, n, m = state
    c = q.shape[2]
    b = torch.cumsum(lf, dim=-1)                       # (B,H,c) inclusive
    total = b[..., -1:]
    # intra-chunk log decay D[j,l] = li_l + b_j - b_l (l <= j)
    D = li[..., None, :] + b[..., :, None] - b[..., None, :]
    mask = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    D = torch.where(mask, D, LOG_EPS)
    m_state = m[..., None] + b
    m_j = torch.maximum(D.amax(dim=-1), m_state)
    S = torch.exp(D - m_j[..., None]) * (q @ k.transpose(-1, -2))
    state_w = torch.exp(m_state - m_j)
    num = S @ v + state_w[..., None] * (q @ C)
    den_dot = (q @ n[..., None])[..., 0] * state_w + S.sum(dim=-1)
    den = torch.maximum(den_dot.abs(), torch.exp(-m_j))
    h = num / den[..., None]
    # ---- state update ----
    k_w_log = li + (total - b)                         # decay k_l to chunk end
    m_new = torch.maximum(m + total[..., 0], k_w_log.amax(dim=-1))
    carry_w = torch.exp(m + total[..., 0] - m_new)
    kw = k * torch.exp(k_w_log - m_new[..., None])[..., None]
    C_new = carry_w[..., None, None] * C + kw.transpose(-1, -2) @ v
    n_new = carry_w[..., None] * n + kw.sum(dim=-2)
    return h, (C_new, n_new, m_new)


def mlstm_state0(q):
    """Zero (C, n, m) for q (B,H,S,dh), in q's dtype and device."""
    B, H, _, dh = q.shape
    z = dict(dtype=q.dtype, device=q.device)
    return (torch.zeros((B, H, dh, dh), **z), torch.zeros((B, H, dh), **z),
            torch.zeros((B, H), **z))


def mlstm_chunkwise_ref(q, k, v, li, lf, *, chunk=256):
    """The chunkwise mLSTM over a whole sequence: ``mlstm_chunk`` looped
    over chunks of ``chunk`` rows (clamped to a divisor of S, as the
    reference does).  q,k,v: (B,H,S,dh) f32; li,lf: (B,H,S) -> (B,H,S,dh).
    """
    B, H, S, dh = q.shape
    c = min(chunk, S)
    while S % c:
        c -= 1
    state = mlstm_state0(q)
    hs = []
    for t in range(0, S, c):
        h, state = mlstm_chunk(q[:, :, t:t + c], k[:, :, t:t + c],
                               v[:, :, t:t + c], li[:, :, t:t + c],
                               lf[:, :, t:t + c], state)
        hs.append(h)
    return torch.cat(hs, dim=2)


def mlstm_ref(q, k, v, li, lf):
    """Fully recurrent stabilized mLSTM oracle (step by step).

    q,k,v: (B,H,S,dh) f32 (q pre-scaled); li,lf: (B,H,S) f32.
    Returns h: (B,H,S,dh).
    """
    B, H, S, dh = q.shape
    C, n, m = mlstm_state0(q)
    hs = []
    for t in range(S):
        lf_t, li_t = lf[:, :, t], li[:, :, t]
        m_new = torch.maximum(lf_t + m, li_t)
        f = torch.exp(lf_t + m - m_new)
        i = torch.exp(li_t - m_new)
        kt, vt, qt = k[:, :, t], v[:, :, t], q[:, :, t]
        C = f[..., None, None] * C \
            + i[..., None, None] * (kt[..., :, None] * vt[..., None, :])
        n = f[..., None] * n + i[..., None] * kt
        num = (qt[..., None, :] @ C)[..., 0, :]
        den = torch.maximum((qt * n).sum(dim=-1).abs(), torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=2)


def rmsnorm_ref(x, scale, eps=1e-6):
    """x: (..., d) -> x * rsqrt(mean(x^2) + eps) * scale, f32 math, in
    x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
