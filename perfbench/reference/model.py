"""Forward and loss of a dense attention stack, in float32 or, as the
control, with every product's operands rounded to float8 (e4m3, one scale
per tensor: the step below the configuration's bfloat16).

Weights are a dict of the harness's layout (path -> tensor; a stacked
leaf as a list of per-layer tensors).  Each layer runs under a
checkpoint and its attention in blocks of ``Q_BLOCK`` queries, so the
reference fits beside nothing else at the timed sizes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Q_BLOCK = 512
NORM_EPS = 1e-6
Z_LOSS = 1e-4
ROPE_BASE = 10000.0
FP8_MAX = 448.0                     # float8_e4m3fn's largest finite value


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale (its max magnitude to
    the format's), as f32; the gradient passes straight through."""
    scale = x.detach().abs().amax().clamp_min(1e-12) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x.detach())


class Precision:
    """``"float32"``: every product in f32 (TF32 off).  ``"fp8"``: the
    control, each product's operands rounded by :func:`fp8` first."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(name)
        self.name = name

    def r(self, x):
        return fp8(x) if self.name == "fp8" else x

    def mm(self, a, b):
        return self.r(a) @ self.r(b)

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.r(a), self.r(b))


def norm(x, scale, bias, kind: str):
    if kind == "layernorm":
        x = x - x.mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + NORM_EPS)
    y = y * scale
    return y + bias if bias is not None else y


def act(x, kind: str):
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def rope(x, positions):
    """Rotary embedding over all of D, pairs interleaved (x[0::2],
    x[1::2]).  x: (B, S, H, D)."""
    D = x.shape[-1]
    inv = 1.0 / ROPE_BASE ** (torch.arange(0, D, 2, dtype=torch.float32,
                                           device=x.device) / D)
    theta = positions.float()[:, None] * inv
    cos, sin = torch.cos(theta)[:, None, :], torch.sin(theta)[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).reshape(x.shape)


def attention(q, k, v, window: int, prec: Precision):
    """Causal (and, with ``window``, sliding-window) GQA attention.
    q: (B,S,H,D); k, v: (B,S,KV,D) -> (B,S,H,D); query head h reads kv
    head h // (H / KV)."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)         # (B,KV,S,D)
    pos = torch.arange(S, device=q.device)
    outs = []
    for lo in range(0, S, Q_BLOCK):
        hi = min(S, lo + Q_BLOCK)
        k0 = max(0, lo - window + 1) if window else 0
        qg = q[:, lo:hi].reshape(B, hi - lo, KV, G, D)
        s = prec.einsum("bqkgd,bksd->bkgqs", qg, kh[:, :, k0:hi]) * D ** -0.5
        pq, pk = pos[lo:hi, None], pos[None, k0:hi]
        keep = pq >= pk
        if window:
            keep &= pq - pk < window
        p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
        o = prec.einsum("bkgqs,bksd->bqkgd", p, vh[:, :, k0:hi])
        outs.append(o.reshape(B, hi - lo, H, D))
    return torch.cat(outs, dim=1)


def _layer(arch: dict, prec: Precision, x, positions, p: dict):
    B, S, d = x.shape
    H, KV = arch["num_heads"], arch["num_kv_heads"]
    D = arch["head_dim"] or d // H
    h = norm(x, p["ln1/scale"], p.get("ln1/bias"), arch["norm"])
    h2 = h.reshape(B * S, d)
    q = prec.mm(h2, p["attn/wq"].reshape(d, H * D)).reshape(B, S, H, D)
    k = prec.mm(h2, p["attn/wk"].reshape(d, KV * D)).reshape(B, S, KV, D)
    v = prec.mm(h2, p["attn/wv"].reshape(d, KV * D)).reshape(B, S, KV, D)
    if arch["rope"] == "full":
        q, k = rope(q, positions), rope(k, positions)
    elif arch["rope"] != "none":
        raise ValueError(f"rope {arch['rope']!r}")
    o = attention(q, k, v, arch["window_size"], prec)
    x = x + prec.mm(o.reshape(B * S, H * D),
                    p["attn/wo"].reshape(H * D, d)).reshape(B, S, d)
    h2 = norm(x, p["ln2/scale"], p.get("ln2/bias"),
              arch["norm"]).reshape(B * S, d)
    u = prec.mm(h2, p["ffn/wi"])
    if arch["glu"]:
        u = act(prec.mm(h2, p["ffn/wg"]), arch["act"]) * u
    else:
        u = act(u, arch["act"])
    return x + prec.mm(u, p["ffn/wo"]).reshape(B, S, d)


def layer_params(weights: dict, layer: int, num_layers: int) -> dict:
    """Layer ``layer``'s leaves, keyed by their path below ``g0/b0/``."""
    out = {}
    for path, t in weights.items():
        if path.startswith("g0/b0/"):
            out[path[len("g0/b0/"):]] = t[layer] if num_layers > 1 else t
    return out


def stack(arch: dict, weights: dict, x, prec: Precision) -> torch.Tensor:
    """The layers over the residual stream ``x`` (B, S, d), each under a
    checkpoint."""
    L = arch["num_layers"]
    positions = torch.arange(x.shape[1], device=x.device)
    for i in range(L):
        p = layer_params(weights, i, L)
        names = sorted(p)

        def run(x, *ts, names=names):
            return _layer(arch, prec, x, positions, dict(zip(names, ts)))
        x = checkpoint(run, x, *[p[n] for n in names], use_reentrant=False)
    return x


def logits_of(arch: dict, weights: dict, x, prec: Precision) -> torch.Tensor:
    """The head: the final norm and the output product, (B * S, V) f32."""
    B, S, d = x.shape
    h = norm(x, weights["head/norm/scale"], weights.get("head/norm/bias"),
             arch["norm"]).reshape(B * S, d)
    w = weights["embed/tok"].t() if arch["tie_embeddings"] \
        else weights["head/out"]
    return prec.mm(h, w)


def xent(logits, targets) -> torch.Tensor:
    """Mean over rows of cross-entropy plus the z-loss (1e-4 lse^2)."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, targets.reshape(-1, 1))[:, 0]
    return (lse - ll + Z_LOSS * lse.square()).mean()


def loss_fn(arch: dict, weights: dict, tokens, targets, prec: Precision,
            logits_at=None):
    """The loss, in f32, from f32 ``weights``; with ``logits_at`` (flat
    indices into the (B, S, V) logits) also those logits, on the CPU."""
    x = F.embedding(tokens, weights["embed/tok"])
    logits = logits_of(arch, weights, stack(arch, weights, x, prec), prec)
    loss = xent(logits, targets)
    if logits_at is None:
        return loss
    return loss, logits.detach().reshape(-1)[
        logits_at.to(logits.device)].cpu()
