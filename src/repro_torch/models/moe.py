"""Mixture-of-Experts FFN: top-k router + grouped, sort-based dispatch.

The port of ``src/repro/models/moe.py`` (``moe_specs``, ``capacity``,
``_dispatch_group``, ``_combine_group``, ``moe_apply``,
``moe_apply_sorted``), with the same function:

1. tokens are split into ``G = ctx.moe_groups`` groups (1 without a mesh);
2. within a group, the (token, expert) assignments are sorted by expert
   id (a stable sort) and the first ``C = cf * S_group * k / E`` of each
   expert fill its capacity buffer ``(E, C, d)``; the rest are dropped
   (the residual keeps those tokens intact);
3. the expert FFNs run as batched products over the buffer;
4. each token sums its kept experts' outputs, weighted by its gates, in
   f32, and the result is cast to the activation dtype.

How the port computes it differs in four places, none of which changes
a value the reference computes:

- top-k is a stable descending sort of the probabilities, so a tie puts
  the lower expert index first, as ``jax.lax.top_k`` does (``torch.topk``
  promises no order among equal values);
- per-expert counts and offsets are ``searchsorted`` over the sorted
  expert ids: exact integers, no atomics, and no shape that depends on
  the data, so the dry run's fake tensors run it too;
- the buffer is filled by one gather (slot ``c`` of expert ``e`` takes
  the ``offsets[e] + c``-th sorted assignment's token if
  ``c < counts[e]``, else a zero row appended to the tokens).  The
  reference scatters into ``(E, C+1, d)`` and lets dropped rows land in
  the overflow slot ``C``, whose output its combine zeroes: the port
  keeps ``slot == C`` as the drop mark but never builds that row, so the
  expert products run over the ``C`` kept slots only;
- the combine inverts the sort and sums each token's ``k`` terms in a
  fixed order, where the reference scatter-adds them: an atomic add on
  the card would sum in a different order from run to run, and the
  serving engine's batched == sequential contract needs every row to be
  a deterministic function of its own inputs.

The all-to-all dispatch (``moe_apply_a2a``) needs a mesh: it comes with
multi-device (ROADMAP Queue 1 item 4).  Without a mesh the reference takes
the sorted path for ``moe_dispatch="a2a"`` too, and so does the port.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.context import ModelContext
from repro_torch.models.layers import act_fn, dense
from repro_torch.models.params import ParamSpec


def moe_specs(cfg: ArchConfig, dtype=None):
    dt = dtype or cfg.dtype
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    s = {
        "router": ParamSpec((d, E), ("embed", "experts"), "normal",
                            d ** -0.5, "float32"),
        "wi": ParamSpec((E, d, f), ("experts", "embed", "expert_ffn"),
                        "normal", d ** -0.5, dt),
        "wo": ParamSpec((E, f, d), ("experts", "expert_ffn", "embed"),
                        "normal", f ** -0.5, dt),
    }
    if cfg.glu:
        s["wg"] = ParamSpec((E, d, f), ("experts", "embed", "expert_ffn"),
                            "normal", d ** -0.5, dt)
    return s


def capacity(cfg: ArchConfig, tokens_per_group: int) -> int:
    c = int(cfg.moe_capacity_factor * tokens_per_group
            * cfg.experts_per_token / cfg.num_experts)
    return max(8, min(c, tokens_per_group))


def route(router, xf, k: int):
    """Router of ``xf`` (..., d): (probs (..., E) f32, gates (..., k) f32,
    idx (..., k) int64).

    The product runs in the activation dtype (``dense`` casts the f32
    router to it, as the reference's does) and only then goes to f32: an
    f32 product would pick other experts at bf16.
    """
    logits = dense(xf, router).float()
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top[..., :k], idx[..., :k]
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, idx


def aux_loss(probs, idx, E: int, k: int):
    """Switch load-balancing loss: E * sum(mean probs * mean assignment
    share), f32.  probs: (G, S, E); idx: (G, S, k)."""
    me = probs.mean(dim=(0, 1))
    hot = idx[..., None] == torch.arange(E, device=idx.device)
    ce = hot.float().sum(dim=2).mean(dim=(0, 1)) / k
    return E * (me * ce).sum()


def _dispatch_group(xg, gates, idx, E: int, C: int):
    """One group's dispatch. xg: (S,d), gates/idx: (S,k).

    Returns (buffer (E, C, d), combine info ``(e_sorted, slot, tok_sorted,
    order)``, the reference's; ``slot == C`` marks a dropped assignment).
    """
    S, d = xg.shape
    k = idx.shape[-1]
    dev = xg.device
    flat_e = idx.reshape(-1)                          # (S*k,)
    order = torch.sort(flat_e, stable=True).indices   # sort by expert
    e_sorted = flat_e[order]
    tok_sorted = order // k
    experts = torch.arange(E, device=dev)
    offsets = torch.searchsorted(e_sorted, experts)   # exclusive cumsum
    ends = torch.searchsorted(e_sorted, experts, right=True)
    pos = torch.arange(S * k, device=dev) - offsets[e_sorted]
    slot = torch.where(pos < C, pos, C)               # overflow -> C
    src = offsets[:, None] + torch.arange(C, device=dev)   # (E, C)
    rows = torch.where(src < ends[:, None],
                       tok_sorted[src.clamp(max=S * k - 1)], S)
    buf = torch.cat([xg, xg.new_zeros((1, d))])[rows]      # (E, C, d)
    return buf, (e_sorted, slot, tok_sorted, order)


def _combine_group(out_buf, info, gates, S: int):
    """out_buf: (E, C, d) -> (S, d) f32 weighted combine: token t's k terms
    summed in a fixed order (no scatter-add)."""
    e_sorted, slot, tok_sorted, order = info
    C = out_buf.shape[1]
    k = gates.shape[-1]
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device))
    e_tok = e_sorted[inv].view(S, k)                  # = idx
    slot_tok = slot[inv].view(S, k)
    keep = slot_tok < C
    y = out_buf[e_tok, slot_tok.clamp(max=C - 1)]     # (S, k, d)
    w = gates * keep
    return (y * w[..., None]).sum(dim=1)              # promotes to f32


def _stack(ts):
    """Stack per-group tensors; one group is a view, not a copy."""
    return ts[0][None] if len(ts) == 1 else torch.stack(ts)


def _expert_mm(h, w):
    """Per-expert product: h (G, E, C, a) @ w (E, a, b) -> (G, E, C, b) in
    h's dtype (f32 accumulation, as the reference's
    ``preferred_element_type=f32`` and cast)."""
    G, E, C, a = h.shape
    if G == 1:
        return torch.bmm(h[0], w)[None]
    hh = h.transpose(0, 1).reshape(E, G * C, a)
    return torch.bmm(hh, w).reshape(E, G, C, -1).transpose(0, 1)


def moe_apply(p, x, cfg: ArchConfig, ctx: ModelContext):
    """x: (B, S, d) -> ((B, S, d), aux).  Meshless, every dispatch clause
    (``"sorted"`` and ``"a2a"``) takes the sorted path, as the
    reference's does without a mesh."""
    return moe_apply_sorted(p, x, cfg, ctx)


def moe_apply_sorted(p, x, cfg: ArchConfig, ctx: ModelContext):
    """x: (B, S, d) -> ((B, S, d), aux loss f32).  Decode (``ctx.decode``)
    discards the aux loss, so it is not computed there (None)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    G = min(ctx.moe_groups, T)
    while T % G:
        G -= 1
    Sg = T // G
    C = capacity(cfg, Sg)

    xf = x.reshape(G, Sg, d)
    probs, gates, idx = route(p["router"], xf, k)     # (G,Sg,E|k|k)
    aux = None if ctx.decode else aux_loss(probs, idx, E, k)

    parts = [_dispatch_group(xf[g], gates[g], idx[g], E, C)
             for g in range(G)]
    buf = _stack([b for b, _ in parts])               # (G, E, C, d)

    act = act_fn(cfg.act)
    h = _expert_mm(buf, p["wi"])
    if cfg.glu:
        h = act(_expert_mm(buf, p["wg"])) * h
    else:
        h = act(h)
    out_buf = _expert_mm(h, p["wo"])

    y = _stack([_combine_group(out_buf[g], info, gates[g], Sg)
                for g, (_, info) in enumerate(parts)])
    return y.reshape(B, S, d).to(x.dtype), aux
