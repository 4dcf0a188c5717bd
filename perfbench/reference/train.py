"""The reference's training steps: gradients by autograd of
:func:`perfbench.reference.model.loss_fn` in f32, AdamW with global-norm
clipping and a cosine schedule in f32, and each parameter kept in the
dtype the configuration states (its update is rounded into it, as a
bfloat16 parameter is).

``steps`` returns what the comparison reads: each step's loss, the first
step's logits at a sample of places, each leaf's norm of the first
(clipped) gradient, and each leaf's norm of the parameters' change over
the steps.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from perfbench.reference.model import Precision, loss_fn

B1, B2, EPS = 0.9, 0.95, 1e-8


def cosine_lr(step: int, *, peak_lr: float, warmup: int, total_steps: int,
              min_frac: float = 0.1) -> float:
    """Linear warm-up to ``peak_lr``, then a cosine to ``min_frac`` of it."""
    if step < warmup:
        return peak_lr * min(1.0, step / max(warmup, 1))
    t = min(max((step - warmup) / max(total_steps - warmup, 1), 0.0), 1.0)
    return peak_lr * (min_frac + (1 - min_frac) * 0.5
                      * (1 + math.cos(math.pi * t)))


def _slices(weights: dict, num_layers: int) -> Dict[str, list]:
    """path -> the leaf's per-layer tensors (views; one for an unstacked
    leaf)."""
    return {p: (list(t.unbind(0)) if p.startswith("g0/") and num_layers > 1
                else [t]) for p, t in weights.items()}


def _norm(parts) -> float:
    return math.sqrt(sum(float(x.float().square().sum()) for x in parts))


def _gather(parts, index):
    """Elements ``index`` of the flat leaf made of ``parts`` (its layers,
    in order), as a CPU f32 tensor."""
    per = parts[0].numel()
    out = torch.empty(index.numel(), dtype=torch.float32)
    for layer, t in enumerate(parts):
        sel = (index // per) == layer
        if sel.any():
            out[sel] = t.detach().reshape(-1)[
                (index[sel] % per).to(t.device)].float().cpu()
    return out


def steps(arch: dict, weights: dict, batches: List[dict], optimizer: dict,
          precision: str = "float32", samples=None, logits_at=None) -> dict:
    """Train ``weights`` (updated in place) on ``batches``, one step each.

    Returns {"losses": [...], "grad_norms": {path: norm},
    "change_norms": {path: norm}, "grad_samples": {path: the first
    gradient's elements at ``samples[path]``, flat indices},
    "logits_sample": the first step's logits at ``logits_at``, flat
    indices into (B, S, V)}."""
    prec = Precision(precision)
    L = arch["num_layers"]
    store = _slices(weights, L)
    initial = {p: [t.clone() for t in ts] for p, ts in store.items()}
    m = {p: [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
             for t in ts] for p, ts in store.items()}
    v = {p: [torch.zeros_like(t) for t in ts] for p, ts in m.items()}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    losses, grad_norms, grad_samples, logits = [], {}, {}, None
    try:
        for k, batch in enumerate(batches):
            f32 = {p: [t.to(torch.float32, copy=True).requires_grad_()
                       for t in ts]
                   for p, ts in store.items()}
            leaves = [t for ts in f32.values() for t in ts]
            full = {p: ts if p.startswith("g0/") and L > 1 else ts[0]
                    for p, ts in f32.items()}
            loss = loss_fn(arch, full, batch["tokens"], batch["targets"], prec,
                           logits_at if k == 0 else None)
            if k == 0 and logits_at is not None:
                loss, logits = loss
            grads = torch.autograd.grad(loss, leaves)
            del full
            losses.append(float(loss.detach()))
            gnorm = math.sqrt(sum(float(g.square().sum()) for g in grads))
            scale = min(1.0, optimizer["clip_norm"] / max(gnorm, 1e-9))
            lr = cosine_lr(k, peak_lr=optimizer["peak_lr"],
                           warmup=optimizer["warmup"],
                           total_steps=optimizer["total_steps"])
            bc1, bc2 = 1 - B1 ** (k + 1), 1 - B2 ** (k + 1)
            it = iter(grads)
            for p, ts in store.items():
                gs = [next(it).mul_(scale) for _ in ts]
                if k == 0:
                    grad_norms[p] = _norm(gs)
                    if samples is not None:
                        grad_samples[p] = _gather(gs, samples[p])
                for t, g, mt, vt in zip(ts, gs, m[p], v[p]):
                    mt.mul_(B1).add_(g, alpha=1 - B1)
                    vt.mul_(B2).addcmul_(g, g, value=1 - B2)
                    delta = (mt / bc1).div_((vt / bc2).sqrt_().add_(EPS))
                    pf = t.float()
                    t.copy_(pf.sub_(delta.add_(pf, alpha=optimizer[
                        "weight_decay"]), alpha=lr))
                del gs
            del grads, leaves, f32
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    change = {p: _norm(t.float() - t0.float()
                       for t, t0 in zip(ts, initial[p]))
              for p, ts in store.items()}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change, "grad_samples": grad_samples,
            "logits_sample": logits}
