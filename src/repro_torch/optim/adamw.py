"""AdamW with global-norm clipping, a cosine schedule and optional
optimizer-state compression (m/v in bf16), as the reference's
``repro.optim.adamw``: the same constants and the same f32 math.

The update is in place, under ``torch.no_grad()``: each parameter leaf and
its m and v are written back into their own storage.  A stacked group's
layers read views of its stacked leaves (``params.layer_slice``), so a
leaf rebound in the tree would leave the model reading stale weights.
Every leaf is updated in f32 and written back in its own dtype, one flat
chunk of at most ``CHUNK`` elements at a time: at granite-8b's width a
stacked MLP leaf of 8 layers holds 470 M elements, and a whole-leaf f32
update would make several 1.9 GB temporaries that XLA's fused update
never has.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.models.params import DTYPES, tree_leaves, tree_map

#: elements per chunk of the update: 128 MiB per f32 temporary
CHUNK = 1 << 25


class AdamWState(NamedTuple):
    step: int                     # updates taken so far
    m: object                     # tree like params
    v: object


def adamw_init(params, state_dtype: str = "float32") -> AdamWState:
    dt = DTYPES[state_dtype]

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    return AdamWState(0, tree_map(zeros, params), tree_map(zeros, params))


def cosine_lr(step: int, *, peak_lr: float, warmup: int = 100,
              total: int = 10000, min_frac: float = 0.1) -> float:
    """Linear warm-up to ``peak_lr``, then a cosine down to
    ``min_frac * peak_lr`` at ``total``."""
    step = float(step)
    if step < warmup:
        return peak_lr * min(1.0, step / max(warmup, 1))
    t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak_lr * (min_frac + (1 - min_frac) * 0.5
                      * (1 + math.cos(math.pi * t)))


def _chunks(t: torch.Tensor):
    """Flat chunks of ``t`` as views: writes land in ``t``."""
    return t.view(-1).split(CHUNK)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (0-dim tensor)."""
    sq = [c.float().square().sum() for x in tree_leaves(tree)
          for c in x.reshape(-1).split(CHUNK)]
    return torch.stack(sq).sum().sqrt()


def adamw_update(grads, state: AdamWState, params, *, lr: float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 clip_norm: Optional[float] = 1.0):
    """Updates ``params``, ``state.m`` and ``state.v`` in place.

    Returns (params, the new state, metrics {"grad_norm", "lr"}).
    """
    with torch.no_grad():
        gnorm = global_norm(grads)
        scale = None
        if clip_norm is not None:
            scale = (clip_norm / gnorm.clamp_min(1e-9)).clamp_max(1.0)
        step = state.step + 1
        bc1 = 1.0 - b1 ** step
        bc2 = 1.0 - b2 ** step
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.m),
                              tree_leaves(state.v), tree_leaves(params)):
            for gc, mc, vc, pc in zip(g.reshape(-1).split(CHUNK),
                                      _chunks(m), _chunks(v), _chunks(p)):
                if scale is not None:     # in g's dtype, as the reference
                    gc = gc * scale.to(gc.dtype)
                gf = gc.float()           # may alias the caller's grads
                mf = mc if mc.dtype == torch.float32 else mc.float()
                vf = vc if vc.dtype == torch.float32 else vc.float()
                mf.mul_(b1).add_(gf, alpha=1 - b1)
                vf.mul_(b2).addcmul_(gf, gf, value=1 - b2)
                delta = (mf / bc1).div_((vf / bc2).sqrt_().add_(eps))
                if pc.dtype == torch.float32:
                    pc.add_(delta.add_(pc, alpha=weight_decay), alpha=-lr)
                else:
                    pf = pc.float()
                    pc.copy_(pf.sub_(delta.add_(pf, alpha=weight_decay),
                                     alpha=lr))
                if mf is not mc:
                    mc.copy_(mf)
                    vc.copy_(vf)
    metrics = {"grad_norm": gnorm,
               "lr": torch.tensor(lr, dtype=torch.float32,
                                  device=gnorm.device)}
    return params, AdamWState(step, state.m, state.v), metrics
