"""Causal LM loss: cross-entropy with z-loss and optional masking."""
from __future__ import annotations

import torch


def softmax_xent(logits, targets, *, z_loss: float = 1e-4, mask=None):
    """logits: (..., V); targets: (...,) int.  Log-sum-exp in f32.

    Returns (mean loss, metrics dict of ``nll``, ``z_loss``, ``accuracy``).
    """
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, targets[..., None].long())[..., 0]
    nll = lse - ll
    zl = z_loss * lse.square()
    per_tok = nll + zl
    hit = (_whole_last_dim(logits).argmax(dim=-1) == targets).float()
    if mask is not None:
        m = mask.float()
        denom = m.sum().clamp_min(1.0)
        loss = (per_tok * m).sum() / denom
        acc = (hit * m).sum() / denom
    else:
        loss = per_tok.mean()
        acc = hit.mean()
    return loss, {"nll": nll.mean(), "z_loss": zl.mean(), "accuracy": acc}


def _whole_last_dim(x):
    """``x`` with its last dim whole on each rank: a DTensor sharded on the
    vocab dim is gathered there first (DTensor's argmax over a sharded dim
    fails); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    last = x.ndim - 1
    pl = [Replicate() if isinstance(p, Shard) and p.dim in (-1, last) else p
          for p in x.placements]
    return x.redistribute(x.device_mesh, pl)
