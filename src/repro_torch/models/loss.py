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
    hit = (logits.argmax(dim=-1) == targets).float()
    if mask is not None:
        m = mask.float()
        denom = m.sum().clamp_min(1.0)
        loss = (per_tok * m).sum() / denom
        acc = (hit * m).sum() / denom
    else:
        loss = per_tok.mean()
        acc = hit.mean()
    return loss, {"nll": nll.mean(), "z_loss": zl.mean(), "accuracy": acc}
