"""The sweep's segment programs, plainly: the gradients that ComPar's
timer takes of one segment at a train shape, in f32 (or, as the control,
with every product's operands in float8).

- ``embed``: of the sum of squares of the embedded tokens, by the table;
- ``head``: of the mean cross-entropy plus z-loss of the head's logits
  against target 0, by the head's weights and its input ``x``;
- ``stack``: of the sum of squares of the layers' output, by the layers'
  weights and their input ``x``.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from perfbench.reference.model import Precision, logits_of, stack, xent


def _objective(arch: dict, kind: str, w: dict, inp, prec: Precision):
    if kind == "embed":
        return F.embedding(inp, w["embed/tok"]).square().sum()
    if kind == "head":
        logits = logits_of(arch, w, inp, prec)
        return xent(logits, torch.zeros(logits.shape[0], dtype=torch.long,
                                        device=logits.device))
    if kind == "stack":
        return stack(arch, w, inp, prec).square().sum()
    raise ValueError(f"segment kind {kind!r}")


def segment_grads(arch: dict, kind: str, weights: Dict[str, torch.Tensor],
                  inp, precision: str = "float32") -> Dict[str, torch.Tensor]:
    """path -> the f32 gradient of ``kind``'s objective by that leaf of
    ``weights`` (the segment's leaves, by their paths in the harness's
    layout) and, but for ``embed``, by the input (path ``x``)."""
    prec = Precision(precision)
    w = {p: t.to(torch.float32, copy=True).requires_grad_()
         for p, t in weights.items()}
    if kind != "embed":
        inp = inp.to(torch.float32, copy=True).requires_grad_()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        wrt = dict(w, x=inp) if kind != "embed" else w
        grads = torch.autograd.grad(_objective(arch, kind, w, inp, prec),
                                    list(wrt.values()))
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    return dict(zip(wrt, grads))
