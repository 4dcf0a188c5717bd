"""Weight bridge: the JAX package's parameter tree, as numpy, into torch.

Paths and layouts stay as they are: leaf ``params["g0"]["b0"]["attn"]["wq"]``
of the reference is the port's leaf of the same path, shape and dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.params import tree_map


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """One array -> tensor, bf16 included.

    JAX bf16 arrays arrive as ``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` rejects: their bits are viewed as ``uint16`` and
    reinterpreted as ``torch.bfloat16``, so the values are carried exactly.
    """
    a = np.array(a, copy=True, order="C")     # owned, writable, contiguous
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(resolve_device(device))


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy; bf16 comes back as f32 (exact)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def params_from_numpy(tree, device="cuda"):
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``."""
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)
