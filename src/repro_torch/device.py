"""Device resolution for the port's entry points.

Entry points default to ``device="cuda"`` and run on the CPU only when the
caller asks for it; asking for CUDA where there is none raises instead of
quietly running on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev
