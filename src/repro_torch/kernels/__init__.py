"""Kernels of the port: model-layout ops over hand-written CUDA kernels.

Callers import the ops from here.  ``build`` compiles and loads the CUDA
sources (on first use, on a machine with ``nvcc``) and keeps the launch
counts.
"""
from repro_torch.kernels.build import LAUNCHES, reset_launches  # noqa: F401
from repro_torch.kernels.ops import (  # noqa: F401
    flash_attention, flash_decode, mlstm_chunkwise, rglru, rmsnorm)

__all__ = ["flash_attention", "flash_decode", "rglru", "mlstm_chunkwise",
           "rmsnorm", "LAUNCHES", "reset_launches"]
