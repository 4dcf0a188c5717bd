"""Kernels of the port: model-layout ops over hand-written CUDA kernels.

Callers import the ops from here.  ``build`` compiles and loads the CUDA
sources (on first use, on a machine with ``nvcc``) and keeps the launch
counts.
"""
from repro_torch.kernels.build import LAUNCHES, reset_launches  # noqa: F401
from repro_torch.kernels.ops import flash_attention, flash_decode  # noqa: F401

__all__ = ["flash_attention", "flash_decode", "LAUNCHES", "reset_launches"]
