"""Launch wrapper of the CUDA RMSNorm kernel.

The kernel (``csrc/rmsnorm.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/rmsnorm.py`` (``rmsnorm_fwd``): rows of x ``(N,d)``
scaled by ``rsqrt(mean(x^2) + eps) * scale``, f32 math, output in x's
dtype.  No model calls it (the reference's ``norm_apply`` is plain math,
and so is the port's): it is a standalone op.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as K

NAME = "rmsnorm"
# x, scale, y; dtype, scale_dtype, N, d; x row stride, y row stride; eps;
# stream
ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
            + [ctypes.c_int64] * 2 + [ctypes.c_float, ctypes.c_void_p])


def rmsnorm_fwd(x, scale, *, eps: float = 1e-6) -> torch.Tensor:
    """x: (N,d) f32/bf16 with a contiguous last axis; scale: (d,) f32 or
    bf16, on a CUDA device -> (N,d) in x's dtype, contiguous."""
    K.validate(NAME, (x,), head_dims=None)
    if x.ndim != 2:
        raise ValueError(f"{NAME}: x must be (N,d), got {tuple(x.shape)}")
    N, d = x.shape
    if scale.shape != (d,) or scale.device != x.device or \
            scale.dtype not in K.DTYPE_CODES or not scale.is_contiguous():
        raise ValueError(f"{NAME}: scale must be a contiguous ({d},) f32 or "
                         f"bf16 tensor on {x.device}, got "
                         f"{tuple(scale.shape)} {scale.dtype} {scale.device}")
    out = torch.empty((N, d), dtype=x.dtype, device=x.device)
    fn = K.function(NAME, "repro_rmsnorm_fwd", ARGTYPES)
    with K.on_device(x.device):
        code = fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                  K.DTYPE_CODES[x.dtype], K.DTYPE_CODES[scale.dtype], N, d,
                  x.stride(0), out.stride(0), float(eps),
                  K.stream_ptr(x.device))
    K.check(NAME, code)
    K.LAUNCHES[NAME] += 1
    return out
