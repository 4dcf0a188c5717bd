"""Launch wrapper of the CUDA RG-LRU scan kernel.

The kernel (``csrc/rglru.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/rglru.py`` (``rglru_fwd``): ``h_t = exp(log_a_t) *
h_{t-1} + b_t`` along axis 1 of contiguous ``(B, S, dr)`` f32 arrays.
Unlike the reference, any ``S`` is accepted: the kernel splits the
sequence into its own 256-step tiles, which run in parallel and pass their
carries by a look-back in one launch (after a memset of its flags).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as K

NAME = "rglru"
# log_a, b, h, scratch; B, S, dr; stream
ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def rglru_fwd(log_a, b) -> torch.Tensor:
    """log_a, b: contiguous (B,S,dr) f32 on a CUDA device -> h (B,S,dr)
    f32."""
    K.validate(NAME, (log_a, b), dtypes=(torch.float32,), head_dims=None)
    if log_a.ndim != 3 or log_a.shape != b.shape:
        raise ValueError(f"{NAME}: shapes log_a {tuple(log_a.shape)}, b "
                         f"{tuple(b.shape)}; expected equal (B,S,dr)")
    if not (log_a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{NAME}: log_a and b must be contiguous")
    B, S, dr = log_a.shape
    dev = log_a.device
    out = torch.empty_like(log_a)
    # the tiles' aggregates, inclusive prefixes and flags, and the ticket
    nbytes = K.function(NAME, "repro_rglru_scratch_bytes", [ctypes.c_int] * 3,
                        ctypes.c_int64)(B, S, dr)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    fn = K.function(NAME, "repro_rglru_fwd", ARGTYPES)
    with K.on_device(dev):
        code = fn(log_a.data_ptr(), b.data_ptr(), out.data_ptr(),
                  scratch.data_ptr(), B, S, dr, K.stream_ptr(dev))
    K.check(NAME, code)
    K.LAUNCHES[NAME] += 1
    return out
