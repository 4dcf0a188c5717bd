"""Launch wrapper of the CUDA flash-decode kernel.

The kernel (``csrc/flash_decode.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/flash_decode.py`` (``flash_decode_fwd``).  Layout as
the reference: q ``(B,H,D)``, k/v ``(B,KV,Smax,D)`` (strided views of the
model's ``(B,Smax,KV,D)`` caches), and a scalar ``pos`` that reaches the
kernel as an argument.  Any number of query heads per kv head; one kernel
launch per call, with no scratch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as K

NAME = "flash_decode"
# q, k, v, o, lse; dtype, B, H, KV, n_keys, D; strides; scale; stream
ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
            + [ctypes.POINTER(ctypes.c_int64), ctypes.c_float,
               ctypes.c_void_p])


def check_heads(H: int, KV: int):
    """Refuse query heads that do not divide over the kv heads."""
    if H % KV:
        raise ValueError(f"{NAME}: {H} heads do not divide over {KV} kv "
                         f"heads")


def check_rows(strides, base: int = 0):
    """Refuse a view whose rows are not aligned: every stride but the last
    a multiple of 8 elements (16 bytes at bf16), and the base 16-byte
    aligned."""
    if base % 16 or any(s % 8 for s in strides[:-1]):
        raise ValueError(f"{NAME}: rows must be 16-byte aligned "
                         f"(strides {tuple(strides)})")


def flash_decode_fwd(q, k, v, pos: int, *, return_lse: bool = False):
    """q: (B,H,D); k/v: (B,KV,Smax,D) on a CUDA device; slots <= pos are
    attended.  Returns out (B,H,D) in q's dtype, and lse (B,H) f32 when
    ``return_lse``."""
    K.validate(NAME, (q, k, v))
    B, H, D = q.shape
    KV, Smax = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{NAME}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    pos = int(pos)
    if pos < 0:
        raise ValueError(f"{NAME}: pos {pos} < 0")
    check_heads(H, KV)
    for t in (q, k, v):
        check_rows(t.stride(), t.data_ptr())
    dev = q.device
    out = torch.empty((B, H, D), dtype=q.dtype, device=dev)
    lse = torch.empty((B, H), dtype=torch.float32, device=dev) \
        if return_lse else None
    fn = K.function(NAME, "repro_flash_decode_fwd", ARGTYPES)
    strides = K.strides_arg((q, (0, 1)), (k, (0, 2, 1)), (v, (0, 2, 1)),
                            (out, (0, 1)))
    with K.on_device(dev):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  lse.data_ptr() if lse is not None else None,
                  K.DTYPE_CODES[q.dtype], B, H, KV, min(pos + 1, Smax), D,
                  strides, D ** -0.5, K.stream_ptr(dev))
    K.check(NAME, code)
    K.LAUNCHES[NAME] += 1
    return (out, lse) if return_lse else out


def plan(B: int, H: int, KV: int, n_keys: int, D: int):
    """What one call launches at these sizes, by the kernel's own policy:
    (query heads per CTA, head slices per kv head, CTAs per batch row, kv
    head and slice).  For reports and tests."""
    out = (ctypes.c_int * 3)()
    fn = K.function(NAME, "repro_flash_decode_plan",
                    [ctypes.c_int] * 5 + [ctypes.c_void_p])
    K.check(NAME, fn(B, H, KV, n_keys, D, ctypes.addressof(out)))
    return tuple(out)
