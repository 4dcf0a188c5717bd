"""Launch wrapper of the CUDA flash-decode kernel.

The kernel (``csrc/flash_decode.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/flash_decode.py`` (``flash_decode_fwd``).  Layout as
the reference: q ``(B,H,D)``, k/v ``(B,KV,Smax,D)`` (strided views of the
model's ``(B,Smax,KV,D)`` caches), and a scalar ``pos`` that reaches the
kernel as an argument.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as K

NAME = "flash_decode"
# q, k, v, o, lse, o_part, m_part, l_part; dtype, B, H, KV, n_keys, D;
# strides; scale; stream
ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
            + [ctypes.POINTER(ctypes.c_int64), ctypes.c_float,
               ctypes.c_void_p])


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
    max_g = K.constant(NAME, "repro_flash_decode_max_g")
    if H % KV or H // KV > max_g:
        raise ValueError(f"{NAME}: {H} heads over {KV} kv heads; the kernel "
                         f"takes at most {max_g} query heads per kv head")
    for t in (q, k, v):
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:-1]):
            raise ValueError(f"{NAME}: rows must be 16-byte aligned "
                             f"(strides {t.stride()})")
    n_keys = min(pos + 1, Smax)
    nsplit = -(-n_keys // K.constant(NAME, "repro_flash_decode_chunk"))
    dev = q.device
    out = torch.empty((B, H, D), dtype=q.dtype, device=dev)
    lse = torch.empty((B, H), dtype=torch.float32, device=dev) \
        if return_lse else None
    # the splits' partial results, (B,H,nsplit,D) then twice (B,H,nsplit)
    # f32, in one allocation
    rows = B * H * nsplit
    part = torch.empty(rows * (D + 2), dtype=torch.float32, device=dev)
    o_part = part.data_ptr()
    m_part = o_part + 4 * rows * D
    l_part = m_part + 4 * rows
    fn = K.function(NAME, "repro_flash_decode_fwd", ARGTYPES)
    strides = K.strides_arg((q, (0, 1)), (k, (0, 2, 1)), (v, (0, 2, 1)),
                            (out, (0, 1)))
    with K.on_device(dev):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  lse.data_ptr() if lse is not None else None, o_part,
                  m_part, l_part, K.DTYPE_CODES[q.dtype], B, H, KV, n_keys,
                  D, strides, D ** -0.5, K.stream_ptr(dev))
    K.check(NAME, code)
    K.LAUNCHES[NAME] += 1
    return (out, lse) if return_lse else out
