"""Launch wrapper of the CUDA flash-attention forward kernel.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention.py`` (``flash_attention_fwd``).  This
wrapper takes the reference's head-major layout, q ``(B,H,Sq,D)`` and k/v
``(B,KV,Sk,D)``, as strided views: the model's ``(B,S,H,D)`` tensors are
passed transposed, without a copy.  Unlike the reference, any ``S`` is
accepted (the kernel masks the ragged tile).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as K

NAME = "flash_attention"
# q, k, v, o; dtype, B, H, KV, Sq, Sk, D; strides; causal, window, scale;
# stream
ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
            + [ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
               ctypes.c_float, ctypes.c_void_p])


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """q: (B,H,Sq,D); k/v: (B,KV,Sk,D) on a CUDA device -> (B,H,Sq,D).

    Output has q's dtype and q's strides.
    """
    K.validate(NAME, (q, k, v))
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{NAME}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if H % KV:
        raise ValueError(f"{NAME}: heads {H} not a multiple of kv heads {KV}")
    out = torch.empty_like(q)
    fn = K.function(NAME, "repro_flash_attention_fwd", ARGTYPES)
    strides = K.strides_arg((q, (0, 1, 2)), (k, (0, 1, 2)), (v, (0, 1, 2)),
                            (out, (0, 1, 2)))
    with K.on_device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  K.DTYPE_CODES[q.dtype], B, H, KV, Sq, Sk, D, strides,
                  int(causal), int(window), D ** -0.5,
                  K.stream_ptr(q.device))
    K.check(NAME, code)
    K.LAUNCHES[NAME] += 1
    return out
