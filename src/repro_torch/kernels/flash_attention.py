"""Launch wrapper of the CUDA flash-attention forward kernel.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention.py`` (``flash_attention_fwd``).  This
wrapper takes the reference's head-major layout, q ``(B,H,Sq,D)`` and k/v
``(B,KV,Sk,D)``, as strided views: the model's ``(B,S,H,D)`` tensors are
passed transposed, without a copy.  Unlike the reference, any ``S`` is
accepted (the kernel masks the ragged tile).

Two routes (:func:`route`): bf16 at the served head dims runs on the tensor
cores (``wgmma`` fed by TMA, with p rounded to bf16 before P V); f32, and
bf16 at the other compiled head dims, keeps the f32-FMA kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as K

NAME = "flash_attention"
#: head dims of the wgmma route: every attention arch the port serves
#: (musicgen-large 64, stablelm-3b 80, phi-3-vision-4.2b 96, kimi-k2 112,
#: granite-8b, qwen3-moe, chatglm3-6b and starcoder2-3b 128,
#: recurrentgemma-2b 256)
WGMMA_HEAD_DIMS = (64, 80, 96, 112, 128, 256)
# q, k, v, o; dtype, B, H, KV, Sq, Sk, D; strides; causal, window, scale;
# stream
ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
            + [ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
               ctypes.c_float, ctypes.c_void_p])
# the same without the dtype
WGMMA_ARGTYPES = ARGTYPES[:4] + ARGTYPES[5:]


def route(dtype: torch.dtype, head_dim: int) -> str:
    """``"wgmma"`` (bf16 tensor cores) or ``"fma"`` (f32 CUDA cores)."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "fma"


def check_heads(H: int, KV: int):
    """Refuse query heads that are not a multiple of the kv heads."""
    if H % KV:
        raise ValueError(f"{NAME}: heads {H} not a multiple of kv heads {KV}")


def tma_strides(shape, strides, itemsize: int, D: int):
    """Element strides (b, h, s) for a TMA tensor map over a (B,H,S,D) view
    of these sizes.

    A size-1 axis's stride is never used, so it is set to ``D``; every
    other stride must be a multiple of 16 bytes, or TMA cannot take the
    view."""
    st = [strides[d] if shape[d] > 1 else D for d in (0, 1, 2)]
    if any(s * itemsize % 16 for s in st):
        raise ValueError(f"{NAME}: TMA needs 16-byte aligned strides, got "
                         f"strides {tuple(strides)}")
    return st


def _tma_strides(t, D: int):
    """:func:`tma_strides` of ``t``, whose base must be 16-byte aligned."""
    if t.data_ptr() % 16:
        raise ValueError(f"{NAME}: TMA needs a 16-byte aligned base, got "
                         f"{t.data_ptr():#x}")
    return tma_strides(t.shape, t.stride(), t.element_size(), D)


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
    check_heads(H, KV)
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    tail = (int(causal), int(window), D ** -0.5, K.stream_ptr(q.device))
    if route(q.dtype, D) == "wgmma":
        fn = K.function(NAME, "repro_flash_attention_wgmma_fwd",
                        WGMMA_ARGTYPES)
        vals = [s for t in (q, k, v) for s in _tma_strides(t, D)]
        vals += [out.stride(d) for d in (0, 1, 2)]
        strides = (ctypes.c_int64 * 12)(*vals)
        with K.on_device(q.device):
            code = fn(*ptrs, B, H, KV, Sq, Sk, D, strides, *tail)
    else:
        fn = K.function(NAME, "repro_flash_attention_fwd", ARGTYPES)
        strides = K.strides_arg((q, (0, 1, 2)), (k, (0, 1, 2)),
                                (v, (0, 1, 2)), (out, (0, 1, 2)))
        with K.on_device(q.device):
            code = fn(*ptrs, K.DTYPE_CODES[q.dtype], B, H, KV, Sq, Sk, D,
                      strides, *tail)
    K.check(NAME, code)
    K.LAUNCHES[NAME] += 1
    return out
