"""Launch wrapper of the CUDA chunkwise-mLSTM kernel.

The kernel (``csrc/mlstm.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/mlstm.py`` (``mlstm_chunkwise_fwd``).  Layout as the
reference: q, k, v ``(B,H,S,dh)`` f32 (q pre-scaled) and the gate logs li,
lf ``(B,H,S)`` f32, all passed as strided views (the model's einsum
outputs are permuted, not copied).  The kernel walks the sequence in its
own 64-row chunks; any ``S`` is accepted.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as K

NAME = "mlstm"
# q, k, v, li, lf, h; B, H, S, dh; strides; stream
ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
            + [ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p])


def mlstm_fwd(q, k, v, li, lf) -> torch.Tensor:
    """q,k,v: (B,H,S,dh) f32; li,lf: (B,H,S) f32, on a CUDA device ->
    h (B,H,S,dh) f32, contiguous."""
    K.validate(NAME, (q, k, v), dtypes=(torch.float32,), head_dims=None)
    B, H, S, dh = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{NAME}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    for g in (li, lf):
        if g.shape != (B, H, S) or g.dtype != torch.float32 or \
                g.device != q.device:
            raise ValueError(f"{NAME}: gates must be (B,H,S) f32 on "
                             f"{q.device}, got {tuple(g.shape)} {g.dtype} "
                             f"{g.device}")
    max_dh = K.function(NAME, "repro_mlstm_max_dh", [])()
    if dh > max_dh:
        raise ValueError(f"{NAME}: head dim {dh} > {max_dh}")
    out = torch.empty((B, H, S, dh), dtype=torch.float32, device=q.device)
    fn = K.function(NAME, "repro_mlstm_fwd", ARGTYPES)
    strides = K.strides_arg((q, (0, 1, 2)), (k, (0, 1, 2)), (v, (0, 1, 2)),
                            (li, (0, 1, 2)), (lf, (0, 1, 2)),
                            (out, (0, 1, 2)))
    with K.on_device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), li.data_ptr(),
                  lf.data_ptr(), out.data_ptr(), B, H, S, dh, strides,
                  K.stream_ptr(q.device))
    K.check(NAME, code)
    K.LAUNCHES[NAME] += 1
    return out
