"""Launch wrapper of the CUDA chunkwise-mLSTM kernels.

The kernels (``csrc/mlstm.cu``) replace the Pallas TPU kernel
``src/repro/kernels/mlstm.py`` (``mlstm_chunkwise_fwd``).  Layout as the
reference: q, k, v ``(B,H,S,dh)`` f32 (q pre-scaled) and the gate logs li,
lf ``(B,H,S)`` f32, all passed as strided views (the model's einsum
outputs are permuted, not copied).  The kernels work in their own 64-row
chunks; any ``S`` and any ``dh <= MAX_DH`` (512) are accepted.

One call is one op (one count in ``LAUNCHES``) and three CUDA kernels:
the gates kernel (the key weights of every full chunk and the stabilizer
carried across chunks) and the state kernel (chunk-local C updates
rescaled into the state entering each chunk), both only when S > 64; then
the output kernel (one CTA per chunk, from the stored states).  Products
run on the tensor cores as a 3xTF32 split, which keeps the reference's f32
dot contract.  The stored states are a workspace of
``repro_mlstm_workspace`` floats, allocated here: 75.5 MB at
(1, 4, 2048, 384).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as K

NAME = "mlstm"
# q, k, v, li, lf, h, workspace; B, H, S, dh; strides; stream
ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
            + [ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p])


#: the kernels' largest head dim (compiled in by ``build.py``)
MAX_DH = K.MLSTM_MAX_DH


def check_head_dim(dh: int):
    """Refuse a head dim above :data:`MAX_DH`."""
    if dh > MAX_DH:
        raise ValueError(f"{NAME}: head dim {dh} > {MAX_DH}")


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
    check_head_dim(dh)
    out = torch.empty((B, H, S, dh), dtype=torch.float32, device=q.device)
    n_work = K.function(NAME, "repro_mlstm_workspace", [ctypes.c_int] * 4,
                        ctypes.c_int64)(B, H, S, dh)
    work = torch.empty(n_work, dtype=torch.float32, device=q.device)
    fn = K.function(NAME, "repro_mlstm_fwd", ARGTYPES)
    strides = K.strides_arg((q, (0, 1, 2)), (k, (0, 1, 2)), (v, (0, 1, 2)),
                            (li, (0, 1, 2)), (lf, (0, 1, 2)),
                            (out, (0, 1, 2)))
    with K.on_device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), li.data_ptr(),
                  lf.data_ptr(), out.data_ptr(), work.data_ptr(), B, H, S,
                  dh, strides, K.stream_ptr(q.device))
    K.check(NAME, code)
    K.LAUNCHES[NAME] += 1
    return out
