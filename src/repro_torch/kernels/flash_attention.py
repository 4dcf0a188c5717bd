"""Launch wrapper of the CUDA flash-attention forward kernel.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention.py`` (``flash_attention_fwd``).  This
wrapper takes the reference's head-major layout, q ``(B,H,Sq,D)`` and k/v
``(B,KV,Sk,D)``, as strided views: the model's ``(B,S,H,D)`` tensors are
passed transposed, without a copy.  Unlike the reference, any ``S`` is
accepted (the kernel masks the ragged tile).

Two routes (:func:`route`): bf16 at the served head dims runs on the tensor
cores (``wgmma`` fed by TMA, with p rounded to bf16 before P V); f32, and
bf16 at the other compiled head dims, keeps the f32-FMA kernel.  Both write
each row's log-sum-exp beside the output when asked.

:func:`flash_attention_bwd` is the backward kernel of the ``wgmma`` route
(the reference has none: its op differentiates the plain math), driven by
that log-sum-exp; :func:`bwd_route` says where it runs.
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
#: head dims of the backward kernel: the wgmma route's but 256, whose dK
#: and dV accumulators (128 registers a thread each) do not fit a thread
BWD_HEAD_DIMS = (64, 80, 96, 112, 128)
#: the backward's query rows a tile, and the dQ accumulator's floats per
#: tile and 64-column atom (csrc/flash_attention.cu BwdCfg)
BWD_BQ = 64
BWD_ATOM_FLOATS = BWD_BQ * 64
_TAIL = [ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
         ctypes.c_float, ctypes.c_void_p]
# q, k, v, o, lse; dtype, B, H, KV, Sq, Sk, D; strides; causal, window,
# scale; stream
ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + _TAIL
# the same without the dtype
WGMMA_ARGTYPES = ARGTYPES[:5] + ARGTYPES[6:]
# the twelve pointers (an array); B, H, KV, Sq, Sk, D; strides; causal,
# window, scale; stream
BWD_ARGTYPES = [ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_int] * 6 + _TAIL


def route(dtype: torch.dtype, head_dim: int) -> str:
    """``"wgmma"`` (bf16 tensor cores) or ``"fma"`` (f32 CUDA cores)."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "fma"


def bwd_route(dtype: torch.dtype, head_dim: int,
              device_type: str = "cuda") -> str:
    """Where the gradient of a flash-attention call runs: ``"wgmma"`` (the
    hand backward kernel, :func:`flash_attention_bwd`) or ``"plain"``
    (autograd of the plain q-chunked attention, as the reference's op).

    The kernel takes what the forward's wgmma route wrote, bf16 at
    :data:`BWD_HEAD_DIMS`.  The rest stays plain: f32 (the fma route,
    whose 2e-5 tolerance admits no bf16 P or dS), D=256 (recurrentgemma's
    local attention: dK and dV would not fit a thread's registers), and
    every device but CUDA (the CPU has no kernel)."""
    if (device_type == "cuda" and dtype == torch.bfloat16
            and head_dim in BWD_HEAD_DIMS):
        return "wgmma"
    return "plain"


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


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        return_lse: bool = False):
    """q: (B,H,Sq,D); k/v: (B,KV,Sk,D) on a CUDA device -> (B,H,Sq,D).

    Output has q's dtype and q's strides.  With ``return_lse`` also each
    row's log-sum-exp ``m + log(max(l, 1e-30))`` of the scaled, masked
    scores, f32 (B,H,Sq): what :func:`flash_attention_bwd` takes.
    """
    K.validate(NAME, (q, k, v))
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{NAME}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    check_heads(H, KV)
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr())
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
    return (out, lse) if return_lse else out


def flash_attention_bwd(dout, q, k, v, out, lse, *, causal: bool = True,
                        window: int = 0):
    """Gradients (dq, dk, dv) of :func:`flash_attention_fwd`'s wgmma route
    at cotangent ``dout``, from its ``out`` and ``lse``.

    Layouts as the forward's (head-major views; ``dout`` and ``out`` like
    q, with strides TMA can take); bf16 at :data:`BWD_HEAD_DIMS` only
    (:func:`bwd_route`), raises otherwise.  One call launches three CUDA
    kernels (Delta and the LSE rows; the backward; dq from its f32
    accumulator) and counts once in ``LAUNCHES["flash_attention_bwd"]``."""
    K.validate(NAME, (q, k, v, out, dout), dtypes=(torch.bfloat16,),
               head_dims=BWD_HEAD_DIMS)
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != D
            or out.shape != q.shape or dout.shape != q.shape
            or lse.shape != (B, H, Sq)):
        raise ValueError(f"{NAME}_bwd: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, out "
                         f"{tuple(out.shape)}, dout {tuple(dout.shape)}, "
                         f"lse {tuple(lse.shape)}")
    check_heads(H, KV)
    lse = lse.float().contiguous()
    n_qt = -(-Sq // BWD_BQ)
    atoms = 1 if D <= 64 else 2
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty(B * H * n_qt * atoms * BWD_ATOM_FLOATS, **f32)
    rows = torch.empty(2, B * H * n_qt * BWD_BQ, **f32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ptrs = (ctypes.c_void_p * 12)(*[t.data_ptr() for t in (
        q, k, v, out, dout, lse, dq, dk, dv, acc, rows[0], rows[1])])
    # q, k, v, dout through TMA; out through 16-byte loads, which take the
    # same strides
    vals = [s for t in (q, k, v, out, dout) for s in _tma_strides(t, D)]
    vals += [t.stride(d) for t in (dq, dk, dv) for d in (0, 1, 2)]
    strides = (ctypes.c_int64 * 24)(*vals)
    fn = K.function(NAME, "repro_flash_attention_wgmma_bwd", BWD_ARGTYPES)
    with K.on_device(q.device):
        code = fn(ptrs, B, H, KV, Sq, Sk, D, strides, int(causal),
                  int(window), D ** -0.5, K.stream_ptr(q.device))
    K.check(NAME, code)
    K.LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
