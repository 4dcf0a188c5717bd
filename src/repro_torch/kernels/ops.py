"""Model-layout ops over the kernels, differentiable as the reference's.

Dispatch is on the tensor's device and nothing else: a CUDA tensor goes to
the hand-written kernel (a failed build or launch raises), a CPU tensor to
the kernel's plain version in ``kernels/ref.py``.

Every op but flash-decode is a ``torch.autograd.Function``, as every op of
the reference is a ``jax.custom_vjp`` (``src/repro/kernels/ops.py``): the
forward runs the kernel (or, on the CPU, its plain version), and the
backward recomputes the reference's plain math on the saved inputs under
``torch.enable_grad()`` and returns ``torch.autograd.grad`` of it.  There
is no backward kernel, in the reference either.  Flash-decode serves
only; it raises if asked for a gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as R
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.flash_decode import flash_decode_fwd
from repro_torch.kernels.mlstm import mlstm_fwd
from repro_torch.kernels.rglru import rglru_fwd
from repro_torch.kernels.rmsnorm import rmsnorm_fwd


def _route(name: str, t) -> bool:
    """True for the CUDA kernel, False for the plain version."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel for device {t.device}")


def _vjp(fn, inputs, grads):
    """Gradients of ``fn(*inputs)`` against ``grads``, recomputed from
    detached copies of ``inputs``: the backward of every op here."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_() for t in inputs]
        return torch.autograd.grad(fn(*xs), xs, grads)


# --- flash attention -----------------------------------------------------------

def _fa_forward(q, k, v, causal, window):
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if _route("flash_attention", q):
        o = flash_attention_fwd(qh, kh, vh, causal=causal, window=window)
    else:
        o = R.flash_attention_ref(qh, kh, vh, causal=causal, window=window)
    return o.transpose(1, 2)


def _fa_plain(q, k, v, causal, window, block_q):
    """The backward's math: the reference's ``_ref``, the q-chunked plain
    attention at the clause's ``block_q``.  That path is causal only (the
    reference's ``_ref`` is causal whatever it is asked); a non-causal call
    differentiates ``ref.flash_attention_ref`` instead, on every device."""
    if not causal:
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        return R.flash_attention_ref(qh, kh, vh, causal=False,
                                     window=window).transpose(1, 2)
    from repro_torch.models.attention import chunked_attention
    pos_q = torch.arange(q.shape[1], device=q.device)
    pos_k = torch.arange(k.shape[1], device=q.device)
    return chunked_attention(q, k, v, pos_q=pos_q, pos_k=pos_k,
                             window=window, q_chunk=block_q)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, block_q):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, block_q)
        return _fa_forward(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, g):
        return (*_vjp(lambda q, k, v: _fa_plain(q, k, v, *ctx.args),
                      ctx.saved_tensors, g), None, None, None)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    block_q: int = 512, block_k: int = 1024):
    """Model layout: q (B,S,H,D); k/v (B,S,KV,D) -> (B,S,H,D).

    ``block_q``/``block_k`` are the clause's tile fields; the CUDA kernel
    uses its own tiles and the plain version none, so neither reads them.
    The backward differentiates the plain chunked attention at ``block_q``.
    """
    return _FlashAttention.apply(q, k, v, causal, window, block_q)


# --- flash decode --------------------------------------------------------------

def flash_decode(q, k_cache, v_cache, pos: int, *, block_k: int = 1024,
                 return_lse: bool = False):
    """Model layout: q (B,H,D); caches (B,Smax,KV,D); scalar ``pos``.

    ``block_k`` is the clause's field; the CUDA kernel splits Smax into its
    own chunks.  Forward only, as in the reference: raises under grad.
    """
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k_cache, v_cache)):
        raise RuntimeError("flash_decode has no backward (nor has the "
                           "reference's); call it under torch.no_grad()")
    if _route("flash_decode", q):
        return flash_decode_fwd(q, k_cache.transpose(1, 2),
                                v_cache.transpose(1, 2), pos,
                                return_lse=return_lse)
    return R.flash_decode_ref(q, k_cache, v_cache, pos,
                              return_lse=return_lse)


# --- rglru -------------------------------------------------------------------

class _RGLRU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_a, b):
        ctx.save_for_backward(log_a, b)
        if _route("rglru", log_a):
            return rglru_fwd(log_a, b)
        return R.rglru_ref(log_a, b)

    @staticmethod
    def backward(ctx, g):
        return _vjp(R.rglru_ref, ctx.saved_tensors, g)


def rglru(log_a, b):
    """log_a, b: (B,S,dr) f32 -> h (B,S,dr) f32.  The CUDA kernel scans the
    whole sequence, so the clause's ``mlstm_chunk`` has no part here; the
    backward differentiates ``ref.rglru_ref``."""
    return _RGLRU.apply(log_a, b)


# --- mlstm -------------------------------------------------------------------

class _MLSTM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, li, lf, chunk):
        ctx.save_for_backward(q, k, v, li, lf)
        ctx.chunk = chunk
        if _route("mlstm", q):
            return mlstm_fwd(q, k, v, li, lf)
        return R.mlstm_chunkwise_ref(q, k, v, li, lf, chunk=chunk)

    @staticmethod
    def backward(ctx, g):
        def plain(q, k, v, li, lf):
            return R.mlstm_chunkwise_ref(q, k, v, li, lf, chunk=ctx.chunk)
        return (*_vjp(plain, ctx.saved_tensors, g), None)


def mlstm_chunkwise(q, k, v, li, lf, *, chunk: int = 256):
    """q,k,v: (B,H,S,dh) f32 (q pre-scaled); li,lf: (B,H,S) -> (B,H,S,dh).

    ``chunk`` is the plain version's chunk (the clause's ``mlstm_chunk``),
    forward on the CPU and backward everywhere; the CUDA kernel uses its
    own 64-row chunks.
    """
    return _MLSTM.apply(q, k, v, li, lf, chunk)


# --- rmsnorm -----------------------------------------------------------------

class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, scale, eps):
        ctx.save_for_backward(x2, scale)
        ctx.eps = eps
        if _route("rmsnorm", x2):
            return rmsnorm_fwd(x2, scale, eps=eps)
        return R.rmsnorm_ref(x2, scale, eps)

    @staticmethod
    def backward(ctx, g):
        def plain(x2, scale):
            return R.rmsnorm_ref(x2, scale, ctx.eps)
        return (*_vjp(plain, ctx.saved_tensors, g), None)


def rmsnorm(x, scale, *, eps: float = 1e-6):
    """x: (..., d) -> RMSNorm of each row by ``scale`` (d,), in x's dtype.
    A standalone op: the models normalise with ``layers.norm_apply``."""
    shp = x.shape
    return _RMSNorm.apply(x.reshape(-1, shp[-1]), scale, eps).reshape(shp)
