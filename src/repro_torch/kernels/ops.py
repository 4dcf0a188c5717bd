"""Model-layout ops over the kernels, differentiable as the reference's.

Each op is a PyTorch operator, ``torch.ops.repro_torch.<name>``, and
dispatch is on the tensor's device and nothing else: its CUDA
implementation is the hand-written kernel (a failed build or launch
raises), its CPU implementation the kernel's plain version in
``kernels/ref.py``.  Other devices raise.

Every op but flash-decode has a backward, as every op of the reference is
a ``jax.custom_vjp`` (``src/repro/kernels/ops.py``): it recomputes the
reference's plain math on the saved inputs under ``torch.enable_grad()``
and returns ``torch.autograd.grad`` of it.  Flash-attention's is the one
departure: where :func:`~repro_torch.kernels.flash_attention.bwd_route`
says ``"wgmma"`` (bf16 on the card at the served head dims but 256) its
gradient is the hand backward kernel, its own operator
``repro_torch::flash_attention_bwd``, from the log-sum-exp that the
forward returns beside its output; the reference has no backward kernel.
Flash-decode serves only; it raises if asked for a gradient.

Each op also has a fake implementation (an empty output of the right
shape and dtype, for ``FakeTensorMode``) and a flop formula for
``torch.utils.flop_counter.FlopCounterMode``: the kernel's own products,
as ``chip_smoke.py``'s bound counts them.  The sweep's dry run
(``core/executor.py``) counts an op like any other operator from these.

Under a mesh the model hands these wrappers DTensors.  Each op has a
sharding rule (``runtime.sharding.on_shards``): its tensors may stay sharded on the
batch dim and on one independent dim (heads; rglru's features), on the
same mesh axes in every input, and each other dim is gathered first.  The
hand kernel (or, on the CPU, its plain version) then runs on each rank's
local shard, and the op's backward (its route's) on the same shards;
flash-attention's log-sum-exp is sharded as its output.  Heads stay
sharded only when the kv heads are sharded on the same axis (each local q
head then finds its kv head, ``h // G``, in the local shard), so a GQA
layout with ``num_kv_heads`` indivisible by the axis, or K/V sharded on
sequence, is gathered to replicated heads first.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import ref as R
from repro_torch.kernels.flash_attention import (bwd_route,
                                                 flash_attention_bwd,
                                                 flash_attention_fwd)
from repro_torch.kernels.flash_decode import flash_decode_fwd
from repro_torch.kernels.mlstm import mlstm_fwd
from repro_torch.kernels.rglru import rglru_fwd
from repro_torch.kernels.rmsnorm import rmsnorm_fwd
from repro_torch.runtime import trace
from repro_torch.runtime.sharding import on_shards


def _meshed(*ts) -> bool:
    from torch.distributed.tensor import DTensor
    return any(isinstance(t, DTensor) for t in ts)


def _vjp(fn, inputs, grads):
    """Gradients of ``fn(*inputs)`` against ``grads``, recomputed from
    detached copies of ``inputs``: the backward of every op here."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_() for t in inputs]
        return torch.autograd.grad(fn(*xs), xs, grads)


def _define(name: str, schema: str, *, cpu, cuda, fake, flops,
            backward=None):
    """Register ``repro_torch::name``: its CPU and CUDA implementations,
    its fake implementation (which also serves the meta device, and
    refuses every device without a kernel), its flop formula and, given
    the plain math ``backward(*tensors, *args)``, its gradient, which runs
    in the tracer's span ``kernels.<name>.bwd`` (``runtime/trace.py``)
    with the attribute ``route="plain"``.  The schema lists the tensors
    first.  Returns the operator."""
    qual = f"repro_torch::{name}"
    torch.library.define(qual, schema)
    torch.library.impl(qual, "cpu", cpu)
    torch.library.impl(qual, "cuda", cuda)

    def checked_fake(*args):
        if args[0].device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name}: no kernel for device {args[0].device}")
        return fake(*args)
    torch.library.register_fake(qual, checked_fake)
    op = getattr(torch.ops.repro_torch, name)
    register_flop_formula(op)(flops)
    if backward is not None:
        def setup_context(ctx, inputs, output):
            n = sum(isinstance(x, torch.Tensor) for x in inputs)
            ctx.save_for_backward(*inputs[:n])
            ctx.args = inputs[n:]

        bwd = f"kernels.{name}.bwd"

        def grad(ctx, g):
            with trace.span(bwd, route="plain"):
                return (*_vjp(lambda *ts: backward(*ts, *ctx.args),
                              ctx.saved_tensors, g), *[None] * len(ctx.args))
        torch.library.register_autograd(qual, grad,
                                        setup_context=setup_context)
    return op.default


def attention_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(q, k) pairs the mask keeps, q and k both at positions 0, 1, ...:
    each query sees the last ``min(i + 1, span)`` keys."""
    if not causal:
        return Sq * Sk
    span = min(Sk, window) if window else Sk
    n = min(Sq, span)                  # rows 0 .. n-1 see i + 1 keys
    return n * (n + 1) // 2 + (Sq - n) * span


def mlstm_flops(S: int, dh: int, chunk: int) -> int:
    """One (b, h)'s products in the mlstm kernel's chunks of ``chunk``
    rows: q k^T and P v in each chunk, q C from the second chunk on (the
    first has no state), the state update up to the last."""
    flops = 0
    for t0 in range(0, S, chunk):
        cl = min(chunk, S - t0)
        flops += 4 * cl * cl * dh
        if t0:
            flops += 2 * cl * dh * dh
        if t0 + chunk < S:
            flops += 2 * cl * dh * dh
    return flops


#: the mlstm kernel's chunk (csrc/mlstm.cu)
MLSTM_KERNEL_CHUNK = 64


# --- flash attention -----------------------------------------------------------

def _heads_first(*ts):
    return [t.transpose(1, 2) for t in ts]


def _fa_cuda(q, k, v, causal, window, block_q):
    out, lse = flash_attention_fwd(*_heads_first(q, k, v), causal=causal,
                                   window=window, return_lse=True)
    return out.transpose(1, 2), lse


def _fa_cpu(q, k, v, causal, window, block_q):
    out, lse = R.flash_attention_ref(*_heads_first(q, k, v), causal=causal,
                                     window=window, return_lse=True)
    return out.transpose(1, 2), lse


def _fa_plain(q, k, v, causal, window, block_q):
    """The plain backward's math: the reference's ``_ref``, the q-chunked
    plain attention at the clause's ``block_q``.  That path is causal only
    (the reference's ``_ref`` is causal whatever it is asked); a non-causal
    call differentiates ``ref.flash_attention_ref`` instead, on every
    device."""
    if not causal:
        return R.flash_attention_ref(*_heads_first(q, k, v), causal=False,
                                     window=window).transpose(1, 2)
    from repro_torch.models.attention import chunked_attention
    pos_q = torch.arange(q.shape[1], device=q.device)
    pos_k = torch.arange(k.shape[1], device=q.device)
    return chunked_attention(q, k, v, pos_q=pos_q, pos_k=pos_k,
                             window=window, q_chunk=block_q)


def _fa_fake(q, *args):
    B, S, H, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, H, S), dtype=torch.float32)


def _fa_flops(q_shape, k_shape, v_shape, causal, window, block_q, *args,
              **kwargs):
    B, S, H, D = q_shape
    return 4 * B * H * D * attention_pairs(S, k_shape[1], causal, window)


_FLASH_ATTENTION = _define(
    "flash_attention", "(Tensor q, Tensor k, Tensor v, bool causal, "
    "int window, int block_q) -> (Tensor, Tensor)", cpu=_fa_cpu,
    cuda=_fa_cuda, fake=_fa_fake, flops=_fa_flops)


def _fa_bwd_cuda(dout, q, k, v, out, lse, causal, window):
    # the cotangent comes from autograd in any layout (expanded, say)
    dq, dk, dv = flash_attention_bwd(
        *_heads_first(dout.contiguous(), q, k, v, out), lse, causal=causal,
        window=window)
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


def _fa_bwd_cpu(dout, q, k, v, out, lse, causal, window):
    """The kernel's arithmetic in plain f32 (``ref.flash_attention_bwd_ref``);
    the op's gradient on the CPU is the plain route's, not this."""
    dq, dk, dv = R.flash_attention_bwd_ref(
        *_heads_first(dout, q, k, v, out), lse, causal=causal, window=window)
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


def _fa_bwd_flops(dout_shape, q_shape, k_shape, v_shape, o_shape,
                  lse_shape, causal, window, *args, **kwargs):
    """The backward kernel's five products (S and dP recomputed, dV, dK,
    dQ) over the pairs the mask keeps: 2.5 times the forward's."""
    B, S, H, D = q_shape
    return 10 * B * H * D * attention_pairs(S, k_shape[1], causal, window)


def _fa_bwd_fake(dout, q, k, v, *args):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


_FLASH_ATTENTION_BWD = _define(
    "flash_attention_bwd", "(Tensor dout, Tensor q, Tensor k, Tensor v, "
    "Tensor out, Tensor lse, bool causal, int window) -> "
    "(Tensor, Tensor, Tensor)", cpu=_fa_bwd_cpu, cuda=_fa_bwd_cuda,
    fake=_fa_bwd_fake, flops=_fa_bwd_flops)


def _fa_setup(ctx, inputs, output):
    """The gradient's route, from what the forward saw; the output and its
    log-sum-exp (not differentiable) are saved only for the kernel.  A
    fake tensor's route is the card's: the dry run counts the backward its
    program will run there."""
    from torch._subclasses.fake_tensor import FakeTensor
    q, k, v, *ctx.args = inputs
    device = "cuda" if isinstance(q, FakeTensor) else q.device.type
    ctx.route = bwd_route(q.dtype, q.shape[-1], device)
    ctx.save_for_backward(q, k, v,
                          *(output if ctx.route != "plain" else ()))
    ctx.mark_non_differentiable(output[1])


def _fa_grad(ctx, g, _):
    q, k, v, *saved = ctx.saved_tensors
    causal, window, block_q = ctx.args
    with trace.span("kernels.flash_attention.bwd", route=ctx.route):
        if ctx.route == "plain":
            grads = _vjp(lambda *ts: _fa_plain(*ts, causal, window,
                                               block_q), (q, k, v), g)
        else:
            grads = _FLASH_ATTENTION_BWD(g, q, k, v, *saved, causal, window)
    return (*grads, None, None, None)


torch.library.register_autograd("repro_torch::flash_attention", _fa_grad,
                                setup_context=_fa_setup)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    block_q: int = 512, block_k: int = 1024):
    """Model layout: q (B,S,H,D); k/v (B,S,KV,D) -> (B,S,H,D).

    ``block_q``/``block_k`` are the clause's tile fields; the CUDA kernels
    use their own tiles and the plain version none, so neither reads them.
    The gradient is the backward kernel where ``bwd_route`` says
    ``"wgmma"``, else the plain chunked attention's at ``block_q``.  The
    op's log-sum-exp output (B,H,S) is kept for the backward and not
    returned.
    """
    if _meshed(q, k, v):
        bh = (0, 2)
        return on_shards(lambda *t: list(_FLASH_ATTENTION(*t, causal, window,
                                                          block_q)),
                          [q, k, v], [bh] * 3, [bh, (0, 1)])[0]
    return _FLASH_ATTENTION(q, k, v, causal, window, block_q)[0]


# --- flash decode --------------------------------------------------------------

def _fd_cuda(q, k_cache, v_cache, pos, return_lse):
    out = flash_decode_fwd(q, k_cache.transpose(1, 2),
                           v_cache.transpose(1, 2), pos,
                           return_lse=return_lse)
    return list(out) if return_lse else [out]


def _fd_cpu(q, k_cache, v_cache, pos, return_lse):
    out = R.flash_decode_ref(q, k_cache, v_cache, pos, return_lse=return_lse)
    return list(out) if return_lse else [out]


def _fd_fake(q, k_cache, v_cache, pos, return_lse):
    out = [torch.empty_like(q)]
    if return_lse:
        out.append(q.new_empty(q.shape[:2], dtype=torch.float32))
    return out


def _fd_flops(q_shape, k_shape, v_shape, pos, return_lse, *args, **kwargs):
    B, H, D = q_shape
    return 4 * B * H * D * min(pos + 1, k_shape[1])


_FLASH_DECODE = _define(
    "flash_decode", "(Tensor q, Tensor k_cache, Tensor v_cache, int pos, "
    "bool return_lse) -> Tensor[]", cpu=_fd_cpu, cuda=_fd_cuda,
    fake=_fd_fake, flops=_fd_flops)


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
    if _meshed(q, k_cache, v_cache):
        out = on_shards(
            lambda *t: list(_FLASH_DECODE(*t, int(pos), return_lse)),
            [q, k_cache, v_cache], [(0, 1), (0, 2), (0, 2)],
            [(0, 1)] * (2 if return_lse else 1))
    else:
        out = _FLASH_DECODE(q, k_cache, v_cache, int(pos), return_lse)
    return tuple(out) if return_lse else out[0]


# --- rglru -------------------------------------------------------------------

_RGLRU = _define(
    "rglru", "(Tensor log_a, Tensor b) -> Tensor", cpu=R.rglru_ref,
    cuda=rglru_fwd, fake=lambda log_a, b: torch.empty_like(log_a),
    flops=lambda a_shape, *args, **kwargs: 3 * a_shape.numel(),
    backward=R.rglru_ref)


def rglru(log_a, b):
    """log_a, b: (B,S,dr) f32 -> h (B,S,dr) f32.  The CUDA kernel scans the
    whole sequence, so the clause's ``mlstm_chunk`` has no part here; the
    backward differentiates ``ref.rglru_ref``."""
    if _meshed(log_a, b):
        return on_shards(lambda *t: [_RGLRU(*t)], [log_a, b],
                          [(0, 2)] * 2, [(0, 2)])[0]
    return _RGLRU(log_a, b)


# --- mlstm -------------------------------------------------------------------

def _mlstm_plain(q, k, v, li, lf, chunk):
    return R.mlstm_chunkwise_ref(q, k, v, li, lf, chunk=chunk)


def _mlstm_flops(q_shape, *args, **kwargs):
    B, H, S, dh = q_shape
    return B * H * mlstm_flops(S, dh, MLSTM_KERNEL_CHUNK)


_MLSTM = _define(
    "mlstm_chunkwise", "(Tensor q, Tensor k, Tensor v, Tensor li, "
    "Tensor lf, int chunk) -> Tensor", cpu=_mlstm_plain,
    cuda=lambda q, k, v, li, lf, chunk: mlstm_fwd(q, k, v, li, lf),
    fake=lambda q, *args: torch.empty_like(q), flops=_mlstm_flops,
    backward=_mlstm_plain)


def mlstm_chunkwise(q, k, v, li, lf, *, chunk: int = 256):
    """q,k,v: (B,H,S,dh) f32 (q pre-scaled); li,lf: (B,H,S) -> (B,H,S,dh).

    ``chunk`` is the plain version's chunk (the clause's ``mlstm_chunk``),
    forward on the CPU and backward everywhere; the CUDA kernel uses its
    own 64-row chunks.
    """
    if _meshed(q, k, v, li, lf):
        return on_shards(lambda *t: [_MLSTM(*t, chunk)], [q, k, v, li, lf],
                          [(0, 1)] * 5, [(0, 1)])[0]
    return _MLSTM(q, k, v, li, lf, chunk)


# --- rmsnorm -----------------------------------------------------------------

_RMSNORM = _define(
    "rmsnorm", "(Tensor x2, Tensor scale, float eps) -> Tensor",
    cpu=R.rmsnorm_ref, cuda=lambda x2, scale, eps: rmsnorm_fwd(x2, scale,
                                                                eps=eps),
    fake=lambda x2, *args: torch.empty_like(x2),
    flops=lambda x_shape, *args, **kwargs: 4 * x_shape.numel(),
    backward=R.rmsnorm_ref)


def rmsnorm(x, scale, *, eps: float = 1e-6):
    """x: (..., d) -> RMSNorm of each row by ``scale`` (d,), in x's dtype.
    A standalone op: the models normalise with ``layers.norm_apply``."""
    shp = x.shape
    return _RMSNORM(x.reshape(-1, shp[-1]), scale, eps).reshape(shp)
