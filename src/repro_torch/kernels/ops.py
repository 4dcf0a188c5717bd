"""Model-layout adapters around the kernels (forward only so far).

Dispatch is on the tensor's device and nothing else: a CUDA tensor goes to
the hand-written kernel (a failed build or launch raises), a CPU tensor to
the kernel's plain version in ``kernels/ref.py``.  The backward through
plain math (the reference's ``custom_vjp``) comes with training.
"""
from __future__ import annotations

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


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    block_q: int = 512, block_k: int = 1024):
    """Model layout: q (B,S,H,D); k/v (B,S,KV,D) -> (B,S,H,D).

    ``block_q``/``block_k`` are the clause's tile fields; the CUDA kernel
    uses its own tiles and the plain version none, so neither reads them.
    """
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if _route("flash_attention", q):
        o = flash_attention_fwd(qh, kh, vh, causal=causal, window=window)
    else:
        o = R.flash_attention_ref(qh, kh, vh, causal=causal, window=window)
    return o.transpose(1, 2)


def flash_decode(q, k_cache, v_cache, pos: int, *, block_k: int = 1024,
                 return_lse: bool = False):
    """Model layout: q (B,H,D); caches (B,Smax,KV,D); scalar ``pos``.

    ``block_k`` is the clause's field; the CUDA kernel splits Smax into its
    own chunks.
    """
    if _route("flash_decode", q):
        return flash_decode_fwd(q, k_cache.transpose(1, 2),
                                v_cache.transpose(1, 2), pos,
                                return_lse=return_lse)
    return R.flash_decode_ref(q, k_cache, v_cache, pos,
                              return_lse=return_lse)


def rglru(log_a, b):
    """log_a, b: (B,S,dr) f32 -> h (B,S,dr) f32.  The CUDA kernel scans the
    whole sequence, so the clause's ``mlstm_chunk`` has no part here."""
    if _route("rglru", log_a):
        return rglru_fwd(log_a, b)
    return R.rglru_ref(log_a, b)


def mlstm_chunkwise(q, k, v, li, lf, *, chunk: int = 256):
    """q,k,v: (B,H,S,dh) f32 (q pre-scaled); li,lf: (B,H,S) -> (B,H,S,dh).

    ``chunk`` is the plain version's chunk (the clause's ``mlstm_chunk``);
    the CUDA kernel uses its own 64-row chunks.
    """
    if _route("mlstm", q):
        return mlstm_fwd(q, k, v, li, lf)
    return R.mlstm_chunkwise_ref(q, k, v, li, lf, chunk=chunk)


def rmsnorm(x, scale, *, eps: float = 1e-6):
    """x: (..., d) -> RMSNorm of each row by ``scale`` (d,), in x's dtype.
    A standalone op: the models normalise with ``layers.norm_apply``."""
    shp = x.shape
    x2 = x.reshape(-1, shp[-1])
    if _route("rmsnorm", x):
        return rmsnorm_fwd(x2, scale, eps=eps).reshape(shp)
    return R.rmsnorm_ref(x2, scale, eps).reshape(shp)
