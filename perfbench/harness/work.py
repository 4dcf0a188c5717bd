"""Work counted from shapes, and the chip's published peaks.

The peaks are NVIDIA's H100 SXM data sheet (dense, at the full 700 W
power limit); a roofline share is stated against them with the card's
power limit beside it.  ``bound_s`` is ``chip_smoke.py``'s ``bound_ms``
in seconds: the larger of operations over the peak rate and bytes over
the HBM rate.  Model FLOPs count each product once per pass (forward 2,
backward 4 FLOPs per multiply-add and element) and never a
recomputation.
"""
from __future__ import annotations

from perfbench.harness.inputs import head_dim

HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
              "tf32": 495e12}
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_s(nbytes: float, ops: float, dtype: str):
    """(least seconds, "bytes" or "operations": which bound it)."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = ops / PEAK_OPS_S[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def attention_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(q, k) pairs the mask keeps, both at positions 0, 1, ...: query i
    sees the last ``min(i + 1, span)`` keys."""
    if not causal:
        return sq * sk
    span = min(sk, window) if window else sk
    n = min(sq, span)
    return n * (n + 1) // 2 + (sq - n) * span


def flash_attention_fwd(batch: int, heads: int, kv_heads: int, seq: int,
                        dim: int, window: int, dtype: str):
    """(FLOPs, bytes) of one causal flash-attention forward: Q K^T and
    P V over the kept pairs; q, k, v read once and o written once."""
    flops = 4 * batch * heads * dim * attention_pairs(seq, seq, True, window)
    elems = batch * seq * dim * (2 * heads + 2 * kv_heads)
    return flops, elems * DTYPE_BYTES[dtype]


def matmul_params(arch: dict) -> int:
    """Weights that enter a product per token: every layer's projections
    and FFN, and the head (tied or not); the embedding lookup is none."""
    d, H, KV, f = arch["d_model"], arch["num_heads"], arch["num_kv_heads"], \
        arch["d_ff"]
    D = head_dim(arch)
    layer = d * H * D * 2 + d * KV * D * 2 + d * f * (3 if arch["glu"] else 2)
    return arch["num_layers"] * layer + d * arch["vocab_size"]


def train_step_flops(arch: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step (forward and backward): 6 per
    product weight and token, plus the attention products over the kept
    pairs (4 per pair, head and dim forward, three times that with the
    backward)."""
    dense = 6 * matmul_params(arch) * batch * seq
    attn = 3 * 4 * batch * arch["num_layers"] * arch["num_heads"] * \
        head_dim(arch) * attention_pairs(seq, seq, True,
                                         arch["window_size"])
    return float(dense + attn)
