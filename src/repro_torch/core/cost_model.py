"""Three-term roofline cost model, as the reference's
``src/repro/core/cost_model.py``, for the H100.

    compute_s    = FLOPs / (chips * peak_FLOP/s)
    memory_s     = bytes / (chips * HBM_bw)
    collective_s = collective_bytes_per_chip / link_bw

The dry-run executor scores every combination with these terms; the
plan generator minimizes ``max(compute, memory, collective)`` per
segment.  The math is the reference's; only the hardware constants are
the H100's (``H100``: the SXM data sheet, the constants
``chip_smoke.py``'s ``bound_ms`` uses).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.combinator import require_meshless


@dataclass(frozen=True)
class Hardware:
    name: str = "h100-sxm"
    peak_flops: float = 989e12          # dense bf16 tensor-core FLOP/s
    hbm_bw: float = 3.35e12             # HBM3 bytes/s
    #: NVLink bytes/s per direction and inter-node bytes/s: unused while
    #: the port is meshless (every collective term is 0)
    link_bw: float = 450e9
    hbm_bytes: float = 80e9             # HBM capacity
    dcn_bw: float = 50e9


#: NVIDIA H100 SXM (data sheet, dense)
H100 = Hardware()


@dataclass
class CostTerms:
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    bytes_per_device: float = 0.0       # peak memory from memory_analysis
    detail: Dict[str, float] = field(default_factory=dict)

    @property
    def total_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def as_dict(self) -> Dict[str, float]:
        out = {"compute_s": self.compute_s, "memory_s": self.memory_s,
               "collective_s": self.collective_s, "flops": self.flops,
               "bytes_accessed": self.bytes_accessed,
               "collective_bytes": self.collective_bytes,
               "bytes_per_device": self.bytes_per_device,
               "total_s": self.total_s}
        if self.detail:
            # keep the per-op detail on the wire: process workers ship
            # scores as dicts, and dropping detail there would make thread
            # and process sweeps record different rows
            out["detail"] = dict(self.detail)
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, float]) -> "CostTerms":
        return cls(compute_s=d.get("compute_s", 0.0),
                   memory_s=d.get("memory_s", 0.0),
                   collective_s=d.get("collective_s", 0.0),
                   flops=d.get("flops", 0.0),
                   bytes_accessed=d.get("bytes_accessed", 0.0),
                   collective_bytes=d.get("collective_bytes", 0.0),
                   bytes_per_device=d.get("bytes_per_device", 0.0),
                   detail=dict(d.get("detail") or {}))


def terms_from_analysis(flops: float, bytes_accessed: float,
                        coll_bytes_per_chip: float, n_chips: int,
                        hw: Hardware = H100,
                        bytes_per_device: float = 0.0) -> CostTerms:
    """cost_analysis() totals are whole-program; divide by chip count."""
    return CostTerms(
        compute_s=flops / (n_chips * hw.peak_flops),
        memory_s=bytes_accessed / (n_chips * hw.hbm_bw),
        collective_s=coll_bytes_per_chip / hw.link_bw,
        flops=flops, bytes_accessed=bytes_accessed,
        collective_bytes=coll_bytes_per_chip,
        bytes_per_device=bytes_per_device)


# --- pruning lower bound -----------------------------------------------------
#
# ``combo_lower_bound`` is a *certified underestimate* of the score the
# Executor would produce for (segment, combination): it counts only matmul
# FLOPs and weight bytes that are guaranteed to appear as matrix products
# (projection and dense-FFN matmuls; attention score matmuls and MoE
# expert matmuls are deliberately omitted — omission keeps the bound
# sound).  The sweep engine skips a combination whose bound already
# exceeds the segment's incumbent best: since bound <= true score, a
# pruned combination can never be the argmin, so pruning is exact.

#: minimum fwd+bwd dot-FLOP multiple of the forward pass, per remat mode
#: (bwd = dgrad + wgrad = 2x fwd dots; full remat re-runs the forward).
REMAT_FLOP_MULT = {"none": 3.0, "dots": 3.0, "full": 4.0}

#: guaranteed distinct-weight re-read count per training step, per remat
#: mode, for stack segments (fwd read + wgrad read; full remat streams
#: the weights a third time for the backward replay).
REMAT_WEIGHT_READS = {"none": 2.0, "dots": 2.0, "full": 3.0}

_DTYPE_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4,
                   "float8_e4m3fn": 1, "float8_e5m2": 1}


def _itemsize(dtype: str) -> int:
    n = _DTYPE_ITEMSIZE.get(dtype)
    if n is None:
        import numpy as np
        n = int(np.dtype(dtype).itemsize)
    return n


def _block_proj_elems(cfg: ArchConfig, kind: str):
    """``(proj_elems, extra_fwd_flops_per_token)`` for one block.

    ``proj_elems`` counts weight elements of the dense ``x @ W``
    projections guaranteed to lower as HLO dots applied once per token:
    forward dot FLOPs are exactly ``2 * tokens * proj_elems`` and every
    element is streamed at least once per pass, so one number certifies
    both the FLOP and the weight-byte floor.  ``extra`` is additional
    guaranteed per-token forward dot FLOPs whose weights are re-read
    once per *scan step* rather than once per token (the sLSTM
    recurrent cell): they tighten the FLOP floor but MUST NOT enter the
    weight-byte floor — ``flops / 2`` would overestimate their unique
    weight traffic by the batch factor, breaking soundness.

    Dimension guards mirror the model's asserts (``mlstm_dims`` /
    ``slstm_dims``): a config those would reject returns zero floors
    instead of raising — the bound must never fail where scoring would
    merely record a failed combination.
    """
    d = cfg.d_model
    if kind.startswith("attn"):
        dh = cfg.head_dim_
        elems = (d * cfg.num_heads * dh            # wq
                 + 2.0 * d * cfg.num_kv_heads * dh  # wk + wv
                 + cfg.num_heads * dh * d)          # wo
        if kind == "attn" and cfg.d_ff:             # dense FFN (MoE: omitted)
            elems += (3 if cfg.glu else 2) * d * cfg.d_ff
        return elems, 0.0
    if kind == "rec":
        dr = int(cfg.expand_factor * d)
        # w_gate + w_x, w_a + w_i (full-sequence, outside the rglru scan),
        # w_out, then the block's dense FFN
        elems = 2.0 * d * dr + 2.0 * dr * dr + dr * d
        if cfg.d_ff:
            elems += (3 if cfg.glu else 2) * d * cfg.d_ff
        return elems, 0.0
    if kind == "mlstm":
        di = int(cfg.expand_factor * d)
        if di % cfg.num_heads:
            return 0.0, 0.0
        # w_up, wq/wk/wv ("bsi,ihd->bhsd", full-sequence), w_if, w_down
        elems = (d * 2.0 * di + 3.0 * di * di
                 + d * 2.0 * cfg.num_heads + di * d)
        return elems, 0.0
    if kind == "slstm":
        H = cfg.num_heads
        if d % H:
            return 0.0, 0.0
        dh = d // H
        ff = max(64, int(round(d * 4 / 3 / 64)) * 64)
        # zx gate projection ("bsd,dghe->bsghe" with 4*H*dh == 4d) + FFN
        elems = 4.0 * d * d + d * 2.0 * ff + ff * d
        # recurrent zr einsum ("bhe,hged->bghd") inside lax.scan: 2 FLOPs
        # per element of r=(H,4,dh,dh) per token, weights reused across
        # the batch each step
        extra = 8.0 * H * dh * dh
        return elems, extra
    return 0.0, 0.0


def _block_fwd_flops_per_token(cfg: ArchConfig, kind: str) -> float:
    """Guaranteed-present forward dot FLOPs per token for one block."""
    proj, extra = _block_proj_elems(cfg, kind)
    return 2.0 * proj + extra


def segment_forward_flops(cfg: ArchConfig, shape: ShapeConfig,
                          segment) -> float:
    """Lower bound on one forward pass's dot FLOPs through a segment."""
    tokens = shape.global_batch if shape.kind == "decode" \
        else shape.global_batch * shape.seq_len
    if segment.kind == "embed":
        return 0.0                               # a gather, not a dot
    if segment.kind == "head":
        return 2.0 * tokens * cfg.d_model * cfg.vocab_size
    per_super = sum(_block_fwd_flops_per_token(cfg, k)
                    for k in segment.pattern)
    return tokens * per_super * segment.repeats


def segment_weight_elems(cfg: ArchConfig, segment) -> float:
    """Certified count of distinct dot-operand weight elements in one
    segment.  Feeds the memory-traffic floor; float32 masters (rglru
    ``w_a``/``w_i``, sLSTM gates) are counted at ``cfg.dtype`` itemsize
    — underestimating traffic keeps the floor sound."""
    if segment.kind == "embed":
        return 0.0              # the table is gathered, not streamed as a dot
    if segment.kind == "head":
        return float(cfg.d_model) * cfg.vocab_size
    per_super = sum(_block_proj_elems(cfg, k)[0] for k in segment.pattern)
    return per_super * segment.repeats


def combo_lower_bound(cfg: ArchConfig, shape: ShapeConfig, segment,
                      combo, n_chips: int = 1, hw: Hardware = H100,
                      knobs=None, mesh_axes=None,
                      kernel_flops: float = 0.0) -> float:
    """Certified roofline lower bound (seconds) on scoring
    (segment, combination) under one GlobalKnobs point, the reference's
    with the collective floor left out (the port is meshless, so
    ``mesh_axes`` takes only ``None``).

    * **compute**: guaranteed dot FLOPs (projections and dense FFN) times
      the remat fwd+bwd multiple, plus ``kernel_flops`` once, over peak
      FLOP/s.
    * **memory**: distinct dot-operand weight bytes times the guaranteed
      re-read count (times ``knobs.microbatches`` on train shapes), over
      HBM bandwidth.

    The bound divides by the same ``hw`` the dry-run scorer divides by,
    so ``bound <= score`` holds whatever the constants.
    """
    require_meshless(mesh_axes, "mesh_axes")
    fwd = segment_forward_flops(cfg, shape, segment)
    if shape.kind != "train":
        mult = 1.0
    elif segment.kind == "stack":               # remat wraps stack blocks only
        mult = REMAT_FLOP_MULT.get(combo.clause.remat, 1.0)
    else:
        mult = 3.0                              # plain fwd + bwd
    compute_s = (fwd * mult + max(0.0, kernel_flops)) \
        / (n_chips * hw.peak_flops)

    itemsize = _itemsize(cfg.dtype)
    welems = segment_weight_elems(cfg, segment)
    memory_s = 0.0
    if welems:
        if shape.kind == "train":
            reads = REMAT_WEIGHT_READS.get(combo.clause.remat, 1.0) \
                if segment.kind == "stack" else 2.0
            mb = getattr(knobs, "microbatches", 1) if knobs is not None else 1
            reads *= max(1, int(mb))
        else:
            reads = 1.0
        memory_s = welems * itemsize * reads / (n_chips * hw.hbm_bw)
    return max(compute_s, memory_s)


# --- analytic MODEL_FLOPS (the "useful compute" yardstick) -------------------

def active_params(cfg: ArchConfig) -> int:
    """Parameters touched per token (MoE: top-k experts only)."""
    from repro_torch.models.model import model_specs
    from repro_torch.models.params import param_count
    total = param_count(model_specs(cfg))
    if not cfg.is_moe:
        return total
    # subtract the inactive expert fraction
    from repro_torch.models.moe import moe_specs
    per_layer_expert = sum(
        math.prod(s.shape) for k, s in moe_specs(cfg).items()
        if k in ("wi", "wg", "wo"))
    n_moe_layers = cfg.num_layers - cfg.first_k_dense
    inactive_frac = 1.0 - cfg.experts_per_token / cfg.num_experts
    return int(total - n_moe_layers * per_layer_expert * inactive_frac)


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """6*N*D for training, 2*N*D for inference forward (N = active params).

    For decode shapes D = global_batch tokens (one step).
    """
    n = active_params(cfg)
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n * tokens
    tokens = shape.global_batch                     # decode: one token each
    flops = 2.0 * n * tokens
    # attention reads of the KV cache dominate decode compute for dense archs
    kinds = cfg.block_kinds()
    n_attn = sum(1 for k in kinds if k.startswith("attn"))
    ctx_len = min(shape.seq_len, cfg.window_size) if cfg.window_size \
        else shape.seq_len
    flops += 4.0 * tokens * n_attn * cfg.num_heads * cfg.head_dim_ * ctx_len
    return flops
