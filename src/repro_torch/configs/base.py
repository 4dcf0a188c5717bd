"""Architecture / shape configuration dataclasses.

The port's own copy of ``repro.configs.base`` (the port imports nothing of
``repro``): field for field the same, so a config serialized by either
package means the same model in the other.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ScanGroup:
    """A homogeneous, scannable group of blocks.

    ``pattern`` is the tuple of block kinds inside one super-block;
    ``repeats`` is how many times the super-block repeats (the scan
    length).  ``repeats == 1`` with a short pattern is simply unrolled.
    Block kinds: ``attn`` (attention + dense FFN), ``attn_moe``
    (attention + MoE FFN), ``rec`` (RG-LRU recurrent block + FFN),
    ``mlstm`` / ``slstm`` (xLSTM blocks, no separate FFN).
    """

    pattern: Tuple[str, ...]
    repeats: int

    @property
    def num_layers(self) -> int:
        return len(self.pattern) * self.repeats


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int                      # dense FFN hidden size (per-expert size for MoE)
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    first_k_dense: int = 0         # leading dense layers in an MoE stack
    moe_capacity_factor: float = 1.25
    # --- stack pattern (repeats to cover num_layers) ---
    block_pattern: Tuple[str, ...] = ("attn",)
    # --- attention details ---
    window_size: int = 0           # 0 = full causal; >0 = sliding window
    rope: str = "full"             # full | 2d | none
    # --- xLSTM / recurrent details ---
    expand_factor: float = 2.0     # internal expansion of mlstm/rec blocks
    conv_width: int = 4            # temporal conv width in rec/mlstm blocks
    # --- misc ---
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    act: str = "silu"              # silu | gelu
    glu: bool = True               # gated FFN (SwiGLU/GeGLU) vs plain MLP
    frontend: str = "none"         # none | patch | frame   (vlm/audio stubs)
    tie_embeddings: bool = False
    sub_quadratic: bool = False    # may run the long_500k shape
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        assert self.num_heads % self.num_kv_heads == 0
        return self.num_heads // self.num_kv_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def stack_plan(self) -> Tuple[ScanGroup, ...]:
        """Split the layer stack into scannable homogeneous groups."""
        groups = []
        n = self.num_layers
        pat = tuple(self.block_pattern)
        if self.is_moe:
            # first_k_dense leading dense layers, the rest MoE.
            if self.first_k_dense:
                groups.append(ScanGroup(("attn",) * self.first_k_dense, 1))
                n -= self.first_k_dense
            groups.append(ScanGroup(("attn_moe",), n))
            return tuple(groups)
        reps, rem = divmod(n, len(pat))
        if reps:
            groups.append(ScanGroup(pat, reps))
        if rem:
            groups.append(ScanGroup(pat[:rem], 1))
        return tuple(groups)

    def block_kinds(self) -> Tuple[str, ...]:
        """The flattened sequence of block kinds, length num_layers."""
        out = []
        for g in self.stack_plan():
            out.extend(g.pattern * g.repeats)
        assert len(out) == self.num_layers, (self.name, len(out), self.num_layers)
        return tuple(out)

    def smoke(self) -> "ArchConfig":
        """A tiny config of the same *family* for CPU smoke tests."""
        pat = tuple(self.block_pattern)
        num_layers = max(len(pat), 2) if not self.is_moe else 2 + self.first_k_dense
        kv = min(self.num_kv_heads, 2)
        heads = max(4 // max(1, 4 // max(self.q_per_kv * kv, 1)), kv)
        # keep the q/kv ratio >= 1 and divisibility
        heads = kv * max(1, min(self.q_per_kv, 2))
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=num_layers,
            d_model=64,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=16,
            d_ff=96 if self.d_ff else 0,
            vocab_size=128,
            num_experts=8 if self.is_moe else 0,
            experts_per_token=2 if self.is_moe else 0,
            window_size=16 if self.window_size else 0,
            conv_width=min(self.conv_width, 4),
            dtype="float32",
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    def smoke(self) -> "ShapeConfig":
        return ShapeConfig(self.name + "-smoke", 32, 4, self.kind)


# The four assigned LM shapes ------------------------------------------------
TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shape_applies(arch: ArchConfig, shape: ShapeConfig) -> bool:
    """long_500k needs sub-quadratic attention (assignment rule)."""
    if shape.name.startswith("long_") and not arch.sub_quadratic:
        return False
    return True
