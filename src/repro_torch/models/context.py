"""Execution context threaded through model apply functions.

``SegmentClause`` is the per-segment clause set a plan carries (the OpenMP
``parallel for`` clause analogue).  It keeps every field of the reference's
clause so plan JSON round-trips between the two packages; ``kernel`` takes
``"plain"`` (PyTorch ops) or ``"cuda"`` (the hand-written kernels in
``repro_torch.kernels``).

``ModelContext`` has no sharding rules and no interpret flag: this port is
meshless so far, and a CUDA kernel has no interpret mode.  ``moe_groups``
is the reference's GShard dispatch-group count; meshless it is 1, as the
reference's ``dp_shards(None)``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

KERNELS = ("plain", "cuda")


@dataclass(frozen=True)
class SegmentClause:
    remat: str = "none"          # none | dots | full
    kernel: str = "plain"        # plain | cuda
    block_q: int = 512           # q-chunk of the plain chunked attention
    block_k: int = 1024          # k-block (kept for plan round-trips)
    scan_unroll: int = 1         # layer-loop unroll (no effect in PyTorch)
    mlstm_chunk: int = 256       # chunk length for mLSTM / linear recurrence
    moe_dispatch: str = "sorted"  # sorted | a2a
    cache_upcast: bool = True     # f32-upcast KV reads in plain decode
    decode_shardmap: bool = False  # seq-sharded KV decode (multi-device)

    def __post_init__(self):
        if self.kernel not in KERNELS:
            raise ValueError(f"kernel={self.kernel!r}; expected one of "
                             f"{KERNELS}")

    def key(self) -> str:
        return (f"remat={self.remat},kernel={self.kernel},bq={self.block_q},"
                f"bk={self.block_k},unroll={self.scan_unroll},"
                f"mc={self.mlstm_chunk},md={self.moe_dispatch},"
                f"cu={int(self.cache_upcast)},"
                f"dsm={int(self.decode_shardmap)}")


@dataclass(frozen=True)
class ModelContext:
    clause: SegmentClause = SegmentClause()
    moe_groups: int = 1          # GShard-style dispatch groups
    decode: bool = False

    def with_(self, **kw) -> "ModelContext":
        return replace(self, **kw)
