"""Fragmentor: enumerate and annotate the segments of a model (embed, one
per scan group, head), as the reference's ``src/repro/core/segment.py``.

A segment is the sweep's tuning unit: the sweep scores every combination
on every segment, and structurally identical segments share one
signature and so one score.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass
from typing import FrozenSet, Tuple

from repro_torch.configs.base import ArchConfig, ShapeConfig


@dataclass(frozen=True)
class Segment:
    name: str                       # "embed", "g0", ..., "head"
    kind: str                       # embed | stack | head
    pattern: Tuple[str, ...] = ()   # block kinds for stack segments
    repeats: int = 1

    @property
    def has_moe(self) -> bool:
        return any(k == "attn_moe" for k in self.pattern)

    @property
    def has_attn(self) -> bool:
        return any(k.startswith("attn") for k in self.pattern)

    @property
    def has_recurrent(self) -> bool:
        return any(k in ("rec", "mlstm", "slstm") for k in self.pattern)

    @property
    def num_layers(self) -> int:
        return len(self.pattern) * self.repeats

    def to_json(self) -> dict:
        return {"name": self.name, "kind": self.kind,
                "pattern": list(self.pattern), "repeats": self.repeats}

    @classmethod
    def from_json(cls, d: dict) -> "Segment":
        return cls(d["name"], d["kind"], tuple(d.get("pattern") or ()),
                   int(d.get("repeats", 1)))

    def signature(self, cfg: ArchConfig, shape: ShapeConfig) -> str:
        """Content signature of everything that reaches ``segment_program``
        besides the combination.  ``cfg.name`` is left out: two configs
        with the same fields build the same program.  The port's
        ``ArchConfig`` is a field-for-field copy of the reference's, so
        the signature equals the reference's."""
        arch = dataclasses.asdict(cfg)
        arch.pop("name", None)
        blob = json.dumps(
            {"kind": self.kind, "pattern": list(self.pattern),
             "repeats": self.repeats, "arch": arch,
             "shape": {"kind": shape.kind, "seq_len": shape.seq_len,
                       "global_batch": shape.global_batch}},
            sort_keys=True, default=str)
        return hashlib.sha1(blob.encode()).hexdigest()[:16]

    def relevant_clause_fields(self, shape_kind: str) -> FrozenSet[str]:
        """The SegmentClause fields that can alter this segment's program
        (over-inclusive: an extra field only costs cache sharing)."""
        if self.kind != "stack":
            return frozenset()
        fields = {"remat", "scan_unroll"}
        if self.has_attn:
            fields |= {"kernel", "block_q", "block_k"}
            if shape_kind == "decode":
                fields |= {"cache_upcast", "decode_shardmap"}
        if self.has_moe:
            fields.add("moe_dispatch")
        if self.has_recurrent:
            fields |= {"kernel", "mlstm_chunk"}
        return frozenset(fields)

    def relevant_knob_fields(self, shape_kind: str) -> FrozenSet[str]:
        """The GlobalKnobs fields that can alter this segment's program.

        ``microbatches`` and ``donate`` shape every train program;
        inference shapes take no knob.  ``opt_state_dtype`` reaches no
        segment program (the optimizer update is not part of one)."""
        if shape_kind != "train":
            return frozenset()
        return frozenset({"microbatches", "donate"})


def fragment(cfg: ArchConfig) -> Tuple[Segment, ...]:
    """Enumerate all segments (the Fragmentor)."""
    segs = [Segment("embed", "embed")]
    for gi, group in enumerate(cfg.stack_plan()):
        segs.append(Segment(f"g{gi}", "stack", tuple(group.pattern),
                            group.repeats))
    segs.append(Segment("head", "head"))
    return tuple(segs)


def stack_segments(cfg: ArchConfig) -> Tuple[Segment, ...]:
    return tuple(s for s in fragment(cfg) if s.kind == "stack")
