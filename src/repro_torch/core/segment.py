"""Fragmentor: the segments of a model (embed, one per scan group, head).

The port keeps only what loading and applying a plan needs; signatures and
clause relevance come with the sweep core (ROADMAP Queue 1 item 2).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from repro_torch.configs.base import ArchConfig


@dataclass(frozen=True)
class Segment:
    name: str                       # "embed", "g0", ..., "head"
    kind: str                       # embed | stack | head
    pattern: Tuple[str, ...] = ()   # block kinds for stack segments
    repeats: int = 1


def fragment(cfg: ArchConfig) -> Tuple[Segment, ...]:
    """Enumerate all segments (the Fragmentor)."""
    segs = [Segment("embed", "embed")]
    for gi, group in enumerate(cfg.stack_plan()):
        segs.append(Segment(f"g{gi}", "stack", tuple(group.pattern),
                            group.repeats))
    segs.append(Segment("head", "head"))
    return tuple(segs)
