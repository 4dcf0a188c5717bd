"""Combination (provider x flags x clause) and GlobalKnobs: the plan's
per-segment and program-wide entries, as far as loading a plan needs.

``Combination.from_json`` reads plans written by the JAX package's sweep
unchanged: its clause ``kernel`` values ``"xla"`` and ``"pallas"`` map to
the port's ``"plain"`` and ``"cuda"``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet

from repro_torch.models.context import SegmentClause

#: the reference's clause ``kernel`` values -> the port's
KERNEL_FROM_REFERENCE = {"xla": "plain", "pallas": "cuda"}


@dataclass(frozen=True)
class Combination:
    """One point of the per-segment sweep."""
    provider: str
    flags: FrozenSet[str]
    clause: SegmentClause

    def label(self) -> str:
        fl = "+".join(sorted(self.flags)) or "-"
        return f"{self.provider}[{fl}]({self.clause.key()})"

    def to_json(self) -> Dict:
        return {"provider": self.provider, "flags": sorted(self.flags),
                "clause": vars(self.clause)}

    @classmethod
    def from_json(cls, d: Dict) -> "Combination":
        clause = dict(d["clause"])
        kernel = clause.get("kernel", "plain")
        clause["kernel"] = KERNEL_FROM_REFERENCE.get(kernel, kernel)
        return cls(d["provider"], frozenset(d["flags"]),
                   SegmentClause(**clause))


@dataclass(frozen=True)
class GlobalKnobs:
    """Program-wide knobs (ComPar's RTL-routine analogue)."""
    microbatches: int = 1
    donate: bool = True
    opt_state_dtype: str = "float32"
