"""Parallelization plans: per-segment Combination + global knobs.

The port loads and applies plans; it does not fuse them yet.  Without a
mesh there is no provider mapping to resolve, so applying a plan gives
each segment its clause.
"""
from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.core.combinator import Combination, GlobalKnobs
from repro_torch.core.segment import fragment
from repro_torch.models.context import ModelContext, SegmentClause

log = logging.getLogger("repro_torch.plan")


@dataclass
class Plan:
    segments: Dict[str, Combination]
    knobs: GlobalKnobs = field(default_factory=GlobalKnobs)
    meta: Dict[str, object] = field(default_factory=dict)
    #: the mesh point the plan was fused for, kept as its JSON so plans
    #: round-trip; the port applies plans without a mesh
    mesh: Optional[Dict] = None

    def to_json(self) -> Dict:
        return {"segments": {k: c.to_json() for k, c in self.segments.items()},
                "knobs": vars(self.knobs), "meta": self.meta,
                "mesh": self.mesh}

    @classmethod
    def from_json(cls, d: Dict) -> "Plan":
        return cls({k: Combination.from_json(v)
                    for k, v in d["segments"].items()},
                   GlobalKnobs(**d["knobs"]), d.get("meta", {}),
                   d.get("mesh"))

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "Plan":
        with open(path) as f:
            return cls.from_json(json.load(f))


def uniform_plan(cfg: ArchConfig, provider: str,
                 flags=frozenset(), clause: Optional[SegmentClause] = None,
                 knobs: Optional[GlobalKnobs] = None) -> Plan:
    """Single-provider plan: one combination for every segment."""
    clause = clause or SegmentClause()
    combo = Combination(provider, frozenset(flags), clause)
    return Plan({s.name: combo for s in fragment(cfg)},
                knobs or GlobalKnobs())


def build_contexts(cfg: ArchConfig, plan: Plan) -> Dict[str, ModelContext]:
    """Apply a plan: one meshless ModelContext per segment.

    A plan missing a segment gets that segment's context from the plan's
    first combination, logged and recorded in ``plan.meta``.
    """
    ctxs: Dict[str, ModelContext] = {}
    substituted: Dict[str, Dict[str, str]] = {}
    for seg in fragment(cfg):
        combo = plan.segments.get(seg.name)
        if combo is None:
            donor, combo = next(iter(plan.segments.items()))
            log.warning(
                "plan has no combination for segment %r; substituting %s "
                "from segment %r", seg.name, combo.label(), donor)
            substituted[seg.name] = {"from": donor, "combo": combo.label()}
        ctxs[seg.name] = ModelContext(clause=combo.clause)
    if substituted:
        plan.meta.setdefault("substituted_segments", {}).update(substituted)
    return ctxs
