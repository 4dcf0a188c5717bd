"""Parallelization plans: per-segment Combination + global knobs.

A :class:`Plan` is ComParX's "output program": the sweep fuses one
(``core/tuner.py``, ``core/fusion.py``), and the step factories apply it:
each segment gets its clause and its provider's sharding rules on the
mesh (``runtime/sharding.py``), as the reference's
``src/repro/core/plan.py``.  ``Plan.lint`` certifies a plan with the
static analyzer (``repro_torch.analysis``).
"""
from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.core.combinator import Combination, GlobalKnobs
from repro_torch.core.meshspec import MeshSpec
from repro_torch.core.providers import get_provider
from repro_torch.core.segment import fragment
from repro_torch.models.context import ModelContext, SegmentClause
from repro_torch.runtime.sharding import Rules, mesh_axis_sizes

log = logging.getLogger("repro_torch.plan")


@dataclass
class Plan:
    segments: Dict[str, Combination]
    knobs: GlobalKnobs = field(default_factory=GlobalKnobs)
    meta: Dict[str, object] = field(default_factory=dict)
    #: the mesh point the plan was fused for: ``None`` unswept, else the
    #: point ``fuse_joint`` chose from a swept ``mesh_space``
    mesh: Optional[MeshSpec] = None

    def to_json(self) -> Dict:
        return {"segments": {k: c.to_json() for k, c in self.segments.items()},
                "knobs": self.knobs.to_json(), "meta": self.meta,
                "mesh": self.mesh.to_json() if self.mesh is not None
                else None}

    @classmethod
    def from_json(cls, d: Dict) -> "Plan":
        return cls({k: Combination.from_json(v)
                    for k, v in d["segments"].items()},
                   GlobalKnobs(**d["knobs"]), d.get("meta", {}),
                   MeshSpec.from_json(d["mesh"]) if d.get("mesh") else None)

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "Plan":
        with open(path) as f:
            return cls.from_json(json.load(f))

    def lint(self, cfg: ArchConfig, shape, *, trace: bool = True):
        """Certify this plan against ``(cfg, shape)`` without running it.

        Thin wrapper over :func:`repro_torch.analysis.analyze_plan`:
        returns the list of ``Diagnostic``; empty means the plan passes
        every static rule."""
        from repro_torch.analysis import analyze_plan
        return analyze_plan(cfg, shape, self, trace=trace)

    def describe(self) -> str:
        lines = [f"knobs: {self.knobs.key()}"]
        if self.mesh is not None:
            lines.insert(0, f"mesh: {self.mesh.key()}")
        for seg, c in sorted(self.segments.items()):
            lines.append(f"  {seg:8s} -> {c.label()}")
        return "\n".join(lines)


def uniform_plan(cfg: ArchConfig, provider: str,
                 flags=frozenset(), clause: Optional[SegmentClause] = None,
                 knobs: Optional[GlobalKnobs] = None) -> Plan:
    """Single-provider plan: one combination for every segment."""
    clause = clause or SegmentClause()
    combo = Combination(provider, frozenset(flags), clause)
    return Plan({s.name: combo for s in fragment(cfg)},
                knobs or GlobalKnobs())


def dp_shards(mesh) -> int:
    """Number of data-parallel shards (pod x data axes)."""
    sizes = mesh_axis_sizes(mesh)
    return sizes.get("pod", 1) * sizes.get("data", 1)


def build_contexts(cfg: ArchConfig, plan: Plan,
                   mesh=None) -> Dict[str, ModelContext]:
    """Apply a plan: per segment, a ModelContext with its clause and its
    provider's rules on ``mesh`` (which resolve nothing without one), and
    ``moe_groups = dp_shards(mesh)``.

    A plan missing a segment gets that segment's context from the plan's
    first combination, logged and recorded in ``plan.meta``.
    """
    axis_sizes = mesh_axis_sizes(mesh)
    groups = dp_shards(mesh)
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
        mapping = get_provider(combo.provider).mapping(
            cfg, axis_sizes, combo.flags, seg)
        ctxs[seg.name] = ModelContext(rules=Rules(mapping, mesh),
                                      clause=combo.clause, moe_groups=groups)
    if substituted:
        plan.meta.setdefault("substituted_segments", {}).update(substituted)
    return ctxs


def segment_rules(cfg: ArchConfig, plan: Plan, mesh=None) -> Dict[str, Rules]:
    return {k: c.rules for k, c in build_contexts(cfg, plan, mesh).items()}
