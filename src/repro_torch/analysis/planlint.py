"""Plan-level lint: certify a fused plan post-fusion, as the reference's
``src/repro/analysis/planlint.py``.

Per segment, a fused plan is a set of sweep points, so every point-level
rule applies (``analyze_point`` with the plan's knobs).  The
cross-segment rule of the reference:

``boundary-reshard``  adjacent segments whose residual-stream partitions
                  differ under the plan's mesh, unpriced by a
                  per-segment-argmin fusion.  Meshless every partition is
                  trivial.                                         [warn]
``missing-segment``  the plan carries no combination for a segment of
                  this config; ``build_contexts`` will substitute another
                  segment's combination (loudly).                  [warn]
"""
from __future__ import annotations

from typing import List

from repro_torch.analysis.diagnostics import ERROR, WARN, Diagnostic
from repro_torch.analysis.rules import analyze_point, residual_pspec
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.plan import Plan
from repro_torch.core.segment import fragment


def analyze_plan(cfg: ArchConfig, shape: ShapeConfig, plan: Plan, *,
                 trace: bool = True,
                 check_devices: bool = False) -> List[Diagnostic]:
    """Certify a fused plan: point-level lint of every segment's
    combination under the plan's knobs.  ``trace`` (default on: a plan
    has few segments) enables the abstract-trace rule."""
    diags: List[Diagnostic] = []
    for seg in fragment(cfg):
        combo = plan.segments.get(seg.name)
        if combo is None:
            diags.append(Diagnostic(
                "missing-segment", WARN,
                f"plan has no combination for segment {seg.name!r}: "
                f"build_contexts will substitute one",
                segment=seg.name))
            continue
        diags += analyze_point(cfg, shape, combo, knobs=plan.knobs,
                               mesh=plan.mesh, segments=(seg,),
                               check_devices=check_devices, trace=trace)
    diags += _rule_boundaries(cfg, shape, plan)
    diags.sort(key=lambda d: (d.severity != ERROR,))
    return diags


def _rule_boundaries(cfg: ArchConfig, shape: ShapeConfig,
                     plan: Plan) -> List[Diagnostic]:
    mesh = plan.mesh
    if mesh is None or mesh.is_local:
        return []                    # meshless: every partition is trivial
    if plan.meta.get("fusion") == "viterbi-boundary":
        return []                    # boundary costs were priced in
    axis_sizes = mesh.axis_sizes()
    chain = [(s, plan.segments[s.name]) for s in fragment(cfg)
             if s.name in plan.segments]
    out: List[Diagnostic] = []
    for (sa, ca), (sb, cb) in zip(chain, chain[1:]):
        pa = residual_pspec(cfg, shape, ca, sa, axis_sizes)
        pb = residual_pspec(cfg, shape, cb, sb, axis_sizes)
        if pa != pb:
            out.append(Diagnostic(
                "boundary-reshard", WARN,
                f"residual stream resharded at {sa.name}->{sb.name}: "
                f"{pa} vs {pb}, unpriced under per-segment-argmin "
                f"fusion (sweep with boundary_costs=True to price it)",
                segment=sb.name,
                evidence={"from": sa.name, "to": sb.name,
                          "pspec_from": repr(pa), "pspec_to": repr(pb)}))
    return out
