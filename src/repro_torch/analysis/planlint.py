"""Plan-level lint: certify a fused plan post-fusion, as the reference's
``src/repro/analysis/planlint.py``.

Per segment, a fused plan is a set of sweep points, so every point-level
rule applies (``analyze_point`` with the plan's knobs).  The
cross-segment rule of the reference:

``boundary-reshard``  adjacent segments whose residual-stream partitions
                  differ.  Meshless every partition is trivial, so it
                  gives nothing (as the reference's at ``mesh=None``); a
                  plan fused for a mesh raises (ROADMAP Queue 1 item 4).
``missing-segment``  the plan carries no combination for a segment of
                  this config; ``build_contexts`` will substitute another
                  segment's combination (loudly).                  [warn]
"""
from __future__ import annotations

from typing import List

from repro_torch.analysis.diagnostics import ERROR, WARN, Diagnostic
from repro_torch.analysis.rules import analyze_point
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
    diags.sort(key=lambda d: (d.severity != ERROR,))
    return diags
