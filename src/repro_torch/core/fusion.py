"""Optimal Plan Generator: fuse per-segment winners into one plan, as the
reference's ``src/repro/core/fusion.py``.

Paper-faithful mode: independent per-segment argmin over all valid
combinations — ComPar's guarantee holds (the fused plan is never worse
than the best single-provider plan, in the scored metric).

``boundary_costs=True`` charges layout transitions between adjacent
segments on a mesh (a resharding of the residual stream over the link)
and solves the chain by Viterbi DP.  Meshless, every boundary costs 0.
The boundary is priced from the mesh's axis sizes alone, so a swept
:class:`~repro_torch.core.meshspec.MeshSpec` point is priced without
materializing it (the reference builds the mesh first, which a process
with fewer ranks cannot).

Knob axis (``fuse_joint``): GlobalKnobs are program-wide, so the joint
``(segment, combination, knobs)`` argmin decomposes into one inner solve
per knob point plus an outer argmin; the plan's ``knobs`` are chosen.
"""
from __future__ import annotations

import logging
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.combinator import Combination, GlobalKnobs
from repro_torch.core.cost_model import H100, CostTerms, Hardware
from repro_torch.core.plan import Plan
from repro_torch.core.providers import get_provider
from repro_torch.models.params import DTYPES
from repro_torch.runtime.sharding import Rules, mesh_axis_sizes
from repro_torch.core.segment import Segment, fragment

log = logging.getLogger("repro_torch.fusion")


def _residual_pspec(cfg: ArchConfig, shape: ShapeConfig, mesh,
                    combo: Combination, seg: Segment):
    mapping = get_provider(combo.provider).mapping(
        cfg, mesh_axis_sizes(mesh), combo.flags, seg)
    rules = Rules(mapping, mesh)
    if shape.kind == "decode":
        return rules.pspec(("batch", "embed"),
                           (shape.global_batch, cfg.d_model))
    return rules.pspec(("batch", "seq", "embed"),
                       (shape.global_batch, shape.seq_len, cfg.d_model))


def _residual_bytes(cfg: ArchConfig, shape: ShapeConfig) -> int:
    elems = shape.global_batch * cfg.d_model
    if shape.kind != "decode":
        elems *= shape.seq_len
    return elems * DTYPES[cfg.dtype].itemsize


def _chips(mesh) -> int:
    n = 1
    for size in mesh_axis_sizes(mesh).values():
        n *= size
    return n


def boundary_cost_s(cfg: ArchConfig, shape: ShapeConfig, mesh,
                    a: Combination, sa: Segment,
                    b: Combination, sb: Segment,
                    hw: Hardware = H100) -> float:
    """Resharding cost of the residual stream between two segments."""
    if mesh is None or not mesh_axis_sizes(mesh):
        return 0.0
    pa = _residual_pspec(cfg, shape, mesh, a, sa)
    pb = _residual_pspec(cfg, shape, mesh, b, sb)
    if pa == pb:
        return 0.0
    return _residual_bytes(cfg, shape) / (_chips(mesh) * hw.link_bw)


def max_boundary_cost_s(cfg: ArchConfig, shape: ShapeConfig,
                        n_chips: int, hw: Hardware = H100) -> float:
    """Upper bound on ONE boundary's resharding cost under any pair of
    combinations, the per-boundary unit of ``JobSpec.slack_s``: the
    constant :func:`boundary_cost_s` charges (0 on one chip)."""
    if n_chips <= 1:
        return 0.0
    return _residual_bytes(cfg, shape) / (n_chips * hw.link_bw)


def fuse(cfg: ArchConfig, shape: ShapeConfig, mesh,
         results: Dict[str, List[Tuple[Combination, CostTerms]]],
         knobs: GlobalKnobs = GlobalKnobs(), *,
         boundary_costs: bool = False, hw: Hardware = H100) -> Plan:
    """results: segment name -> [(combination, cost)] (valid entries only).

    Returns the fused plan; per-segment predicted costs land in
    ``plan.meta``.
    """
    segs = fragment(cfg)
    for s in segs:
        if not results.get(s.name):
            raise ValueError(f"no valid combination for segment {s.name!r}")

    if not boundary_costs:
        chosen = {}
        meta_cost = {}
        for s in segs:
            combo, cost = min(results[s.name], key=lambda rc: rc[1].total_s)
            chosen[s.name] = combo
            meta_cost[s.name] = cost.total_s
        return Plan(chosen, knobs,
                    {"per_segment_s": meta_cost,
                     "predicted_total_s": sum(meta_cost.values()),
                     "fusion": "per-segment-argmin"})

    # --- Viterbi DP over the segment chain with transition costs ----------
    options = {s.name: results[s.name] for s in segs}
    back: List[Dict[int, Tuple[float, int]]] = []
    prev_costs = {i: rc[1].total_s
                  for i, rc in enumerate(options[segs[0].name])}
    for si in range(1, len(segs)):
        s_prev, s_cur = segs[si - 1], segs[si]
        cur: Dict[int, Tuple[float, int]] = {}
        for j, (cj, costj) in enumerate(options[s_cur.name]):
            best = (math.inf, -1)
            for i, (ci, _) in enumerate(options[s_prev.name]):
                t = boundary_cost_s(cfg, shape, mesh, ci, s_prev,
                                    cj, s_cur, hw)
                cand = prev_costs[i] + t
                if cand < best[0]:
                    best = (cand, i)
            cur[j] = (best[0] + costj.total_s, best[1])
        back.append(cur)
        prev_costs = {j: v[0] for j, v in cur.items()}
    # trace back
    j = min(prev_costs, key=prev_costs.get)
    total = prev_costs[j]
    chosen_idx = [0] * len(segs)
    chosen_idx[-1] = j
    for si in range(len(segs) - 1, 0, -1):
        j = back[si - 1][j][1]
        chosen_idx[si - 1] = j
    chosen = {s.name: options[s.name][chosen_idx[i]][0]
              for i, s in enumerate(segs)}
    meta_cost = {s.name: options[s.name][chosen_idx[i]][1].total_s
                 for i, s in enumerate(segs)}
    return Plan(chosen, knobs,
                {"per_segment_s": meta_cost, "predicted_total_s": total,
                 "fusion": "viterbi-boundary"})


def fuse_joint(cfg: ArchConfig, shape: ShapeConfig, mesh,
               per_knob: Dict[str, Dict[str, List[Tuple[Combination,
                                                        CostTerms]]]],
               knob_points: List[GlobalKnobs], *,
               boundary_costs: bool = False, hw: Hardware = H100,
               mesh_points=None) -> Plan:
    """Joint argmin over ``(segment, combination, knobs)``.

    ``per_knob``: knob kid -> (segment name -> valid [(combo, cost)]).
    Solves each knob point's chain with :func:`fuse`, then takes the
    outer argmin of the predicted totals; ties break to the earliest
    point in ``knob_points`` order.  A knob point missing a valid
    combination for some segment is skipped; if every point is unfusable
    the error lists each point's failure.

    With ``mesh_points`` (a list of
    :class:`~repro_torch.core.meshspec.MeshSpec`) the mesh is the
    outermost axis: ``per_knob`` is keyed ``mesh mid -> knob kid ->
    segment -> rows``, ``mesh`` is ignored, and each point's inner solve
    prices its boundaries on that point's axes.  The plan's ``mesh`` is
    the chosen point; ties break to the earliest point in ``mesh_points``
    order.
    """
    if mesh_points is not None:
        best: Optional[Plan] = None
        mesh_totals: Dict[str, float] = {}
        failures = []
        for mp in mesh_points:
            table = per_knob.get(mp.mid) or {}
            try:
                plan = fuse_joint(cfg, shape, None if mp.is_local else mp,
                                  table, knob_points,
                                  boundary_costs=boundary_costs, hw=hw)
            except ValueError as e:
                failures.append(f"[{mp.key()}] {e}")
                continue
            plan.mesh = mp
            mesh_totals[mp.key()] = plan.meta["predicted_total_s"]
            if best is None or (plan.meta["predicted_total_s"]
                                < best.meta["predicted_total_s"]):
                best = plan
        if best is None:
            raise ValueError("no mesh point is fusable: "
                             + "; ".join(failures))
        if failures:
            log.warning("mesh argmin skipped %d point(s): %s",
                        len(failures), "; ".join(failures))
            best.meta["mesh_failures"] = list(failures)
        if len(mesh_points) > 1:
            best.meta["fusion"] += "+mesh-argmin"
        best.meta["mesh_points"] = len(mesh_points)
        best.meta["per_mesh_total_s"] = mesh_totals
        return best
    best = None
    totals: Dict[str, float] = {}
    failures = []
    for kn in knob_points:
        table = per_knob.get(kn.kid) or {}
        try:
            plan = fuse(cfg, shape, mesh, table, kn,
                        boundary_costs=boundary_costs, hw=hw)
        except ValueError as e:
            failures.append(f"[{kn.key()}] {e}")
            continue
        totals[kn.key()] = plan.meta["predicted_total_s"]
        if best is None or (plan.meta["predicted_total_s"]
                            < best.meta["predicted_total_s"]):
            best = plan
    if best is None:
        raise ValueError("no knob point has a valid combination for every "
                         "segment: " + "; ".join(failures))
    if len(knob_points) > 1:
        best.meta["fusion"] += "+knob-argmin"
    best.meta["knob_points"] = len(knob_points)
    best.meta["per_knob_total_s"] = totals
    return best


def best_uniform(cfg: ArchConfig,
                 results: Dict[str, List[Tuple[Combination, CostTerms]]],
                 knobs: GlobalKnobs = GlobalKnobs()) -> Tuple[Plan, float]:
    """The best *single-provider-everywhere* plan (the paper's baseline).

    Only combinations valid on every segment qualify (a provider that
    fails on any segment cannot compile the whole program — exactly
    ComPar's 'compiler fails on benchmark' case)."""
    segs = fragment(cfg)
    by_cid: Dict[str, Dict[str, Tuple[Combination, CostTerms]]] = {}
    for s in segs:
        for combo, cost in results.get(s.name, []):
            by_cid.setdefault(combo.cid, {})[s.name] = (combo, cost)
    best: Optional[Tuple[Plan, float]] = None
    for cid, per_seg in by_cid.items():
        if len(per_seg) != len(segs):
            continue
        total = sum(c.total_s for _, c in per_seg.values())
        combo = next(iter(per_seg.values()))[0]
        if best is None or total < best[1]:
            plan = Plan({s.name: combo for s in segs}, knobs,
                        {"predicted_total_s": total, "fusion": "uniform"})
            best = (plan, total)
    if best is None:
        raise ValueError("no combination is valid on all segments")
    return best
