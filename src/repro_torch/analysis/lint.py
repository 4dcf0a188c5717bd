"""PlanLint CLI, as the reference's ``python -m repro.analysis.lint``::

    python -m repro_torch.analysis.lint <plan.json|sweep.json>


The input kind is detected from the JSON shape:

* a **plan** (``Plan.save`` output, of either package: it has a top-level
  ``"segments"`` object) is certified with
  :func:`repro_torch.analysis.analyze_plan`;
* a **sweep spec** (the ComPar-style JSON ``load_sweep_json`` reads:
  ``providers``/``clauses``/``globals``) has every enumerated
  (combination, knob) point linted with
  :func:`repro_torch.analysis.analyze_point`.

Nothing runs on a device: the abstract trace runs on fake tensors.

Exit status: 0 = clean or warnings only, 1 = usage/IO error,
2 = error-severity diagnostics found (the CI-gate signal; warnings
also exit 2 under ``--strict``).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List

from repro_torch.analysis.diagnostics import Diagnostic


def _load(path: str):
    with open(path) as f:
        return json.load(f)


def _lint_plan(cfg, shape, doc, trace: bool) -> List[Diagnostic]:
    from repro_torch.analysis.planlint import analyze_plan
    from repro_torch.core.plan import Plan
    return analyze_plan(cfg, shape, Plan.from_json(doc), trace=trace)


def _lint_sweep(cfg, shape, path: str, trace: bool) -> List[Diagnostic]:
    from repro_torch.analysis.rules import analyze_point
    from repro_torch.core.combinator import (enumerate_combinations,
                                             global_grid, load_sweep_json)
    spec = load_sweep_json(path)
    combos = enumerate_combinations(list(spec.providers), spec.clauses)
    points = global_grid(spec.globals)
    out: List[Diagnostic] = []
    for kn in points:
        for c in combos:
            for d in analyze_point(cfg, shape, c, knobs=kn, trace=trace):
                d.evidence.setdefault("combination", c.label())
                d.evidence.setdefault("knobs", kn.key())
                out.append(d)
    print(f"linted {len(points) * len(combos)} sweep point(s) "
          f"({len(combos)} combination(s) x {len(points)} knob point(s) "
          f"x 1 mesh point(s))")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Static validity lint for sweep specs and fused plans")
    ap.add_argument("path", help="plan JSON (Plan.save) or sweep-spec JSON")
    ap.add_argument("--arch", default="stablelm-3b",
                    help="architecture id (default: stablelm-3b)")
    ap.add_argument("--shape", default="train_4k",
                    help="shape id (default: train_4k)")
    ap.add_argument("--full", action="store_true",
                    help="lint at full scale (default: the smoke "
                    "derivation, matching the examples and tests)")
    ap.add_argument("--no-trace", action="store_true",
                    help="skip the abstract-trace rule")
    ap.add_argument("--strict", action="store_true",
                    help="exit 2 on warnings too, not just errors")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch, get_shape
    cfg, shape = get_arch(args.arch), get_shape(args.shape)
    if not args.full:
        cfg, shape = cfg.smoke(), shape.smoke()

    try:
        doc = _load(args.path)
    except (OSError, ValueError) as e:
        print(f"error: cannot read {args.path}: {e}", file=sys.stderr)
        return 1
    trace = not args.no_trace
    if isinstance(doc, dict) and isinstance(doc.get("segments"), dict):
        diags = _lint_plan(cfg, shape, doc, trace)
        kind = "plan"
    else:
        diags = _lint_sweep(cfg, shape, args.path, trace)
        kind = "sweep spec"

    for d in diags:
        print(str(d))
    n_err = sum(1 for d in diags if d.is_error)
    n_warn = len(diags) - n_err
    print(f"{kind} {args.path}: {n_err} error(s), {n_warn} warning(s) "
          f"[arch={cfg.name} shape={shape.name}]")
    if n_err or (args.strict and n_warn):
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
