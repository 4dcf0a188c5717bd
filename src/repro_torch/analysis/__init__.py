"""Static validity analysis for sweep points and fused plans (PlanLint), as
the reference's ``src/repro/analysis/``.

Every validity mechanism of the sweep is otherwise dynamic: the black-box
numerics check pays a real forward pass, and a divisibility mistake
(microbatch split) or a kernel the wrapper refuses (a head dim it is not
compiled for) pays a whole segment program to discover the point was
never viable.  This package lints sweep points *without running
anything*:

* :func:`analyze_point` — rule-based diagnostics for one (combination,
  knobs) sweep point against one or more segments.
* :func:`analyze_plan` — certify a fused plan post-fusion.
* :func:`lint_schedule` — the kernel-schedule subset, shared with the
  kernel autotuner (``kernels/autotune.py``), so a variant a kernel's
  wrapper refuses is rejected before it runs.

Soundness contract: every ``error``-severity diagnostic marks a point
that *provably* fails when run; that is what lets
``sweep(static_checks="strict")`` drop them without changing any fused
plan.  Anything merely suspicious (silent chunk clamping, a naive
attention fallback, low-precision accumulation) is a ``warn`` and never
drops a point.

CLI: ``python -m repro_torch.analysis.lint <plan.json|sweep.json>``.
"""
from repro_torch.analysis.diagnostics import (Diagnostic, errors,
                                              format_diagnostics)
from repro_torch.analysis.planlint import analyze_plan
from repro_torch.analysis.rules import analyze_point, lint_schedule

__all__ = [
    "Diagnostic",
    "analyze_plan",
    "analyze_point",
    "errors",
    "format_diagnostics",
    "lint_schedule",
]
