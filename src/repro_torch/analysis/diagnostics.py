"""Structured diagnostics, the output format of every lint rule, as the
reference's ``src/repro/analysis/diagnostics.py``.

A :class:`Diagnostic` is one finding: a stable rule id (the histogram
key in ``SweepReport.static_rules``), a severity, a human message, the
segment it applies to (``""`` = the whole point), and machine-readable
evidence (the numbers the rule compared).  Severity semantics:

* ``error`` — the point provably fails when its program is built and
  run (a divisibility the program raises on, or a refusal of a CUDA
  kernel's wrapper).  ``static_checks="strict"`` drops these before they
  become JobSpecs.
* ``warn``  — suspicious but viable (silent clamping, replication
  fallback, precision hazards).  Never drops a point.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

ERROR = "error"
WARN = "warn"


@dataclass
class Diagnostic:
    rule: str                      # stable rule id, e.g. "microbatch"
    severity: str                  # "error" | "warn"
    message: str
    segment: str = ""              # "" = applies to the whole point
    evidence: Dict[str, object] = field(default_factory=dict)

    def __post_init__(self):
        if self.severity not in (ERROR, WARN):
            raise ValueError(f"severity {self.severity!r}")

    @property
    def is_error(self) -> bool:
        return self.severity == ERROR

    def to_json(self) -> Dict:
        return {"rule": self.rule, "severity": self.severity,
                "message": self.message, "segment": self.segment,
                "evidence": dict(self.evidence)}

    @classmethod
    def from_json(cls, d: Dict) -> "Diagnostic":
        return cls(d["rule"], d["severity"], d["message"],
                   d.get("segment", ""), dict(d.get("evidence") or {}))

    def __str__(self) -> str:
        where = f" [{self.segment}]" if self.segment else ""
        return f"{self.severity.upper()} {self.rule}{where}: {self.message}"


def errors(diags: Sequence[Diagnostic]) -> List[Diagnostic]:
    """The error-severity subset (what strict mode acts on)."""
    return [d for d in diags if d.is_error]


def format_diagnostics(diags: Sequence[Diagnostic]) -> str:
    """One line per diagnostic, errors first (stable within severity)."""
    ordered = sorted(diags, key=lambda d: (d.severity != ERROR,))
    return "\n".join(str(d) for d in ordered)
