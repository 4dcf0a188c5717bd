"""The sweep's fusion, plainly: per segment, the least total time over the
rows that were scored (ComPar's per-segment argmin, with no boundary
costs on one device)."""
from __future__ import annotations

from typing import Dict, List


def best_per_segment(rows: List[dict]) -> Dict[str, float]:
    """rows: {"segment", "status", "total_s"} -> segment -> least total_s
    over its ``done`` rows."""
    best: Dict[str, float] = {}
    for r in rows:
        if r["status"] == "done":
            s = r["segment"]
            best[s] = min(best.get(s, float("inf")), r["total_s"])
    return best
