"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix; the traffic names its
entry and plan; the cell's limits sit in ``limits/<cell>.json``.  Each
per-layer metric is read by ``metrics/<metric>.py``.  Adding a cell, a
configuration, a plan or a metric adds files and entries, and edits none.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]          # perfbench/
CHECKOUT = ROOT.parent
BENCHMARK = CHECKOUT / "BENCHMARK.json"


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str) -> ModuleType:
    """Import ``path`` as a module named ``name`` (file names hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return _json(BENCHMARK)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict             # configs/<config>.json
    traffic: dict            # traffic/<traffic>.json
    plan: dict               # plans/<plan>.json's "plan" (absent: {})
    limits: dict             # limits/<cell>.json's "limits"
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)

    @property
    def arch(self) -> dict:
        return self.config["arch"]


def _reported(metrics: List[dict], cell: str) -> List[dict]:
    """Metrics this cell reports: those without a ``workloads`` key and
    those that list it."""
    return [m for m in metrics if cell in m.get("workloads", (cell,))]


def load_cell(name: str) -> Cell:
    bench, root = benchmark(), ROOT
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / "configs" / f"{w['config']}.json")
    if config["name"] != w["config"] or \
            root / "configs" / f"{w['config']}.json" != \
            root.parent / configs[w["config"]]["file"]:
        raise ValueError(f"configuration {w['config']!r}: file and "
                         f"BENCHMARK.json disagree")
    traffic = _json(root / "traffic" / f"{w['traffic']}.json")
    plan = _json(root / "plans" / f"{traffic['plan']}.json")["plan"] \
        if "plan" in traffic else {}
    limits = _json(root / "limits" / f"{name}.json")["limits"]
    e2e = _reported(bench["end_to_end"], name)
    per_layer = _reported(bench["per_layer"], name)
    return Cell(name, w["chips"], config, traffic, plan, limits, e2e,
                per_layer)


def entry(cell: Cell) -> ModuleType:
    """``perfbench.entries.<entry>``: ``run(ctx)`` drives the timed path."""
    return importlib.import_module(f"perfbench.entries.{cell.traffic['entry']}")


def readers(cell: Cell) -> Dict[str, ModuleType]:
    """metric name -> its reader module (``read(readings)``)."""
    return {m["name"]: _module(ROOT / "metrics" / f"{m['name']}.py",
                               "perfbench_metric_" + m["name"]
                               .replace(".", "_").replace("-", "_"))
            for m in cell.per_layer}
