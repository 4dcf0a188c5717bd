"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in seconds, for
the tests: the same entries, plans, optimizer and limits at smoke widths."""
from __future__ import annotations

import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
for p in (str(CHECKOUT / "src"), str(CHECKOUT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench.harness import cell as C  # noqa: E402
from perfbench.harness import runner  # noqa: E402

TINY = {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
        "head_dim": 16, "d_ff": 96, "vocab_size": 128}
SEED = 2 ** 31 + 12345


def tiny_cell(name: str, dtype: str = "float32", **traffic):
    cell = C.load_cell(name)
    arch = dict(cell.config["arch"], **TINY, dtype=dtype)
    if arch["window_size"]:
        arch["window_size"] = 16
    cell.config = dict(cell.config, arch=arch)
    seq = 64 if cell.traffic["seq"] <= 4096 else 96
    cell.traffic = dict(cell.traffic, seq=seq, **traffic)
    return cell


def run(cell, seconds: float = 0.2, seed: int = SEED,
        trace: bool = False) -> dict:
    return runner.execute(cell, seed=seed, seconds=seconds, trace=trace,
                          device="cpu", t0=time.perf_counter())
