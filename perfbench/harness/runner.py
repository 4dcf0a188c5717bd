"""One run of one cell: the entry's set-up, window and check, and the
result line's contents."""
from __future__ import annotations

import subprocess
import sys
from types import SimpleNamespace

from perfbench.harness import cell as C
from perfbench.harness import verdict
from perfbench.harness.trace import breakdown


def log(msg: str):
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def card() -> dict:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as e:
        return {"nvidia_smi": f"not read: {e}"}
    return {"nvidia_smi": out[0] if out else "not read"}


def execute(cell: C.Cell, *, seed: int, seconds: float, trace: bool,
            device, t0: float) -> dict:
    """Run ``cell`` once; returns the result (without the JAX check)."""
    import torch
    ctx = SimpleNamespace(torch=torch, cell=cell, seed=seed, seconds=seconds,
                          trace=trace, device=torch.device(device), t0=t0,
                          log=log)
    out = C.entry(cell).run(ctx)
    correct, checks = verdict.judge(out["gaps"], cell.limits)
    correct = correct and out["failed"] == 0 and out["attempted"] > 0
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            v = out["setup_s"] if m["name"] == "setup_s" \
                else out["e2e"][m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for name, reader in C.readers(cell).items():
            v = reader.read(out["readings"])
            if v is not None:
                unit = next(m["unit"] for m in cell.per_layer
                            if m["name"] == name)
                metrics[name] = {"value": v, "unit": unit}
    cuda = ctx.device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace and out["trace"] is not None:
        dev["busy_s"] = out["trace"]["busy_s"]
        dev["window_s"] = out["trace"]["window_s"]
        result["breakdown"] = breakdown(out["trace"])
    if cuda:
        result["card"] = card()
    result["checks"] = checks
    return result
