"""The numbers that decide ``correct``, each against its limit.

Training (a step the timed path ran, against the reference's step from
the same weights and rows):

- ``loss_gap``: the largest relative gap of a step's loss over the
  checked steps;
- ``logits_err``: the relative L2 error of the first step's logits over
  a sample of (position, vocabulary entry) places drawn from the seed;
- ``grad_gap``: by the worst leaf, the gap between the norms of the first
  gradient as the optimizer got it, over the larger of that leaf's and
  the median leaf's reference norm;
- ``change_gap``: the same for the norm of the parameters' change over
  the checked steps, leaves whose reference gradient is under a
  thousandth of the median leaf's left out (they move by round-off);
- ``grad_sample_err``: by the worst leaf (the same leaves counted), the
  relative L2 error of the first gradient over a sample of its elements
  drawn from the seed.  The gaps of norms average the rounding of each
  element away, so a float8 run reads within about 2x of a bfloat16 one
  there; element by element the two lie apart.

A sweep adds exact counts (rows not done, segments whose plan is not the
least total time of their rows, jobs not timed as the traffic sets) and,
for every program it scored, what its last timed call returned against
the reference's from the same inputs:

- ``seg_grad_err``: by the worst job and leaf, the relative L2 error of
  the gradient over a sample of its elements drawn from the seed;
- ``seg_grad_gap``: by the worst job and leaf, the gap between the norms
  of the gradient, over the larger of that leaf's and the median leaf's
  reference norm.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Tuple

#: a leaf whose reference gradient norm is below this share of the median
#: leaf's moves by round-off alone: its change is not compared
NOUGHT_GRAD = 1e-3


def rel_err(a, b) -> float:
    """||a - b|| / ||b|| of two CPU tensors (inf where it is not finite,
    where the shapes differ, or where ``b`` is zero and ``a`` is not)."""
    if a.shape != b.shape:
        return math.inf
    den = float(b.norm())
    if not math.isfinite(den):
        return math.inf
    err = float((a - b).norm()) / den if den > 0 else \
        (0.0 if float(a.norm()) == 0 else math.inf)
    return err if math.isfinite(err) else math.inf


def _worst(prog: Dict[str, float], ref: Dict[str, float], paths) -> Tuple:
    paths = list(paths)
    med = statistics.median(ref[p] for p in paths)
    worst = (0.0, None)
    for p in paths:
        den = max(ref[p], med)
        gap = abs(prog[p] - ref[p]) / den if den > 0 else \
            (0.0 if prog[p] == ref[p] else math.inf)
        if not math.isfinite(prog[p]):
            gap = math.inf
        if gap >= worst[0]:
            worst = (gap, p)
    return worst


def training_gaps(prog: dict, ref: dict) -> Dict[str, dict]:
    """{name: {"value": gap, "at": where}} of the training numbers."""
    if set(prog["grad_norms"]) != set(ref["grad_norms"]):
        raise ValueError("the program's and the reference's leaves differ")
    loss = max((abs(a - b) / abs(b) if math.isfinite(a) else math.inf, i)
               for i, (a, b) in enumerate(zip(prog["losses"], ref["losses"])))
    grad = _worst(prog["grad_norms"], ref["grad_norms"], ref["grad_norms"])
    med = statistics.median(ref["grad_norms"].values())
    counted = [p for p, g in ref["grad_norms"].items()
               if g >= NOUGHT_GRAD * med]
    change = _worst(prog["change_norms"], ref["change_norms"], counted)
    sample = (0.0, None)
    for p in counted:
        err = rel_err(prog["grad_samples"][p], ref["grad_samples"][p])
        if err >= sample[0]:
            sample = (err, p)
    logits = rel_err(prog["logits_sample"], ref["logits_sample"])
    return {"loss_gap": {"value": loss[0], "at": f"step {loss[1] + 1}"},
            "logits_err": {"value": logits, "at": "step 1"},
            "grad_gap": {"value": grad[0], "at": grad[1]},
            "change_gap": {"value": change[0], "at": change[1]},
            "grad_sample_err": {"value": sample[0], "at": sample[1]}}


def segment_gaps(jobs, refs: Dict[str, dict]) -> Dict[str, dict]:
    """``jobs``: [{"segment", "read": {path: (norm, sample)}}]; ``refs``:
    segment -> {path: (norm, sample)}.  A job whose leaves are not the
    reference's reads inf, and so does a run with no job read."""
    err, gap = (math.inf, "no job"), (math.inf, "no job")
    if jobs:
        err, gap = (0.0, None), (0.0, None)
    for k, j in enumerate(jobs):
        ref, got = refs[j["segment"]], j["read"]
        where = f"job {k} ({j['segment']})"
        if set(got) != set(ref):
            err = gap = (math.inf, f"{where}: leaves {sorted(got)}")
            break
        for p in ref:
            e = rel_err(got[p][1], ref[p][1])
            if e >= err[0]:
                err = (e, f"{where} {p}")
        g = _worst({p: v[0] for p, v in got.items()},
                   {p: v[0] for p, v in ref.items()}, ref)
        if g[0] >= gap[0]:
            gap = (g[0], f"{where} {g[1]}")
    return {"seg_grad_err": {"value": err[0], "at": err[1]},
            "seg_grad_gap": {"value": gap[0], "at": gap[1]}}


def judge(readings: Dict[str, dict], limits: Dict[str, float]):
    """(correct, checks): every reading that has a limit finite and at
    most it (a cell's limits file leaves out a number it does not
    compare).  ``checks`` is {name: {"value", "limit"}} in the readings'
    order."""
    checks, ok = {}, True
    for name, r in readings.items():
        if name not in limits:
            continue
        lim = limits[name]
        v = r["value"]
        good = math.isfinite(v) and v <= lim
        ok &= good
        checks[name] = {"value": v, "limit": lim}
    return ok, checks
