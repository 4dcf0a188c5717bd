"""Op-stream analysis for the roofline model: the counterpart of the
reference's ``src/repro/runtime/hlo.py``.

The reference walks a compiled XLA module (the post-SPMD, per-device
program) and totals its flops, an HBM-traffic estimate and the bytes its
collectives move.  The port has no HLO: its program is the stream of
operators that ``core.executor.OpCounter`` sees while the step runs on
each rank's local shards (fake tensors in the dry run), so this module
keeps the accounting over that stream, per device:

* **flops** — ``FlopCounterMode``'s count (every matrix product and the
  kernel ops' registered formulas), passed in by the counter;
* **bytes** — each operator's inputs read and outputs written once (views
  and uninitialised allocations move nothing);
* **collective bytes** — per-device bytes each ``_c10d_functional``
  collective moves, with the reference's ring factors
  (:func:`_collective_moved`).
"""
from __future__ import annotations

from typing import Dict, Iterable, NamedTuple, Optional

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

#: torch collective operator -> the reference's HLO collective kind
_KIND_OF = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}

#: collective operators that move no data of their own
_NO_MOVE = {"wait_tensor", "barrier", "monitored_barrier_"}


def collective_kind(op_name: str) -> Optional[str]:
    """The reference's kind of a torch collective operator (its overload
    packet's name), or None for one that moves nothing (``wait_tensor``).
    An unknown collective keeps its own name, dashed, and is charged its
    result bytes."""
    if op_name in _NO_MOVE:
        return None
    return _KIND_OF.get(op_name, op_name.strip("_").replace("_", "-"))


def _collective_moved(kind: str, result_bytes: float,
                      group_size: int) -> float:
    """Per-device bytes a collective moves, from its result's bytes ``r``
    over a group of ``n``: the reference's ring factors (all-gather
    r(n-1)/n, all-reduce 2r(n-1)/n, reduce-scatter r(n-1), all-to-all
    r(n-1)/n; anything else r)."""
    r, n = float(result_bytes), int(group_size)
    if r == 0:
        return 0.0
    if kind == "all-gather":
        return r * (n - 1) / n
    if kind == "all-reduce":
        return 2.0 * r * (n - 1) / n
    if kind == "reduce-scatter":
        return r * (n - 1)
    if kind == "all-to-all":
        return r * (n - 1) / n
    return r


class OpRecord(NamedTuple):
    """One operator of the stream: its name (``namespace.op``), the bytes
    it reads and writes (0 for a collective or a view), and for a
    collective its kind, result bytes and group size."""
    name: str
    bytes: int = 0
    kind: Optional[str] = None
    result_bytes: int = 0
    group_size: int = 1

    @property
    def moved(self) -> float:
        if self.kind is None:
            return 0.0
        return _collective_moved(self.kind, self.result_bytes,
                                 self.group_size)


def analyze_ops(records: Iterable[OpRecord],
                flops: float = 0.0) -> Dict[str, float]:
    """Per-device totals of an op stream, with the reference's keys:
    ``flops``, ``bytes``, ``collective`` and, per collective kind present,
    ``coll_<kind>`` (and ``coll_count``, the number of collectives)."""
    nbytes, coll = 0.0, {}
    for r in records:
        nbytes += r.bytes
        if r.kind is not None:
            coll[r.kind] = coll.get(r.kind, 0.0) + r.moved
            coll["count"] = coll.get("count", 0.0) + 1
    out = {"flops": float(flops), "bytes": nbytes,
           "collective": sum(v for k, v in coll.items() if k != "count")}
    for k, v in coll.items():
        out[f"coll_{k}"] = v
    return out


def collective_bytes(records: Iterable[OpRecord]) -> Dict[str, float]:
    """Per-device collective bytes by kind, and their ``total``."""
    res = analyze_ops(records)
    out = {k[len("coll_"):]: v for k, v in res.items()
           if k.startswith("coll_")}
    out["total"] = res["collective"]
    return out


def count_ops(records: Iterable[OpRecord], opname: str) -> int:
    """How many operators of the stream are ``opname`` (a full
    ``namespace.op`` name, or the op's own name)."""
    return sum(1 for r in records
               if r.name == opname or r.name.split(".")[-1] == opname)
