"""PlanRegistry: fused plans persisted by deployment context, as the
reference's ``src/repro/serve/registry.py``.

The sweep answers "which plan is best for (arch, traffic shape)?"; the
registry makes the answer durable.  Plans live in the ``plan_registry``
table beside ``score_cache``, keyed by ``(arch, shape signature, mesh,
executor cache_tag)``, the content keys the scoring pipeline uses, so a
plan is never served to an environment it was not tuned for.
``ComParTuner(registry=...)`` registers the fused plan after every sweep;
the serving CLI (``python -m repro_torch.launch.serve --registry-db ...``)
looks plans up.  The mesh column holds the plan's ``MeshSpec`` mid
(``"local"`` for a meshless plan).

``lookup`` resolves the exact key first and then falls back to the
*nearest traffic shape* of the same (arch, kind, mesh[, cache_tag]):
closest in log2 space over (seq_len, batch), deterministic tie-break.

The module is also a CLI that runs a dry-run sweep of a serving shape and
registers the winner, or lists the registry::

    python -m repro_torch.serve.registry --db ${TMPDIR:-/tmp}/registry.db \\
        --arch stablelm-3b --smoke --batch 4 --cache-len 64 --device cpu
    python -m repro_torch.serve.registry \\
        --db ${TMPDIR:-/tmp}/registry.db --list
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.backends.scheduler import shape_key
from repro_torch.core.db import SweepDB
from repro_torch.core.meshspec import as_mesh_point
from repro_torch.core.plan import Plan


def serving_shape(batch: int, cache_len: int) -> ShapeConfig:
    """The ShapeConfig of a serving deployment: ``decode`` kind with the
    cache length as the sequence budget and the slot capacity as the
    global batch.  This is what a serving CLI's ``--batch``/
    ``--cache-len`` map to, and so the registry lookup key."""
    return ShapeConfig(f"serve_{cache_len}x{batch}", int(cache_len),
                       int(batch), "decode")


def _mesh_mid(mesh) -> str:
    """Content key of any mesh-ish value (None, a MeshSpec, a live
    DeviceMesh, the dict shorthand): the MeshSpec ``mid``, ``"local"`` for
    the meshless point."""
    if mesh is None:
        return "local"
    return as_mesh_point(mesh).mid


@dataclass
class RegistryEntry:
    """One registered plan, decoded."""
    arch: str
    shape: str                      # shape_key signature, kind:SxB
    kind: str
    seq_len: int
    batch: int
    mesh_mid: str                   # 'local' = no mesh
    cache_tag: str
    plan: Plan
    total_s: Optional[float]
    report: Dict = field(default_factory=dict)
    created: float = 0.0
    #: set by lookup(): False when served via the nearest-shape fallback
    exact: bool = True

    def describe(self) -> str:
        t = f" total={self.total_s:.3e}s" if self.total_s is not None \
            else ""
        return (f"{self.arch} {self.shape} mesh={self.mesh_mid} "
                f"tag={self.cache_tag or '-'}{t}")


class PlanRegistry:
    """Persisted fused plans keyed by ``(arch, shape, mesh, cache_tag)``.

    ``db`` is a :class:`SweepDB` or a path (the registry table lives in
    the same file as the score cache, so one DB serves both sides).
    """

    def __init__(self, db: Union[SweepDB, str]):
        self.db = db if isinstance(db, SweepDB) else SweepDB(db)

    # ------------------------------------------------------------------
    def register(self, cfg: ArchConfig, shape: ShapeConfig, plan: Plan,
                 report=None, *, mesh=None,
                 cache_tag: str = "") -> RegistryEntry:
        """Persist ``plan`` under its deployment key.  ``mesh`` defaults to
        the plan's own chosen mesh (``fuse_joint``'s argmin); pass the
        tuner's fixed mesh for unswept sweeps.  ``report`` is a SweepReport (its summary is stored) or a
        JSON-able dict."""
        if mesh is None:
            mesh = plan.mesh
        rep: Dict = {}
        if report is not None:
            rep = report if isinstance(report, dict) \
                else {"summary": report.summary()}
        total = plan.meta.get("predicted_total_s")
        row = {"arch": cfg.name, "shape": shape_key(shape),
               "kind": shape.kind, "seq_len": shape.seq_len,
               "batch": shape.global_batch, "mesh": _mesh_mid(mesh),
               "cache_tag": cache_tag,
               "plan": json.dumps(plan.to_json(), sort_keys=True),
               "total_s": float(total) if total is not None else None,
               "report": json.dumps(rep, sort_keys=True, default=str)}
        self.db.plan_put(row)
        return self._entry(self.db.plan_get(
            row["arch"], row["shape"], row["mesh"], row["cache_tag"]))

    # ------------------------------------------------------------------
    def lookup(self, cfg: ArchConfig, shape: ShapeConfig, mesh=None, *,
               cache_tag: Optional[str] = None,
               nearest: bool = True) -> Optional[RegistryEntry]:
        """Resolve the plan for ``(cfg, shape, mesh)``: a mesh mismatch is
        a miss, never a fallback.

        Exact key first; then, unless ``nearest=False``, the closest
        registered traffic shape of the same (arch, kind, mesh[, tag]):
        minimal ``|log2 seq ratio| + |log2 batch ratio|``, ties broken on
        the (shape, cache_tag) sort order so repeated lookups return the
        same row.  ``cache_tag=None`` matches any tag."""
        sk, mid = shape_key(shape), _mesh_mid(mesh)
        if cache_tag is not None:
            row = self.db.plan_get(cfg.name, sk, mid, cache_tag)
            rows = [row] if row else []
        else:
            rows = [r for r in self.db.plan_query(arch=cfg.name, mesh=mid)
                    if r["shape"] == sk]
        if rows:
            return self._entry(rows[0], exact=True)
        if not nearest:
            return None
        cands = self.db.plan_query(arch=cfg.name, kind=shape.kind,
                                   mesh=mid, cache_tag=cache_tag)
        if not cands:
            return None

        def dist(r):
            return (abs(math.log2(max(shape.seq_len, 1))
                        - math.log2(max(r["seq_len"], 1)))
                    + abs(math.log2(max(shape.global_batch, 1))
                          - math.log2(max(r["batch"], 1))))
        best = min(cands, key=lambda r: (dist(r), r["shape"],
                                         r["cache_tag"]))
        return self._entry(best, exact=False)

    def entries(self, arch: Optional[str] = None) -> List[RegistryEntry]:
        return [self._entry(r) for r in self.db.plan_query(arch=arch)]

    # ------------------------------------------------------------------
    @staticmethod
    def _entry(row: Dict, exact: bool = True) -> RegistryEntry:
        try:
            rep = json.loads(row["report"]) if row["report"] else {}
        except ValueError:
            rep = {}
        return RegistryEntry(
            arch=row["arch"], shape=row["shape"], kind=row["kind"],
            seq_len=int(row["seq_len"]), batch=int(row["batch"]),
            mesh_mid=row["mesh"], cache_tag=row["cache_tag"],
            plan=Plan.from_json(json.loads(row["plan"])),
            total_s=row["total_s"], report=rep,
            created=float(row["created"] or 0.0), exact=exact)


# --- CLI: sweep a serving shape and register the winner ---------------------

def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve.registry",
        description="Sweep a serving shape and register the fused plan "
                    "(or --list the registry)")
    ap.add_argument("--db", required=True, help="registry/score-cache DB")
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="serving slot capacity (shape global_batch)")
    ap.add_argument("--cache-len", type=int, default=64,
                    help="decode cache length (shape seq_len)")
    ap.add_argument("--backend", default="thread",
                    choices=("thread", "sequential"))
    ap.add_argument("--device", default="cuda",
                    help="torch device of the tuner (default cuda; the "
                         "dry run itself runs on fake tensors)")
    ap.add_argument("--list", action="store_true",
                    help="print registered plans and exit")
    args = ap.parse_args(argv)

    db = SweepDB(args.db)
    reg = PlanRegistry(db)
    if args.list:
        rows = reg.entries()
        for e in rows:
            print(e.describe())
        print(f"{len(rows)} registered plan(s)")
        return 0

    from repro_torch.configs import get_arch
    from repro_torch.core.tuner import ComParTuner
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    shape = serving_shape(args.batch, args.cache_len)
    tuner = ComParTuner(cfg, shape, device=args.device, db=db,
                        project=f"serve-{cfg.name}-{shape.name}",
                        mode="continue", executor="dryrun", registry=reg)
    with tuner:
        plan, rep = tuner.sweep(
            providers=("tensor_par", "fsdp"),
            clause_space={"remat": ("none",), "kernel": ("plain",),
                          "cache_upcast": (True, False)},
            max_flags=0, backend=args.backend, prune=True)
    print(rep.summary())
    entry = reg.lookup(cfg, shape, cache_tag=tuner.executor.cache_tag)
    if entry is None or not entry.exact:
        raise SystemExit(f"[registry] the plan of {cfg.name} {shape.name} "
                         f"was not registered under its own key")
    print(f"registered: {entry.describe()}")
    print(f"plan:\n{entry.plan.describe()}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
