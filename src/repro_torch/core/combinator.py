"""Combinator: enumerate (provider x flag-subset x clause) combinations,
as the reference's ``src/repro/core/combinator.py``.

Mirrors ComPar's Combinator, which parses three JSON inputs (compilers +
flags, OpenMP directive clauses, RTL routines) and registers every
permutation in the DB.  The paper's combination-count formula

    sum_{i in C} (2^{n_i} - 1) * (2^{rtl + d} - 1)

is an upper bound (it counts clause subsets); the enumerated count is
reported beside it.

Plans and sweep inputs written for the JAX package read unchanged: its
clause ``kernel`` values ``"xla"`` and ``"pallas"`` map to the port's
``"plain"`` and ``"cuda"``.  A mesh point is a live ``DeviceMesh`` or a
:class:`~repro_torch.core.meshspec.MeshSpec`, as the reference's.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import random
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from repro_torch.models.context import SegmentClause

#: the reference's clause ``kernel`` values -> the port's
KERNEL_FROM_REFERENCE = {"xla": "plain", "pallas": "cuda"}

#: default "directive clause" sweep space (the OpenMP schedule/chunk analogue)
DEFAULT_CLAUSE_SPACE: Dict[str, Tuple] = {
    "remat": ("none", "dots", "full"),
    "kernel": ("plain", "cuda"),
    "block_q": (256, 512),
    "block_k": (512, 1024),
    "scan_unroll": (1,),
    "mlstm_chunk": (256,),
    "moe_dispatch": ("sorted",),
    "cache_upcast": (True,),
    "decode_shardmap": (False,),
}

#: default "RTL routine" sweep space (global runtime knobs)
DEFAULT_GLOBAL_SPACE: Dict[str, Tuple] = {
    "microbatches": (1, 2, 4),
    "donate": (True,),
    "opt_state_dtype": ("float32", "bfloat16"),
}


def port_kernel(value: str) -> str:
    """A clause ``kernel`` value in the port's names."""
    return KERNEL_FROM_REFERENCE.get(value, value)


@dataclass(frozen=True)
class Combination:
    """One point of the per-segment sweep."""
    provider: str
    flags: FrozenSet[str]
    clause: SegmentClause

    @property
    def cid(self) -> str:
        blob = json.dumps(
            {"p": self.provider, "f": sorted(self.flags),
             "c": self.clause.key()}, sort_keys=True)
        return hashlib.sha1(blob.encode()).hexdigest()[:12]

    def label(self) -> str:
        fl = "+".join(sorted(self.flags)) or "-"
        return f"{self.provider}[{fl}]({self.clause.key()})"

    def to_json(self) -> Dict:
        return {"provider": self.provider, "flags": sorted(self.flags),
                "clause": vars(self.clause)}

    @classmethod
    def from_json(cls, d: Dict) -> "Combination":
        clause = dict(d["clause"])
        clause["kernel"] = port_kernel(clause.get("kernel", "plain"))
        return cls(d["provider"], frozenset(d["flags"]),
                   SegmentClause(**clause))


def mapping_key(cfg, mesh, combo: Combination, seg) -> str:
    """Physical content of (provider, flags) for one segment: the resolved
    logical->mesh mapping.  Two combinations whose providers resolve to the
    same mapping build the same program.  Without a mesh every mapping is
    a no-op, so all providers collapse to one key, ``"local"``.

    ``mesh`` may be a live ``DeviceMesh`` or a :class:`MeshSpec`: the
    resolution needs only axis names and sizes, so a swept point is keyed
    without materializing anything.  The key is the reference's.
    """
    from repro_torch.core.meshspec import MeshSpec
    if mesh is None or (isinstance(mesh, MeshSpec) and mesh.is_local):
        return "local"
    from repro_torch.runtime.sharding import mesh_axis_sizes
    axis_sizes = mesh_axis_sizes(mesh)
    from repro_torch.core.providers import get_provider
    m = get_provider(combo.provider).mapping(cfg, axis_sizes, combo.flags,
                                             seg)
    blob = json.dumps({"axes": axis_sizes,
                       "map": {k: m[k] for k in sorted(m)}},
                      sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


#: effective-cid format version (the reference's, so keys agree)
EFFECTIVE_CID_VERSION = 2


def effective_cid(combo: Combination, relevant: FrozenSet[str],
                  map_key: str, knobs: "Optional[GlobalKnobs]" = None,
                  relevant_knobs: FrozenSet[str] = frozenset()) -> str:
    """The combination id as one segment's program sees it: the clause
    fields and knob fields that reach the segment, and the resolved
    mapping.  Combinations and knob points differing only elsewhere share
    one effective cid, hence one score."""
    cl = {f: getattr(combo.clause, f) for f in sorted(relevant)}
    kn = {f: getattr(knobs, f) for f in sorted(relevant_knobs)} \
        if knobs is not None else {}
    blob = json.dumps({"v": EFFECTIVE_CID_VERSION, "map": map_key,
                       "clause": cl, "knobs": kn},
                      sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


@dataclass(frozen=True)
class GlobalKnobs:
    """Program-wide knobs (ComPar's RTL-routine analogue), a swept axis:
    ``ComParTuner.sweep(global_space=...)`` chooses them by joint argmin."""
    microbatches: int = 1
    donate: bool = True
    opt_state_dtype: str = "float32"

    def key(self) -> str:
        return (f"mb={self.microbatches},don={self.donate},"
                f"osd={self.opt_state_dtype}")

    @property
    def kid(self) -> str:
        """Content id of this knob point."""
        blob = json.dumps(vars(self), sort_keys=True, default=str)
        return hashlib.sha1(blob.encode()).hexdigest()[:10]

    def to_json(self) -> Dict:
        return dict(vars(self))

    @classmethod
    def from_json(cls, d: Dict) -> "GlobalKnobs":
        return cls(**d)


def row_cid(combo: Combination, knobs: Optional[GlobalKnobs] = None,
            mesh=None) -> str:
    """DB row id of one (combination, knob point, mesh point)
    registration: the bare combination cid at the default knob point,
    else qualified by the knob content id; a swept mesh point (a
    :class:`MeshSpec`, ``None`` when the mesh is not swept) qualifies it
    with ``#`` and its ``mid``, the local point included, as the
    reference's."""
    rid = combo.cid if knobs is None or knobs == GlobalKnobs() \
        else f"{combo.cid}@{knobs.kid}"
    if mesh is not None:
        rid = f"{rid}#{mesh.mid}"
    return rid


def swept_knob_fields(space: Optional[Dict[str, Tuple]]) -> Tuple[str, ...]:
    """The knob fields a global space actually sweeps (> 1 value)."""
    if not space:
        return ()
    return tuple(sorted(k for k, v in space.items() if len(v) > 1))


def paper_combination_count(flags_per_provider: Sequence[int],
                            n_rtl: int, n_d: int) -> int:
    """The paper's formula: sum_i (2^{n_i}-1)(2^{rtl+d}-1)."""
    return sum((2 ** n - 1) * (2 ** (n_rtl + n_d) - 1)
               for n in flags_per_provider)


def flag_subsets(flags: Sequence[str], max_flags: Optional[int] = None):
    """All subsets of a provider's flags (including empty = bare provider)."""
    out = [frozenset()]
    upper = len(flags) if max_flags is None else min(max_flags, len(flags))
    for r in range(1, upper + 1):
        out.extend(frozenset(c) for c in itertools.combinations(flags, r))
    return out


def port_space(space: Dict[str, Tuple]) -> Dict[str, Tuple]:
    """A clause (or kernel) space with its ``kernel`` values in the port's
    names."""
    if "kernel" not in space:
        return space
    return dict(space, kernel=tuple(port_kernel(k) for k in space["kernel"]))


def clause_grid(space: Dict[str, Tuple]) -> List[SegmentClause]:
    space = port_space(space)
    keys = sorted(space)
    return [SegmentClause(**dict(zip(keys, combo)))
            for combo in itertools.product(*(space[k] for k in keys))]


def enumerate_combinations(
        providers: Sequence[str],
        clause_space: Optional[Dict[str, Tuple]] = None,
        *,
        max_flags: Optional[int] = None,
        budget: Optional[int] = None,
        seed: int = 0) -> List[Combination]:
    """Full cartesian enumeration, optionally budget-sampled (a uniform
    sample with a fixed seed, the reference's)."""
    from repro_torch.core.providers import get_provider
    clauses = clause_grid(clause_space or DEFAULT_CLAUSE_SPACE)
    out: List[Combination] = []
    for pname in providers:
        p = get_provider(pname)
        for fl in flag_subsets(sorted(p.flags), max_flags):
            for cl in clauses:
                out.append(Combination(pname, fl, cl))
    if budget is not None and len(out) > budget:
        rng = random.Random(seed)
        out = rng.sample(out, budget)
    return out


def global_grid(space: Optional[Dict[str, Tuple]] = None) -> List[GlobalKnobs]:
    space = space or DEFAULT_GLOBAL_SPACE
    keys = sorted(space)
    return [GlobalKnobs(**dict(zip(keys, combo)))
            for combo in itertools.product(*(space[k] for k in keys))]


@dataclass(frozen=True)
class SweepSpec:
    """The typed sweep input: ComPar's three JSON files as one value.

    * ``providers`` — provider names to race (the "compilers")
    * ``clauses`` — the directive-clause grid (``clause_space``)
    * ``globals`` — the GlobalKnobs grid (``global_space``)
    * ``kernel_space`` — the inner kernel-schedule grid (JSON key
      ``"kernels"``); ``None`` = no inner sweep
    * ``meshes`` — the topology axis (``mesh_space``, a tuple of
      :class:`MeshSpec`); ``None`` = the mesh is not swept

    :meth:`from_json` pins unlisted clause/global fields to their
    default's first value and maps the reference's kernel names.
    """

    providers: Tuple[str, ...] = ()
    clauses: Optional[Dict[str, Tuple]] = None
    globals: Optional[Dict[str, Tuple]] = None
    meshes: Optional[Tuple] = None
    kernel_space: Optional[Dict[str, Tuple]] = None

    @classmethod
    def from_json(cls, spec: Dict) -> "SweepSpec":
        providers = tuple(spec.get("providers", {}))
        clauses = port_space({k: tuple(v) for k, v in
                               spec.get("clauses", {}).items()})
        for k, v in DEFAULT_CLAUSE_SPACE.items():
            clauses.setdefault(k, (v[0],))
        gl = {k: tuple(v) for k, v in spec.get("globals", {}).items()}
        for k, v in DEFAULT_GLOBAL_SPACE.items():
            gl.setdefault(k, (v[0],))
        from repro_torch.core.meshspec import as_mesh_point
        meshes = tuple(as_mesh_point(m) for m in spec["meshes"]) \
            if "meshes" in spec else None
        kernels = port_space({k: tuple(v)
                              for k, v in spec["kernels"].items()}) \
            if "kernels" in spec else None
        return cls(providers, clauses, gl, meshes, kernels)

    def to_json(self) -> Dict:
        out: Dict = {"providers": {p: [] for p in self.providers}}
        if self.clauses is not None:
            out["clauses"] = {k: list(v) for k, v in self.clauses.items()}
        if self.globals is not None:
            out["globals"] = {k: list(v) for k, v in self.globals.items()}
        if self.meshes is not None:
            out["meshes"] = [m.to_json() for m in self.meshes]
        if self.kernel_space is not None:
            out["kernels"] = {k: list(v)
                              for k, v in self.kernel_space.items()}
        return out


def load_sweep_json(path: str) -> SweepSpec:
    """ComPar-style JSON sweep input, as the reference's::

        {"providers": {"tensor_par": ["shard_vocab"], "fsdp": []},
         "clauses":   {"remat": ["none","dots"], "kernel": ["xla"]},
         "globals":   {"microbatches": [1,2]},
         "meshes":    [null, {"data": 2, "model": 2}],
         "kernels":   {"kernel": ["xla","pallas"], "block_k": [512, 1024]}}

    ``meshes`` is the topology axis (``sweep(mesh_space=...)``): ``null``
    is the local point, an object the ``{"axis": size}`` shorthand or the
    MeshSpec wire form; absent = the mesh is not swept.

    ``kernels`` is the inner kernel-schedule grid
    (``sweep(kernel_space=...)``); absent = no inner sweep.  Returns a :class:`SweepSpec` for ``sweep(spec=...)``.
    """
    with open(path) as f:
        return SweepSpec.from_json(json.load(f))
