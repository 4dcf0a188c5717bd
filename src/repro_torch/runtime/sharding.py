"""Logical-axis sharding rules on a ``torch.distributed`` device mesh.

A :class:`Rules` object maps *logical* axis names (``embed``, ``heads``,
``batch`` ...) to mesh axes, with divisibility-aware fallbacks, as the
reference's (``src/repro/runtime/sharding.py``).  Strategy providers
(``repro_torch.core.providers``) are factories of such mappings: the
"compiler output" of ComParX is a set of rules per segment.

``Rules.pspec`` gives the reference's ``PartitionSpec`` as a plain tuple
(one entry per tensor dim: ``None``, an axis name, or a tuple of axis
names; trailing ``None`` trimmed), equal to the reference's entry for
entry.  A mesh here is a :class:`~torch.distributed.device_mesh.DeviceMesh`
(or, for resolving specs without devices, anything with ``axis_names`` and
``devices.shape``, or a :class:`~repro_torch.core.meshspec.MeshSpec`).

Named departures from the reference:

* A spec becomes DTensor placements, one per mesh dim
  (:func:`placements`).  A tensor dim over two mesh axes, ``("data",
  "model")``, becomes ``Shard(d)`` on both; DTensor splits it in mesh-dim
  order, so the axes of one dim must come in the mesh's order (the
  reference's major-to-minor).  A spec in another order raises.
* ``constrain`` is ``x.redistribute(...)`` of a DTensor (the reference's
  ``with_sharding_constraint``); a plain tensor under a mesh is taken as
  replicated first.
* ``shard_map_compat`` has no counterpart: :func:`on_shards` runs a
  function on each rank's local shards (the kernel ops, the plain
  attention, the MoE dispatch), as ``local_map`` does, choosing the
  layout from its inputs'; :func:`map_local` takes the layout from
  explicit pspecs, as ``shard_map``'s ``in_specs``/``out_specs`` (the
  sharded decode and the all-to-all MoE), and :func:`all_reduce` is the
  ``psum``/``pmax`` over a mesh axis inside it, a functional collective
  (which the dry run's counter sees).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

Candidate = Union[None, str, Tuple[str, ...]]
#: a PartitionSpec analogue: one entry per (leading) tensor dim
PSpec = Tuple[Candidate, ...]


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh, a MeshSpec or a mesh-like
    object with ``axis_names`` and ``devices.shape``; ``{}`` for None."""
    if mesh is None:
        return {}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                          # DeviceMesh
        return dict(zip(names, (int(s) for s in mesh.shape)))
    if hasattr(mesh, "axes") and hasattr(mesh, "mid"):   # MeshSpec
        return dict(mesh.axes)
    return dict(zip(mesh.axis_names, (int(s) for s in mesh.devices.shape)))


def is_device_mesh(mesh) -> bool:
    return getattr(mesh, "mesh_dim_names", None) is not None


def _as_candidates(v) -> List[Candidate]:
    """Normalize a mapping value into an ordered candidate list."""
    if isinstance(v, list):
        return v + [None] if v and v[-1] is not None else (v or [None])
    return [v, None] if v is not None else [None]


class Sharding(NamedTuple):
    """The NamedSharding analogue: a device mesh and one placement per
    mesh dim."""
    mesh: object
    placements: tuple


def placements(mesh, pspec: PSpec, ndim: Optional[int] = None,
               shape: Optional[Sequence[int]] = None) -> tuple:
    """DTensor placements (one per mesh dim) of a pspec on ``mesh``.

    A mesh axis no dim names is ``Replicate``; a dim naming several axes
    is sharded on each, which DTensor splits in mesh-dim order, so those
    axes must be in that order.  ``ndim`` (the tensor's rank) is checked
    against the spec's length.  Given the tensor's ``shape``, a dim of
    size 1 (which divides only over axes of size 1, so every rank holds it
    whole) stays ``Replicate``: DTensor's view rules refuse a sharded
    singleton dim."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    if shape is not None:
        ndim = len(shape)
    if ndim is not None and len(pspec) > ndim:
        raise ValueError(f"pspec {pspec} has more entries than {ndim} dims")
    out = [Replicate()] * len(names)
    for d, part in enumerate(pspec):
        if part is None:
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"pspec {pspec}: no mesh axis {a!r} in "
                                 f"{tuple(names)}")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(
                f"pspec {pspec}: dim {d} is split over {axes}, an order "
                f"DTensor cannot express on a mesh of axes {tuple(names)} "
                f"(it splits a dim in mesh-dim order)")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"pspec {pspec}: mesh axis {names[i]!r} "
                                 f"used twice")
            if shape is None or shape[d] != 1:
                out[i] = Shard(d)
    return tuple(out)


class Rules:
    """logical axis -> mesh axes resolution with divisibility fallback."""

    def __init__(self, mapping: Dict[str, object], mesh=None):
        self.mapping = {k: _as_candidates(v) for k, v in (mapping or {}).items()}
        self.mesh = mesh
        self.axis_sizes = mesh_axis_sizes(mesh)

    def _resolve_one(self, name: Optional[str], dim: int,
                     used: set) -> Optional[Tuple[str, ...]]:
        if name is None:
            return None
        for cand in self.mapping.get(name, [None]):
            if cand is None:
                return None
            axes = (cand,) if isinstance(cand, str) else tuple(cand)
            # keep only axes that exist in this mesh and are unused
            axes = tuple(a for a in axes
                         if a in self.axis_sizes and a not in used)
            if not axes:
                continue
            size = 1
            for a in axes:
                size *= self.axis_sizes[a]
            if dim % size == 0:
                used.update(axes)
                return axes
        return None

    def pspec(self, logical_axes: Sequence[Optional[str]],
              shape: Sequence[int]) -> PSpec:
        used: set = set()
        parts: List[Candidate] = []
        for name, dim in zip(logical_axes, shape):
            axes = self._resolve_one(name, dim, used)
            if axes is None:
                parts.append(None)
            elif len(axes) == 1:
                parts.append(axes[0])
            else:
                parts.append(axes)
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)

    def sharding(self, logical_axes, shape) -> Optional[Sharding]:
        if not is_device_mesh(self.mesh):
            return None
        return Sharding(self.mesh, placements(
            self.mesh, self.pspec(logical_axes, shape), shape=shape))

    def distribute(self, x, logical_axes):
        """Place a full tensor (the same on every rank) on the mesh by
        logical axes: each rank keeps its own shard, with no collective."""
        s = self.sharding(logical_axes, x.shape)
        return x if s is None else distribute(x, s)

    def constrain(self, x, logical_axes):
        """Redistribute to the layout of ``logical_axes`` (a no-op without
        a mesh)."""
        if not is_device_mesh(self.mesh):
            return x
        from torch.distributed.tensor import DTensor, Replicate
        s = self.sharding(logical_axes, x.shape)
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, s.mesh, [Replicate()] * s.mesh.ndim,
                                   run_check=False)
        if tuple(x.placements) == s.placements:
            return x
        return x.redistribute(s.mesh, s.placements)

    @classmethod
    def null(cls) -> "Rules":
        return cls({}, None)

    def merged(self, extra: Dict[str, object]) -> "Rules":
        m = dict(self.mapping)
        m.update({k: _as_candidates(v) for k, v in extra.items()})
        r = Rules.__new__(Rules)
        r.mapping, r.mesh, r.axis_sizes = m, self.mesh, self.axis_sizes
        return r

    def __repr__(self):
        return f"Rules({ {k: v for k, v in self.mapping.items()} })"


def distribute(x, sharding: Sharding):
    """``distribute_tensor`` of a tensor every rank holds in full: each
    rank cuts its own shard (``src_data_rank=None``, no scatter)."""
    from torch.distributed.tensor import distribute_tensor
    out = distribute_tensor(x.detach(), sharding.mesh, sharding.placements,
                            src_data_rank=None)
    return out.requires_grad_(x.requires_grad)


def batch_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes present in a mesh (pod first)."""
    if mesh is None:
        return ()
    return tuple(a for a in ("pod", "data") if a in mesh_axis_sizes(mesh))


def mesh_scope(meshed: bool):
    """The context a meshed forward runs in: plain tensors (positions,
    masks) meet DTensors as replicated ones.  A null context meshless or
    inside such a scope already (``implicit_replication`` does not nest:
    leaving an inner one would end the outer one)."""
    import torch
    if not meshed or torch._C._get_dtensor_allow_implicit_replication():
        return contextlib.nullcontext()
    _register_op_rules()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def on_shards(fn, tensors, dims, out_dims):
    """Run ``fn`` on the local shards of ``tensors`` (DTensors on one
    mesh, or plain tensors, taken as replicated) and wrap its outputs.

    The sharding rule of an op that is independent along a batch dim and
    one more dim (heads; features) and needs every other dim whole.
    ``dims[i]`` gives tensor i's (batch dim, split dim), or fewer roles;
    ``out_dims`` the same for each output.  Per mesh dim, the first
    tensor's placement decides: ``Shard`` of one of its role dims is kept
    for every tensor when each tensor's dim divides by the axis size;
    anything else (another dim, ``Partial``, an uneven split) becomes
    ``Replicate``.  ``dims[i] = None`` passes tensor i whole to every
    rank; its gradient is then a partial sum over the sharded mesh dims.
    Returns a list of DTensors (``fn`` returns a list of tensors)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    lead = next(t for t in tensors if isinstance(t, DTensor))
    mesh = lead.device_mesh
    tensors = [t if isinstance(t, DTensor) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        for t in tensors]
    roles = []                       # per mesh dim: None | 0 | 1
    split = [1, 1]                   # ways each role's dim is split
    for i, pl in enumerate(tensors[0].placements):
        role = None
        if isinstance(pl, Shard) and pl.dim in dims[0]:
            r = dims[0].index(pl.dim)
            n = split[r] * mesh.size(i)
            if all(t.shape[d[r]] % n == 0 for t, d in zip(tensors, dims)
                   if d is not None and r < len(d)):
                role, split[r] = r, n
        roles.append(role)

    def placed(d):
        return [Shard(d[r]) if r is not None and d is not None
                and r < len(d) else Replicate() for r in roles]

    partial = [Replicate() if r is None else Partial() for r in roles]
    local = [t.redistribute(mesh, placed(d)).to_local(
        grad_placements=partial if d is None else None)
        for t, d in zip(tensors, dims)]
    return [DTensor.from_local(o, mesh, placed(d), run_check=False)
            for o, d in zip(fn(*local), out_dims)]


_RULES: list = []


def _register_op_rules():
    """DTensor sharding rules for the ATen ops the models reach that
    DTensor has none for: ``log_sigmoid_backward`` (xLSTM's forget gate),
    pointwise, its CUDA buffer empty and replicated; and ``mm`` with an
    ``out_dtype`` (the head's bf16 product with an f32 output), a matrix
    product like ``mm``."""
    if _RULES:
        return
    import torch
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.mm.dtype)
    def _mm_dtype(a, b, out_dtype):
        R = Replicate()
        return [([R], [R, R, None]),
                ([Shard(0)], [Shard(0), R, None]),
                ([Shard(1)], [R, Shard(1), None]),
                ([Partial()], [Shard(1), Shard(0), None])]
    _RULES.append(_mm_dtype)

    @register_sharding(torch.ops.aten.log_sigmoid_backward.default)
    def _log_sigmoid_backward(grad, x, buffer):
        def buf(p):
            return p if tuple(buffer.shape) == tuple(x.shape) else Replicate()
        out = [([Replicate()], [Replicate(), Replicate(), Replicate()])]
        for d in range(len(x.shape)):
            out.append(([Shard(d)], [Shard(d), Shard(d), buf(Shard(d))]))
        return out
    _RULES.append(_log_sigmoid_backward)


def map_local(fn, mesh, in_specs, out_specs, *args, split_axes=()):
    """``shard_map`` on a DeviceMesh: each argument (a DTensor, or a plain
    tensor taken as replicated) laid out by its pspec in ``in_specs``
    (``None``: passed as it is, e.g. a position) and handed to ``fn`` as
    its local shard; ``fn``'s outputs (a tuple) become DTensors by
    ``out_specs``.  A local shard is a view of its DTensor's storage
    when the layout is already the pspec's, so ``fn`` may write into it
    in place.

    ``split_axes`` names the mesh axes over which ``fn`` does a different
    share of the work on each rank: an argument whole over such an axis
    gets the sum of the ranks' gradients there (``Partial``), one whole
    over another axis (where every rank computes the same) the common
    gradient."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    names = list(mesh.mesh_dim_names)
    local = []
    for a, spec in zip(args, in_specs):
        if spec is None:
            local.append(a)
            continue
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        pl = _layout(mesh, placements(mesh, spec))
        if not has_layout(a, spec):
            a = a.redistribute(mesh, pl)
        grad = [Partial() if isinstance(p, Replicate)
                and names[i] in split_axes else p
                for i, p in enumerate(pl)]
        local.append(a.to_local(grad_placements=grad))
    outs = fn(*local)
    return tuple(DTensor.from_local(o, mesh, _layout(mesh, placements(
        mesh, spec)), run_check=False) for o, spec in zip(outs, out_specs))


def _layout(mesh, pl) -> tuple:
    """Placements with a split over a mesh axis of size 1 (no split)
    read as ``Replicate``."""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() if mesh.size(i) == 1 else p
                 for i, p in enumerate(pl))


def has_layout(x, spec) -> bool:
    """True when DTensor ``x`` is laid out as ``spec`` says (so its local
    shard is the one :func:`map_local` hands on, a view)."""
    mesh = x.device_mesh
    return _layout(mesh, x.placements) == _layout(mesh,
                                                  placements(mesh, spec))


def all_reduce(x, op: str, mesh, axis):
    """``psum`` (``op="sum"``) or ``pmax`` (``"max"``) of a local tensor
    over one mesh axis (or several, one after the other), inside
    :func:`map_local`: a functional collective
    (``_c10d_functional.all_reduce``), which the dry run's counter sees.
    A sum's gradient passes each rank's own cotangent through unchanged:
    the sum's output is whole on every rank, so each rank's cotangent is
    already the whole one, and every share of the sum has that derivative
    (the true gradient; a psum's transpose would sum it again).  ``max``
    has no gradient (the decode combine)."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    for a in axes:
        if op == "sum":
            x = _sum_same_grad().apply(x, mesh.get_group(a))
        else:
            import torch.distributed._functional_collectives as funcol
            x = funcol.wait_tensor(funcol.all_reduce(x, op,
                                                     mesh.get_group(a)))
    return x


@functools.lru_cache(maxsize=None)
def _sum_same_grad():
    """The autograd Function of :func:`all_reduce`'s sum (made on first
    use: this module imports without torch)."""
    import torch

    class SumSameGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group):
            import torch.distributed._functional_collectives as funcol
            return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

        @staticmethod
        def backward(ctx, g):
            return g, None
    return SumSameGrad


def local_range(x, dim: int) -> Tuple[int, int]:
    """``[start, stop)`` of this rank's shard of DTensor ``x`` along
    ``dim``: DTensor's ``torch.chunk`` split, mesh dims left to right."""
    from torch.distributed.tensor import Shard
    start, n = 0, x.shape[dim]
    for i, pl in enumerate(x.placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            size = -(-n // x.device_mesh.size(i))
            at = min(x.device_mesh.get_local_rank(i) * size, n)
            start, n = start + at, min(size, n - at)
    return start, start + n


def full(x):
    """The global value of a DTensor (every rank gathers); a plain
    tensor passes through."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x
