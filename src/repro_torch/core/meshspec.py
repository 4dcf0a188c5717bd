"""MeshSpec: the declarative, wire-serializable mesh/topology point.

The counterpart of the reference's ``src/repro/core/meshspec.py``.  A
live mesh cannot cross a process boundary, so a :class:`MeshSpec` holds
its content without devices: ordered ``(axis name, size)`` pairs and the
device platform it must materialize on.  It is JSON on the wire, and
whichever process scores a job calls :meth:`MeshSpec.to_mesh` to rebuild
the mesh for itself.  ``key()`` and ``mid`` are the reference's strings
and hashes byte for byte, so DB rows keyed by a mesh interoperate.

MeshSpec is also the sweep's second outer axis
(``ComParTuner.sweep(mesh_space=[...])``).  The local point (no mesh) is
``MeshSpec(())``: ``to_mesh()`` returns ``None`` and ``mid == "local"``.

Named departures from the reference, which builds a ``jax.Mesh`` over the
devices of one process:

* ``to_mesh()`` builds a ``torch.distributed`` ``DeviceMesh`` over the
  ranks of the default process group, one device per rank (SPMD).  A
  spec of one device makes a world-size-1 group when there is none
  (``nccl`` on the card, ``gloo`` on the CPU; ``launch/mesh.py``).  A
  spec of ``n`` devices needs a group of exactly ``n`` ranks, else it
  raises :class:`MeshUnsatisfiable`.
* ``device_kind`` names a torch device type (``"cuda"``, ``"cpu"``); an
  empty kind ("any") takes the default group's device type, else the
  card when there is one, else the CPU.
* :func:`default_mesh_space` counts the default group's world size (1
  without a group), where the reference counts ``jax.device_count()``.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

#: version of the mesh content key (the reference's: v2 is the MeshSpec
#: content hash)
MESH_KEY_VERSION = 2


class MeshUnsatisfiable(ValueError):
    """This process cannot materialize the spec.  A protocol error on the
    scoring server (HTTP 400), not a transient outage."""


@dataclass(frozen=True)
class MeshSpec:
    """Axis names + sizes + device kind; ``()`` axes = the local point."""

    axes: Tuple[Tuple[str, int], ...] = ()
    device_kind: str = ""               # "" = the local default platform

    def __post_init__(self):
        axes = self.axes.items() if isinstance(self.axes, dict) else self.axes
        object.__setattr__(
            self, "axes", tuple((str(n), int(s)) for n, s in axes))
        for name, size in self.axes:
            if size < 1:
                raise ValueError(f"mesh axis {name!r} has size {size}")

    @classmethod
    def of(cls, device_kind: str = "", **axes: int) -> "MeshSpec":
        """``MeshSpec.of(data=2, model=2)`` (kwarg order = axis order)."""
        return cls(tuple(axes.items()), device_kind)

    @classmethod
    def from_mesh(cls, mesh) -> "MeshSpec":
        """The spec of a live DeviceMesh (or a mesh-like object with
        ``axis_names`` and ``devices.shape``); ``device_kind`` is left
        unconstrained, as the reference leaves it."""
        from repro_torch.runtime.sharding import mesh_axis_sizes
        return cls(tuple(mesh_axis_sizes(mesh).items()))

    @property
    def is_local(self) -> bool:
        return not self.axes

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.axes)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(s for _, s in self.axes)

    @property
    def n_devices(self) -> int:
        n = 1
        for _, s in self.axes:
            n *= s
        return n

    def axis_sizes(self) -> Dict[str, int]:
        return dict(self.axes)

    def key(self) -> str:
        """Human-readable point label."""
        if self.is_local:
            return "local"
        body = "x".join(f"{n}{s}" for n, s in self.axes)
        return f"{body}[{self.device_kind or 'any'}]"

    @property
    def mid(self) -> str:
        """Versioned content id: keys DB rows, incumbent scopes and the
        ``score_cache.mesh`` column; ``"local"`` for the local point."""
        if self.is_local:
            return "local"
        blob = json.dumps({"v": MESH_KEY_VERSION,
                           "axes": [list(a) for a in self.axes],
                           "kind": self.device_kind}, sort_keys=True)
        return hashlib.sha1(blob.encode()).hexdigest()[:12]

    def to_json(self) -> Dict:
        return {"axes": [list(a) for a in self.axes],
                "device_kind": self.device_kind}

    @classmethod
    def from_json(cls, d: Dict) -> "MeshSpec":
        return cls(tuple((n, int(s)) for n, s in d.get("axes") or ()),
                   str(d.get("device_kind", "")))

    def device_type(self) -> str:
        """The torch device type the spec materializes on: its
        ``device_kind``; for an empty kind ("any", as the reference's),
        the default group's (``nccl``: the card, ``gloo``: the CPU), else
        the card when there is one, else the CPU."""
        if self.device_kind:
            return self.device_kind
        from repro_torch.launch.mesh import default_device_type
        return default_device_type()

    def check_local(self):
        """Raise :class:`MeshUnsatisfiable` unless this process can
        materialize the spec: one rank per device, in a default group of
        exactly ``n_devices`` ranks (one device needs no group yet), or
        of at least that many on a fake group (``launch.mesh.fake_group``,
        the dry run's)."""
        if self.is_local:
            return
        from repro_torch.launch.mesh import is_fake_group, world_size
        kind = self.device_type()
        if kind not in ("cuda", "cpu"):
            raise MeshUnsatisfiable(f"mesh {self.key()}: no device type "
                                    f"{kind!r} here")
        if kind == "cuda":
            import torch
            if not torch.cuda.is_available():
                raise MeshUnsatisfiable(f"mesh {self.key()} needs 'cuda' "
                                        f"devices; this process has none")
        have = world_size()
        if have is None:
            have = 1
        if have != self.n_devices and not (is_fake_group()
                                           and have > self.n_devices):
            raise MeshUnsatisfiable(
                f"mesh {self.key()} needs {self.n_devices} {kind!r} "
                f"rank(s); this process group has {have}")

    def to_mesh(self):
        """Materialize against the default process group (``None`` for
        the local point); a one-device spec makes a world-size-1 group
        when none exists.  Raises :class:`MeshUnsatisfiable`."""
        if self.is_local:
            return None
        self.check_local()
        from repro_torch.launch.mesh import device_mesh
        return device_mesh(self.shape, self.axis_names, self.device_type())


#: the local (meshless) sweep point
LOCAL = MeshSpec(())


def as_mesh_point(m) -> MeshSpec:
    """Coerce one ``mesh_space`` entry: ``None`` -> the local point,
    dicts -> spec (``{"data": 2}`` shorthand or the wire form), live
    meshes -> :meth:`MeshSpec.from_mesh`."""
    if m is None:
        return LOCAL
    if isinstance(m, MeshSpec):
        return m
    if isinstance(m, dict):
        if "axes" in m:
            return MeshSpec.from_json(m)
        d = dict(m)
        kind = d.pop("device_kind", "")
        return MeshSpec(tuple(d.items()), str(kind or ""))
    if getattr(m, "mesh_dim_names", None) is not None or (
            hasattr(m, "axis_names") and hasattr(m, "devices")):
        return MeshSpec.from_mesh(m)
    raise TypeError(f"not a mesh point: {m!r}")


#: spec.mid -> materialized DeviceMesh, per process (a process's group is
#: fixed while it lives; ``launch.mesh.destroy_group`` clears this)
_MESH_CACHE: Dict[str, object] = {}


def cached_mesh(spec: Optional[MeshSpec]):
    """``spec.to_mesh()`` memoized per process (None passes through)."""
    if spec is None or spec.is_local:
        return None
    mesh = _MESH_CACHE.get(spec.mid)
    if mesh is None:
        mesh = spec.to_mesh()
        _MESH_CACHE[spec.mid] = mesh
    return mesh


def live_mesh(m):
    """A live DeviceMesh for any mesh value: a DeviceMesh as it is, a
    MeshSpec (or its dict shorthand) materialized once per process
    (:func:`cached_mesh`); None passes through."""
    if m is None or getattr(m, "mesh_dim_names", None) is not None:
        return m
    return cached_mesh(as_mesh_point(m))


def default_mesh_space(device_count: Optional[int] = None,
                       device_kind: str = "") -> List[MeshSpec]:
    """The local point, the flat data ring, and every 2-D ``data x
    model`` factorization of ``device_count``, data-major, as the
    reference's.  ``device_count=None`` counts the default group's world
    size (1 without a group), where the reference counts
    ``jax.device_count()``."""
    if device_count is None:
        from repro_torch.launch.mesh import world_size
        device_count = world_size() or 1
    n = int(device_count)
    out = [LOCAL]
    if n <= 1:
        return out
    out.append(MeshSpec((("data", n),), device_kind))
    pairs = []
    for a in range(2, n + 1):
        if n % a == 0 and n // a >= 2:
            pairs.append((a, n // a))
    for a, b in sorted(pairs, key=lambda p: (-p[0], p[1])):
        out.append(MeshSpec((("data", a), ("model", b)), device_kind))
    return out
