"""Meshes and process groups for the port (the reference's
``src/repro/launch/mesh.py``).

A ``DeviceMesh`` spans the ranks of a ``torch.distributed`` process group,
one device per rank, where a ``jax.Mesh`` spans one process's devices.  So
a mesh needs a default group of as many ranks as the mesh has devices:
``torchrun`` (or the caller) makes it, or :func:`ensure_group` makes a
world-size-1 group for a one-device mesh.  NCCL puts no two ranks on one
GPU, so one card holds only the (1, 1) mesh; larger meshes run under gloo
on the CPU.

``make_production_mesh`` raises :class:`MeshUnsatisfiable` unless the
default group has the production pod's 256 (or 512) ranks.  The dry run
opens such a group with :func:`fake_group`: a default group on torch's
``fake`` backend, whose collectives move nothing, where the reference sets
``--xla_force_host_platform_device_count``.  A process holds one default
group, so a fake group refuses to open over a real one, and the wall-clock
executor refuses to time on a fake one (:class:`FakeGroupError`).
"""
from __future__ import annotations

import contextlib
import os
import tempfile
from datetime import timedelta
from typing import Optional, Sequence

from repro_torch.core.meshspec import MeshSpec, MeshUnsatisfiable, _MESH_CACHE

#: how long a collective or the group's rendezvous may wait
GROUP_TIMEOUT_S = 120

#: the store file of the group ensure_group made, to remove on destroy
_OWN_STORE: list = []

#: where ensure_group makes its store's directory (None: the temp dir);
#: a process worker sets it to its parent's temp dir, which a forkserver's
#: environment may not name
STORE_ROOT: Optional[str] = None


class FakeGroupError(RuntimeError):
    """A fake process group where a real one is needed (or the reverse)."""


def world_size() -> Optional[int]:
    """The default group's world size, or None without a group."""
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized():
        return None
    return dist.get_world_size()


def default_device_type() -> str:
    """The default group's device type (``nccl``: the card, ``gloo``: the
    CPU); without a group, the card when there is one, else the CPU."""
    import torch
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return "cuda" if dist.get_backend() == "nccl" else "cpu"
    return "cuda" if torch.cuda.is_available() else "cpu"


def is_fake_group() -> bool:
    """True when the default group is a :func:`fake_group`."""
    import torch.distributed as dist
    return (dist.is_available() and dist.is_initialized()
            and dist.get_backend() == "fake")


@contextlib.contextmanager
def fake_group(world: int):
    """A default group of ``world`` ranks on torch's ``fake`` backend, as
    rank 0, destroyed on exit: meshes of up to ``world`` devices build on
    it, and their collectives return at once without moving data (fake
    tensors stand for the data).  Refuses to open while a default group
    exists."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if world_size() is not None:
        raise FakeGroupError(
            f"a fake group of {world} ranks cannot open: this process "
            f"already has a default group ({dist.get_backend()}, "
            f"{world_size()} ranks)")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(world))
    try:
        yield
    finally:
        destroy_group()


def backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def init_group(device_type: str, rank: int, world: int, store_path: str,
               timeout_s: float = GROUP_TIMEOUT_S):
    """Join the default group of ``world`` ranks through a ``file://``
    store at ``store_path`` (``nccl`` for ``cuda``, ``gloo`` for
    ``cpu``).  On the card each rank takes the device of its rank."""
    import torch
    import torch.distributed as dist
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend_for(device_type),
                            init_method=f"file://{store_path}", rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=timeout_s))


def ensure_group(device_type: str):
    """A default group: the existing one, or a new world-size-1 group
    through a ``file://`` store in a fresh temporary directory."""
    if world_size() is not None:
        return
    d = tempfile.mkdtemp(prefix="repro_torch_pg_", dir=STORE_ROOT)
    path = os.path.join(d, "store")
    init_group(device_type, 0, 1, path)
    _OWN_STORE.append(d)


def destroy_group():
    """Destroy the default group (if any), forget the meshes built on it
    and remove the store ``ensure_group`` made."""
    import shutil
    import torch.distributed as dist
    _MESH_CACHE.clear()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    while _OWN_STORE:
        shutil.rmtree(_OWN_STORE.pop(), ignore_errors=True)


def device_mesh(shape: Sequence[int], axis_names: Sequence[str],
                device_type: str):
    """A DeviceMesh of ``shape`` over the default group's ranks (made at
    world size 1 for a one-device shape when there is none; over the first
    ranks of a larger fake group)."""
    import math
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    if n == 1:
        ensure_group(device_type)
    have = world_size()
    # a fake group's first n ranks hold any smaller mesh: its collectives
    # never wait on the ranks left out
    if have != n and not (is_fake_group() and have > n):
        raise MeshUnsatisfiable(
            f"a {tuple(shape)} mesh needs a group of {n} ranks; the default "
            f"group has {have}")
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """The production pod's (16, 16) ``data x model`` mesh, or two pods'
    (2, 16, 16); it needs a group of 256 (512) ranks, which the dry run
    opens with :func:`fake_group`."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if is_fake_group():
        # MeshSpec.check_local asks for a card the fake group never uses
        return device_mesh(shape, axes, device_type)
    return MeshSpec(tuple(zip(axes, shape)), device_type).to_mesh()


def make_test_mesh(data: int = 1, model: int = 1, device_type: str = ""):
    """A ``data x model`` mesh from however many ranks the default group
    has (a world-size-1 group is made when there is none), shrunk as the
    reference shrinks it to the devices it finds."""
    n = world_size() or 1
    data = min(data, n)
    model = min(model, max(1, n // data))
    if data * model != n:
        raise MeshUnsatisfiable(f"a ({data}, {model}) mesh does not cover "
                                f"the group's {n} ranks")
    return device_mesh((data, model), ("data", "model"),
                       device_type or default_device_type())


def launch_mesh(device):
    """A ``(world, 1)`` data mesh when the launcher (``torchrun``: RANK,
    WORLD_SIZE and MASTER_ADDR/PORT in the environment) runs more than one
    rank, joining the default group first; None for one process.  The
    reference's ``launch/train.py`` takes a data mesh over its devices."""
    import torch
    import torch.distributed as dist
    dev = torch.device(device)
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend_for(dev.type),
                                timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    return make_test_mesh(data=dist.get_world_size(), device_type=dev.type)


def mesh_chips(mesh) -> int:
    return int(mesh.size()) if mesh is not None else 1
