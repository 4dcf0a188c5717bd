"""Parameter-spec system.

A model is declared as a nested dict of :class:`ParamSpec` leaves (shape,
dtype, init and logical axes), the same tree the reference declares, so a
parameter's path names the same tensor in both packages.  ``layers`` is the
leading dim of a scan group's stacked leaves.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.device import resolve_device

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}

#: the most elements ``init_params`` draws at once (its f32 temporary:
#: 4 GiB); larger draws go in slices along their first axis
MAX_DRAW = 2 ** 30


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical_axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones
    scale: float = 1.0            # stddev for normal init
    dtype: str = "bfloat16"

    def __post_init__(self):
        if len(self.shape) != len(self.logical_axes):
            raise ValueError(f"shape {self.shape} vs axes "
                             f"{self.logical_axes}")

    @property
    def tdtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    def stacked(self, n: int) -> "ParamSpec":
        """Add a leading scan ("layers") dim of size n."""
        return dataclasses.replace(
            self, shape=(n,) + tuple(self.shape),
            logical_axes=("layers",) + tuple(self.logical_axes))


class TensorSpec(NamedTuple):
    """Shape and dtype of a state tensor (the decode caches)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


# --- nested-dict trees -------------------------------------------------------

def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, path: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked tree (views: writes land in the stack)."""
    return tree_map(lambda t: t[i], tree)


# --- init ------------------------------------------------------------------

def leaf_seed(root: int, path: Tuple[str, ...]) -> int:
    """Per-leaf seed from the root seed and the leaf's path.

    ``zlib.crc32`` is stable across processes, unlike ``hash(str)``.
    """
    name = "/".join(path)
    return (root * 1_000_003 + zlib.crc32(name.encode())) % (2 ** 63 - 1)


def init_params(specs, generator: torch.Generator, device="cuda"):
    """Materialize a spec tree into tensors on ``device``.

    Each leaf draws from its own generator, seeded from
    ``generator.initial_seed()`` and the leaf's path, on the target device.
    Stacked leaves are drawn one layer slice at a time, so a full-width
    stack never needs an f32 copy of the whole leaf, and a draw of more
    than ``MAX_DRAW`` elements (kimi-k2's embedding and expert leaves) in
    consecutive slices along its first axis.
    """
    dev = resolve_device(device)
    root = generator.initial_seed()

    def init_one(path, spec: ParamSpec):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=spec.tdtype, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=spec.tdtype, device=dev)
        g = torch.Generator(device=dev)
        g.manual_seed(leaf_seed(root, path))

        def draw_once(shape):
            x = torch.randn(shape, generator=g, device=dev,
                            dtype=torch.float32)
            return x.mul_(spec.scale).to(spec.tdtype)

        def draw(shape):
            if math.prod(shape) <= MAX_DRAW:
                return draw_once(shape)
            out = torch.empty(shape, dtype=spec.tdtype, device=dev)
            rows = max(1, MAX_DRAW // math.prod(shape[1:]))
            for i in range(0, shape[0], rows):
                n = min(rows, shape[0] - i)
                out[i:i + n] = draw_once((n,) + tuple(shape[1:]))
            return out

        if spec.logical_axes[0] != "layers":
            return draw(spec.shape)
        out = torch.empty(spec.shape, dtype=spec.tdtype, device=dev)
        for i in range(spec.shape[0]):
            out[i] = draw(spec.shape[1:])
        return out

    return tree_map_with_path(init_one, specs)


def abstract_params(specs):
    """Spec tree -> :class:`TensorSpec` tree (no allocation; for the dry
    run, which makes them fake tensors: :func:`fake_tensors`)."""
    return tree_map(lambda s: TensorSpec(tuple(s.shape), s.tdtype), specs)


def fake_tensors(spec_tree, device="cpu"):
    """A tree of :class:`TensorSpec` (or :class:`ParamSpec`) as
    uninitialised tensors on ``device``: under ``FakeTensorMode``, fake
    tensors that hold no memory."""
    def make(s):
        dt = s.tdtype if isinstance(s, ParamSpec) else s.dtype
        return torch.empty(s.shape, dtype=dt, device=device)
    return tree_map(make, spec_tree)


def stack_specs(specs, n: int):
    """Stack a block's spec tree along a new leading scan dim."""
    return tree_map(lambda s: s.stacked(n), specs)


def param_count(specs) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(specs))



# --- sharding ------------------------------------------------------------------

def param_pspecs(specs, rules):
    """Spec tree -> pspec tree under ``rules`` (a
    :class:`repro_torch.runtime.sharding.Rules`), as the reference's."""
    return tree_map(lambda s: rules.pspec(s.logical_axes, s.shape), specs)


def place_params(params, specs, seg_rules):
    """Place a full parameter tree (every rank holds the same values, from
    ``init_params`` or ``models/convert.py``) on the mesh of
    ``seg_rules`` (``core.plan.segment_rules``): each leaf becomes a
    DTensor laid out by its segment's ``param_pspecs``, each rank keeping
    its own shard.  A leaf that requires grad stays a leaf that does."""
    return {seg: tree_map(lambda t, s: seg_rules[seg].distribute(
        t, s.logical_axes), tree, specs[seg])
        for seg, tree in params.items()}
