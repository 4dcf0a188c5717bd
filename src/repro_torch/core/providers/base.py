"""Strategy-provider base class: ComParX's analogue of an S2S compiler.

Each provider turns (arch config, mesh axis sizes, flag subset, segment)
into a logical->physical sharding mapping, a plain dict.  The flags,
``applicable`` and ``mapping`` are the reference's
(``src/repro/core/providers/``).  ``core.plan.build_contexts`` turns a
mapping into the segment's ``runtime.sharding.Rules`` on the mesh;
without a mesh it resolves nothing, and ``combinator.mapping_key`` is
``"local"``, so every provider builds the same program on a segment.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, Mapping

from repro_torch.configs.base import ArchConfig
from repro_torch.core.segment import Segment

# logical axes that are never sharded, shared by every provider
_COMMON = {"layers": None, "head_dim": None, "conv": None}


class Provider:
    name: str = "base"
    #: flag name -> description (the "compiler flags" of this provider)
    flags: Dict[str, str] = {}

    def applicable(self, cfg: ArchConfig, segment: Segment) -> bool:
        return True

    def mapping(self, cfg: ArchConfig, mesh_axes: Mapping[str, int],
                flags: FrozenSet[str], segment: Segment) -> Dict[str, object]:
        raise NotImplementedError

    def _common(self) -> Dict[str, object]:
        return dict(_COMMON)

    @staticmethod
    def _kv_strategy(cfg: ArchConfig, mesh_axes: Mapping[str, int]):
        """Shard kv heads on the model axis when divisible, else shard the
        KV-cache sequence dim."""
        tp = mesh_axes.get("model", 1)
        if cfg.num_kv_heads % tp == 0:
            return {"kv_heads": "model", "kv_seq": None}
        return {"kv_heads": None, "kv_seq": "model"}

    def describe(self) -> str:
        return f"{self.name}: flags={sorted(self.flags)}"


_REGISTRY: Dict[str, Provider] = {}


def register(p: Provider) -> Provider:
    _REGISTRY[p.name] = p
    return p


def get_provider(name: str) -> Provider:
    return _REGISTRY[name]


def all_providers():
    return dict(_REGISTRY)
