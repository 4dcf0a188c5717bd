"""Architecture registry: ``--arch <id>`` lookup and the config wire
format, as the reference's ``src/repro/configs/registry.py``.

Lists every arch of the reference registry, in its order: dense ``attn``
stacks (stablelm-3b, granite-8b, chatglm3-6b with RoPE ``2d``,
starcoder2-3b with a 4096 window, LayerNorm and a tied head,
phi-3-vision-4.2b and musicgen-large, whose stub frontends feed
``embeds``), the MoE archs (qwen3-moe-30b-a3b, kimi-k2-1t-a32b:
``attn_moe`` stacks with sorted dispatch) and the recurrent archs
(recurrentgemma-2b: RG-LRU + local attention; xlstm-125m: mLSTM +
sLSTM).

``arch_to_spec`` / ``shape_to_spec`` serialize a config for the sweep
backends' JobSpec wire format (process workers and the scoring server).
Deserialization prefers the registry: a spec whose name resolves to a
field-identical registry config (the ``-smoke`` derivations included)
returns the canonical object; an ad-hoc config is rebuilt from its
serialized fields.
"""
from __future__ import annotations

import dataclasses
import json

from repro_torch.configs.base import (ArchConfig, ShapeConfig, SHAPES,
                                      shape_applies)
from repro_torch.configs.chatglm3_6b import CONFIG as _chatglm
from repro_torch.configs.granite_8b import CONFIG as _granite
from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as _kimi
from repro_torch.configs.musicgen_large import CONFIG as _musicgen
from repro_torch.configs.phi3_vision_4_2b import CONFIG as _phi3v
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as _qwen3
from repro_torch.configs.recurrentgemma_2b import CONFIG as _rg
from repro_torch.configs.stablelm_3b import CONFIG as _stablelm
from repro_torch.configs.starcoder2_3b import CONFIG as _starcoder
from repro_torch.configs.xlstm_125m import CONFIG as _xlstm

ARCHS = {c.name: c for c in (
    _xlstm, _stablelm, _granite, _chatglm, _starcoder,
    _phi3v, _qwen3, _kimi, _rg, _musicgen,
)}


def get_arch(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return get_arch(name[: -len("-smoke")]).smoke()
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name.endswith("-smoke"):
        return get_shape(name[: -len("-smoke")]).smoke()
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; have {sorted(SHAPES)}")
    return SHAPES[name]


def _jsonable(d: dict) -> dict:
    """Normalize through JSON (tuples -> lists) for field comparison."""
    return json.loads(json.dumps(d, sort_keys=True, default=str))


def arch_to_spec(cfg: ArchConfig) -> dict:
    return {"name": cfg.name, "fields": _jsonable(dataclasses.asdict(cfg))}


def arch_from_spec(spec: dict) -> ArchConfig:
    try:
        cand = get_arch(spec["name"])
        if _jsonable(dataclasses.asdict(cand)) == _jsonable(spec["fields"]):
            return cand
    except KeyError:
        pass
    fields = dict(spec["fields"])
    fields["block_pattern"] = tuple(fields.get("block_pattern") or ("attn",))
    return ArchConfig(**fields)


def shape_to_spec(shape: ShapeConfig) -> dict:
    return {"name": shape.name, "fields": _jsonable(dataclasses.asdict(shape))}


def shape_from_spec(spec: dict) -> ShapeConfig:
    try:
        cand = get_shape(spec["name"])
        if _jsonable(dataclasses.asdict(cand)) == _jsonable(spec["fields"]):
            return cand
    except KeyError:
        pass
    return ShapeConfig(**spec["fields"])


def all_cells():
    """Every (arch x shape) cell of the registered archs, with its
    applicability flag."""
    for a in ARCHS.values():
        for s in SHAPES.values():
            yield a, s, shape_applies(a, s)
