"""Architecture registry: ``--arch <id>`` lookup.

Lists only the archs the port can run today: dense ``attn`` stacks with
full RoPE and no sliding window.  Every other arch of the reference
registry raises ``KeyError`` naming the ROADMAP item that brings it.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeConfig, SHAPES
from repro_torch.configs.granite_8b import CONFIG as _granite
from repro_torch.configs.stablelm_3b import CONFIG as _stablelm

ARCHS = {c.name: c for c in (_granite, _stablelm)}

#: reference archs the port does not run yet -> the ROADMAP item bringing it
PENDING = {
    "xlstm-125m": "ROADMAP Queue 1 item 9 (recurrent and MoE archs)",
    "recurrentgemma-2b": "ROADMAP Queue 1 item 9 (recurrent and MoE archs)",
    "qwen3-moe-30b-a3b": "ROADMAP Queue 1 item 9 (recurrent and MoE archs)",
    "kimi-k2-1t-a32b": "ROADMAP Queue 1 item 9 (recurrent and MoE archs)",
    "chatglm3-6b": "ROADMAP Queue 1 item 12 (remaining dense archs)",
    "starcoder2-3b": "ROADMAP Queue 1 item 12 (remaining dense archs)",
    "phi-3-vision-4.2b": "ROADMAP Queue 1 item 12 (remaining dense archs)",
    "musicgen-large": "ROADMAP Queue 1 item 12 (remaining dense archs)",
}


def get_arch(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return get_arch(name[: -len("-smoke")]).smoke()
    if name in PENDING:
        raise KeyError(f"arch {name!r} is not ported yet: {PENDING[name]}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name.endswith("-smoke"):
        return get_shape(name[: -len("-smoke")]).smoke()
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; have {sorted(SHAPES)}")
    return SHAPES[name]
