"""Architecture registry: ``--arch <id>`` lookup.

Lists only the archs the port can run today: dense ``attn`` stacks with
full RoPE (granite-8b, stablelm-3b), the recurrent archs
(recurrentgemma-2b: RG-LRU + local attention; xlstm-125m: mLSTM +
sLSTM) and the MoE archs (qwen3-moe-30b-a3b, kimi-k2-1t-a32b:
``attn_moe`` stacks with sorted dispatch).  Every other arch of the
reference registry raises ``KeyError`` naming the ROADMAP item that
brings it.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeConfig, SHAPES
from repro_torch.configs.granite_8b import CONFIG as _granite
from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as _kimi
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as _qwen3
from repro_torch.configs.recurrentgemma_2b import CONFIG as _rg
from repro_torch.configs.stablelm_3b import CONFIG as _stablelm
from repro_torch.configs.xlstm_125m import CONFIG as _xlstm

ARCHS = {c.name: c for c in (_granite, _stablelm, _rg, _xlstm, _qwen3,
                              _kimi)}

#: reference archs the port does not run yet -> the ROADMAP item bringing it
PENDING = {
    "chatglm3-6b": "ROADMAP Queue 1 item 6 (remaining dense archs)",
    "starcoder2-3b": "ROADMAP Queue 1 item 6 (remaining dense archs)",
    "phi-3-vision-4.2b": "ROADMAP Queue 1 item 6 (remaining dense archs)",
    "musicgen-large": "ROADMAP Queue 1 item 6 (remaining dense archs)",
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
