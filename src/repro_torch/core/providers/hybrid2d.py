"""Hybrid2D: FSDP over ``data`` x tensor-parallel over ``model``
(the MaxText-style 2D default for dense training)."""
from __future__ import annotations

from repro_torch.core.providers.base import Provider, register


class Hybrid2D(Provider):
    name = "hybrid2d"
    flags = {
        "seq_parallel": "shard the residual stream's seq dim over model",
        "shard_vocab": "shard embedding/logits over the model axis",
    }

    def mapping(self, cfg, mesh_axes, flags, segment):
        m = self._common()
        m.update({
            "embed": ["data", None],          # fsdp'd weight dim
            "heads": ["model", None],
            "ffn": ["model", None],
            "experts": ["model", None],
            "expert_ffn": ["model", None],
            "rnn": ["model", None],
            "vocab": "model" if "shard_vocab" in flags else ["data", None],
            "batch": [("pod", "data"), None],
            "seq": "model" if "seq_parallel" in flags else None,
        })
        m.update(self._kv_strategy(cfg, mesh_axes))
        return m


register(Hybrid2D())
