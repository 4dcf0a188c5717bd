"""TensorPar: Megatron-style tensor parallelism over the ``model`` axis."""
from __future__ import annotations

from repro_torch.core.providers.base import Provider, register


class TensorPar(Provider):
    name = "tensor_par"
    flags = {
        "shard_vocab": "shard embedding/logits over the model axis",
        "seq_parallel": "Megatron-SP: shard the residual stream's seq dim",
    }

    def mapping(self, cfg, mesh_axes, flags, segment):
        m = self._common()
        m.update({
            "heads": ["model", None],
            "ffn": ["model", None],
            "expert_ffn": ["model", None],
            "rnn": ["model", None],
            "experts": None,
            "embed": None,
            "vocab": "model" if "shard_vocab" in flags else None,
            "batch": [("pod", "data"), None],
            "seq": "model" if "seq_parallel" in flags else None,
        })
        m.update(self._kv_strategy(cfg, mesh_axes))
        return m


register(TensorPar())
