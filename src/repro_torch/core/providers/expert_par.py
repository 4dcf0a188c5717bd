"""ExpertPar: expert parallelism for MoE segments — experts over the
``model`` axis, all-to-all style dispatch, optional TP attention."""
from __future__ import annotations

from repro_torch.core.providers.base import Provider, register


class ExpertPar(Provider):
    name = "expert_par"
    flags = {
        "tp_attention": "also tensor-shard attention heads over model",
        "fsdp_dense": "FSDP the non-expert params over the data axis",
        "2d_experts": "shard expert ffn dim over data (experts x data 2D)",
    }

    def applicable(self, cfg, segment):
        return segment.kind != "stack" or segment.has_moe

    def mapping(self, cfg, mesh_axes, flags, segment):
        dense_axis = ["data", None] if "fsdp_dense" in flags else None
        m = self._common()
        m.update({
            "experts": ["model", None],
            "expert_ffn": (["data", None] if "2d_experts" in flags
                           else None),
            "embed": dense_axis,
            "vocab": dense_axis,
            "ffn": dense_axis,
            "rnn": dense_axis,
            "heads": ["model", None] if "tp_attention" in flags else None,
            "batch": [("pod", "data"), None],
            "seq": None,
        })
        if "tp_attention" in flags:
            m.update(self._kv_strategy(cfg, mesh_axes))
        else:
            m.update({"kv_heads": None, "kv_seq": None})
        return m


register(ExpertPar())
