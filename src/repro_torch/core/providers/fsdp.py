"""FullyShardedDP: ZeRO-3 — params sharded, gathered per use;
gradients reduce-scattered; pure data-parallel activations."""
from __future__ import annotations

from repro_torch.core.providers.base import Provider, register


class FullyShardedDP(Provider):
    name = "fsdp"
    flags = {
        "shard_both_axes": "shard params over (data, model), not just data",
        "dp_over_model": "also use the model axis for batch data-parallelism",
    }

    def mapping(self, cfg, mesh_axes, flags, segment):
        fs = ("data", "model") if "shard_both_axes" in flags else ("data",)
        m = self._common()
        m.update({
            # used-axis tracking shards exactly one (leading) dim per param
            "embed": [fs, None],
            "vocab": [fs, None],
            "ffn": [fs, None],
            "expert_ffn": [fs, None],
            "experts": [fs, None],
            "rnn": [fs, None],
            "heads": [fs, None],
            "kv_heads": None,
            "kv_seq": None,
            "seq": None,
            "batch": ([("pod", "data", "model"), ("pod", "data"), None]
                      if "dp_over_model" in flags
                      else [("pod", "data"), None]),
        })
        return m


register(FullyShardedDP())
