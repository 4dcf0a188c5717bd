"""Deterministic, resumable, host-sharded synthetic LM data pipeline.

Every batch is a pure function of (seed, step, host slice), as in the
reference (``src/repro/data/pipeline.py``), so a restart at step k replays
exactly the same stream and each host draws only its slice of the global
batch.  The token stream is the reference's mixture of structured patterns
(repeated n-gram motifs and ramps), so a small model trained on it shows a
real loss curve.

The tokens are drawn on the CPU by a ``torch.Generator`` seeded from
(seed, step, host index) and then moved to the device: the same tokens on
every device.  They are not the reference's tokens (``jax.random`` streams
cannot be reproduced in torch); parity tests feed the reference's batches
through numpy instead.  The reference's ``"embeds"`` input of the vlm/audio
stub frontends comes with those archs (ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import resolve_device

MOTIF_LEN = 16
N_MOTIFS = 32
RAMP_P = 0.3


@dataclass
class DataState:
    """Serializable pipeline position (goes into every checkpoint)."""
    seed: int
    step: int

    def as_dict(self):
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_dict(cls, d):
        return cls(int(d["seed"]), int(d["step"]))


def _batch_tokens(gen: torch.Generator, batch: int, seq: int,
                  vocab: int) -> torch.Tensor:
    """Structured pseudo-language: motif repetition + local ramps."""
    motifs = torch.randint(0, vocab, (N_MOTIFS, MOTIF_LEN), generator=gen)
    idx = torch.randint(0, N_MOTIFS, (batch, -(-seq // MOTIF_LEN)),
                        generator=gen)
    base = motifs[idx].reshape(batch, -1)[:, :seq]
    ramp = (torch.arange(seq)[None, :]
            + torch.randint(0, vocab, (batch, 1), generator=gen)) % vocab
    use_ramp = torch.rand((batch, 1), generator=gen) < RAMP_P
    return torch.where(use_ramp, ramp, base)


class SyntheticLM:
    def __init__(self, cfg: ArchConfig, shape: ShapeConfig, *,
                 seed: int = 0, host_index: int = 0, host_count: int = 1,
                 device="cuda"):
        if shape.global_batch % host_count and host_count != 1:
            raise ValueError(f"global batch {shape.global_batch} does not "
                             f"split over {host_count} hosts")
        self.cfg = cfg
        self.shape = shape
        self.device = resolve_device(device)
        self.state = DataState(seed, 0)
        self.host_index = host_index
        self.host_count = host_count
        self.local_batch = max(1, shape.global_batch // host_count)

    def _generator(self, step: int) -> torch.Generator:
        words = np.random.SeedSequence(
            [self.state.seed, step, self.host_index]).generate_state(2)
        return torch.Generator().manual_seed(
            int(words[0]) << 32 | int(words[1]))

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """Pure function of step (the resumability contract):
        {"tokens", "targets"}, (local batch, seq) int64 on the device."""
        B, S, V = self.local_batch, self.shape.seq_len, self.cfg.vocab_size
        toks = _batch_tokens(self._generator(step), B, S + 1, V)
        toks = toks.to(self.device)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def __next__(self) -> Dict[str, torch.Tensor]:
        b = self.batch_at(self.state.step)
        self.state.step += 1
        return b

    def __iter__(self):
        return self

    # --- checkpoint integration ---------------------------------------
    def snapshot(self) -> Dict:
        return self.state.as_dict()

    def restore(self, d: Dict):
        self.state = DataState.from_dict(d)
