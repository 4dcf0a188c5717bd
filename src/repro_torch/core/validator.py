"""Black-box validation (paper §4.1), as the reference's
``src/repro/core/validator.py``.

ComPar optionally runs a user testing script on every combination's output
and rejects combinations that fail.  ComParX's analogue: run the candidate
plan's forward on a reduced config with real numerics, on the CPU, and
compare its logits against the reference plan's (no remat, plain
kernels).  A ``cuda`` clause runs the kernels' plain versions there, as
every op does on a CPU tensor; what it checks is that the plan executes
and keeps the numerics.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.combinator import Combination
from repro_torch.core.plan import Plan, build_contexts, uniform_plan
from repro_torch.models.context import SegmentClause
from repro_torch.models.model import forward, model_specs
from repro_torch.models.params import init_params


def _tiny_batch(cfg: ArchConfig, batch: int = 2, seq: int = 16,
                seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    out = {"targets": torch.randint(0, cfg.vocab_size, (batch, seq),
                                    generator=gen)}
    if cfg.frontend != "none":
        out["embeds"] = (torch.randn((batch, seq, cfg.d_model),
                                     generator=gen) * 0.02
                         ).to(getattr(torch, cfg.dtype))
    else:
        out["tokens"] = torch.randint(0, cfg.vocab_size, (batch, seq),
                                      generator=gen)
    return out


def _small(cfg: ArchConfig) -> ArchConfig:
    return cfg if cfg.name.endswith("-smoke") else cfg.smoke()


def validate_plan(cfg: ArchConfig, plan: Plan, *,
                  reference: Optional[Plan] = None,
                  atol: float = 5e-2, rtol: float = 5e-2,
                  seed: int = 0) -> Tuple[bool, str]:
    """Candidate-vs-reference forward on the reduced (smoke) config, on the
    CPU.  Returns (passed, message)."""
    small = _small(cfg)
    reference = reference or uniform_plan(
        small, "fsdp", clause=SegmentClause(remat="none", kernel="plain"))
    params = init_params(model_specs(small),
                         torch.Generator().manual_seed(seed), "cpu")
    batch = _tiny_batch(small, seed=seed)

    @torch.no_grad()
    def run(p):
        logits, _ = forward(params, batch, small, build_contexts(small, p))
        return logits.float()

    try:
        cand = run(plan)
    except Exception as e:      # the black box: any failure rejects
        return False, f"candidate failed to execute: {type(e).__name__}: {e}"
    ref = run(reference)
    if torch.isnan(cand).any():
        return False, "candidate produced NaNs"
    err = float((cand - ref).abs().max())
    scale = float(ref.abs().max()) + 1e-9
    if err > atol + rtol * scale:
        return False, (f"output mismatch: max_abs_err={err:.4g} "
                       f"scale={scale:.4g}")
    return True, f"ok (max_abs_err={err:.4g})"


def validate_combination(cfg: ArchConfig, combo: Combination,
                         **kw) -> Tuple[bool, str]:
    """Validate one combination applied uniformly (cheapest black-box)."""
    small = _small(cfg)
    plan = uniform_plan(small, combo.provider, combo.flags, combo.clause)
    return validate_plan(small, plan, **kw)
