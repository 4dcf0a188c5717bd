"""Serve-step factories: prefill and decode under a ComParX plan.

Each factory resolves its device first (``"cuda"`` by default; a missing
card raises) and returns one plain function; the reference also returned
shardings, which a meshless port does not have.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.plan import Plan, build_contexts
from repro_torch.device import resolve_device
from repro_torch.models.model import decode_step, forward


def make_decode_step(cfg: ArchConfig, plan: Plan, *, device="cuda"):
    """Returns serve_step(params, caches, tokens, pos) ->
    (next_tokens, logits, caches); greedy."""
    resolve_device(device)
    ctxs = build_contexts(cfg, plan)

    @torch.no_grad()
    def serve_step(params, caches, tokens, pos):
        logits, caches = decode_step(params, caches, tokens, pos, cfg, ctxs)
        return torch.argmax(logits, dim=-1), logits, caches

    return serve_step


def make_prefill(cfg: ArchConfig, plan: Plan, *, device="cuda"):
    """Full-sequence forward (prefill compute shape). Returns
    prefill(params, batch) -> logits (B,S,V) f32."""
    resolve_device(device)
    ctxs = build_contexts(cfg, plan)

    @torch.no_grad()
    def prefill(params, batch):
        logits, _ = forward(params, batch, cfg, ctxs)
        return logits

    return prefill


def make_prefill_cache(cfg: ArchConfig, plan: Plan, *, device="cuda"):
    """The serving engine's prefill segment: consume a prompt into a
    decode cache.

    :func:`make_prefill` computes full-sequence prompt logits but leaves no
    KV state, so request admission runs the plan's decode step over the
    prompt positions instead: a Python loop with an ``int`` position (no
    host sync per token), whose last-position logits match the
    full-sequence forward's and whose caches are exactly what a
    token-by-token decode loop leaves behind.

    Returns ``prefill(params, caches, prompt) -> (first_tokens (B,),
    last_logits (B,V) f32, caches)`` where ``prompt`` is (B, P) and
    ``caches`` a fresh ``init_cache`` tree (filled in place).
    """
    resolve_device(device)
    ctxs = build_contexts(cfg, plan)

    @torch.no_grad()
    def prefill(params, caches, prompt):
        logits = None
        for i in range(prompt.shape[1]):
            logits, caches = decode_step(params, caches, prompt[:, i], i,
                                         cfg, ctxs)
        return torch.argmax(logits, dim=-1), logits, caches

    return prefill
