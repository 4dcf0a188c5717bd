"""Serve-step factories: prefill and decode under a ComParX plan.

Each factory resolves its device first (``"cuda"`` by default; a missing
card raises) and returns one plain function.  Under a mesh (a
``DeviceMesh``) the params are DTensors placed by
``train.step.param_shardings``, the caches by :func:`cache_shardings`
(:func:`place_caches`), and the logits and tokens each step returns are
gathered to plain tensors, the same on every rank.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.plan import Plan, build_contexts
from repro_torch.device import resolve_device
from repro_torch.models.model import cache_specs, decode_step, forward
from repro_torch.models.params import DTYPES, TensorSpec, tree_map
from repro_torch.runtime.sharding import (Sharding, full, is_device_mesh,
                                          placements)


def cache_axes(cfg: ArchConfig):
    """Logical axes mirroring ``models.model.cache_specs``' structure (the
    reference's)."""
    def for_kind(kind: str):
        if kind in ("attn", "attn_moe"):
            a = ("batch", "kv_seq", "kv_heads", None)
            return {"k": a, "v": a}
        if kind == "rec":
            return {"h": ("batch", "rnn"), "conv": ("batch", None, "rnn")}
        if kind == "mlstm":
            return {"C": ("batch", "heads", None, None),
                    "n": ("batch", "heads", None),
                    "m": ("batch", "heads"),
                    "conv": ("batch", None, "rnn")}
        if kind == "slstm":
            return {"h": ("batch", "heads", None),
                    "c": ("batch", "heads", None),
                    "n": ("batch", "heads", None),
                    "m": ("batch", "heads", None),
                    "conv": ("batch", None, "embed")}
        raise ValueError(kind)

    axes = {}
    for gi, group in enumerate(cfg.stack_plan()):
        g = {}
        for j, kind in enumerate(group.pattern):
            ax = for_kind(kind)
            if group.repeats > 1:
                ax = {k: ("layers",) + tuple(a) for k, a in ax.items()}
            g[f"b{j}"] = ax
        axes[f"g{gi}"] = g
    return axes


def cache_pspecs(cfg: ArchConfig, batch: int, smax: int, plan: Plan,
                 mesh=None):
    """Per-segment pspec tree of the decode caches."""
    ctxs = build_contexts(cfg, plan, mesh)
    specs = cache_specs(cfg, batch, smax)
    return {seg: tree_map(lambda a, s: ctxs[seg].rules.pspec(a, s.shape),
                          seg_axes, specs[seg])
            for seg, seg_axes in cache_axes(cfg).items()}


def cache_shardings(cfg: ArchConfig, shape, plan: Plan, mesh=None):
    """The reference's: cache pspecs at ``shape`` (batch x cache length),
    as ``Sharding``s on a DeviceMesh."""
    ps = cache_pspecs(cfg, shape.global_batch, shape.seq_len, plan, mesh)
    if not is_device_mesh(mesh):
        return ps
    return tree_map(lambda p: Sharding(mesh, placements(mesh, p)), ps)


def place_caches(caches, cfg: ArchConfig, plan: Plan, mesh):
    """Fresh caches (``init_cache``) as DTensors by the segments' rules;
    unchanged without a mesh."""
    if mesh is None:
        return caches
    ctxs = build_contexts(cfg, plan, mesh)
    return {seg: tree_map(lambda a, t: ctxs[seg].rules.distribute(t, a),
                          seg_axes, caches[seg])
            for seg, seg_axes in cache_axes(cfg).items()}


def decode_input_specs(cfg: ArchConfig, shape):
    """A decode step's inputs as ``TensorSpec``s (the dry run's): the
    (B,) int64 tokens and a scalar position."""
    return {"tokens": TensorSpec((shape.global_batch,), torch.int64),
            "pos": TensorSpec((), torch.int64)}


def prefill_input_specs(cfg: ArchConfig, shape):
    """A prefill batch as ``TensorSpec``s: (B, S) int64 tokens, or a stub
    frontend's (B, S, d_model) embeds."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.frontend != "none":
        return {"embeds": TensorSpec((B, S, cfg.d_model),
                                     DTYPES[cfg.dtype])}
    return {"tokens": TensorSpec((B, S), torch.int64)}


def make_decode_step(cfg: ArchConfig, plan: Plan, *, device="cuda",
                     mesh=None, gather: bool = True):
    """Returns serve_step(params, caches, tokens, pos) ->
    (next_tokens, logits, caches); greedy.  ``gather=False`` leaves the
    logits laid out as the head's rules have them under a mesh and picks
    no token (None): the dry run's program, whose collectives are then
    the step's own."""
    resolve_device(device)
    ctxs = build_contexts(cfg, plan, mesh)

    @torch.no_grad()
    def serve_step(params, caches, tokens, pos):
        logits, caches = decode_step(params, caches, tokens, pos, cfg, ctxs)
        if not gather:
            return None, logits, caches
        logits = full(logits)
        return torch.argmax(logits, dim=-1), logits, caches

    return serve_step


def make_prefill(cfg: ArchConfig, plan: Plan, *, device="cuda", mesh=None,
                 gather: bool = True):
    """Full-sequence forward (prefill compute shape). Returns
    prefill(params, batch) -> logits (B,S,V) f32 (gathered under a mesh
    unless ``gather=False``)."""
    resolve_device(device)
    ctxs = build_contexts(cfg, plan, mesh)
    out = full if gather else (lambda t: t)

    @torch.no_grad()
    def prefill(params, batch):
        logits, _ = forward(params, batch, cfg, ctxs)
        return out(logits)

    return prefill


def make_prefill_cache(cfg: ArchConfig, plan: Plan, *, device="cuda",
                       mesh=None):
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
    ctxs = build_contexts(cfg, plan, mesh)

    @torch.no_grad()
    def prefill(params, caches, prompt):
        logits = None
        for i in range(prompt.shape[1]):
            logits, caches = decode_step(params, caches, prompt[:, i], i,
                                         cfg, ctxs)
        logits = full(logits)
        return torch.argmax(logits, dim=-1), logits, caches

    return prefill
