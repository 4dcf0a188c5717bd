"""Full causal-LM assembly: embedding -> block groups -> head.

The layer stack is split into homogeneous groups (``ArchConfig.stack_plan``);
each group is one ComParX segment with its own :class:`ModelContext`.  A
group with ``repeats > 1`` keeps its parameters and caches stacked along a
leading ``layers`` dim, as the reference does, and runs as a Python loop
over that dim (the reference's ``lax.scan``).  With grad enabled, each
layer's superblock is rematerialized as the segment's clause says
(:func:`_remat`), as the reference wraps each scan step.
"""
from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig, ScanGroup
from repro_torch.device import resolve_device
from repro_torch.models.blocks import (block_apply, block_cache_spec,
                                       block_decode, block_specs)
from repro_torch.models.context import ModelContext
from repro_torch.models.layers import norm_apply, norm_specs
from repro_torch.models.params import (ParamSpec, TensorSpec, layer_slice,
                                       stack_specs, tree_map)

SEG_EMBED = "embed"
SEG_HEAD = "head"


def model_specs(cfg: ArchConfig):
    d, V = cfg.d_model, cfg.vocab_size
    specs = {SEG_EMBED: {"tok": ParamSpec((V, d), ("vocab", "embed"),
                                          "normal", 1.0, cfg.dtype)}}
    for gi, group in enumerate(cfg.stack_plan()):
        gspec = {}
        for j, kind in enumerate(group.pattern):
            bs = block_specs(kind, cfg)
            gspec[f"b{j}"] = stack_specs(bs, group.repeats) \
                if group.repeats > 1 else bs
        specs[f"g{gi}"] = gspec
    head: Dict[str, object] = {"norm": norm_specs(d, cfg.norm, cfg.dtype)}
    if not cfg.tie_embeddings:
        head["out"] = ParamSpec((d, V), ("embed", "vocab"), "normal",
                                d ** -0.5, cfg.dtype)
    specs[SEG_HEAD] = head
    return specs


def _ctx_for(ctxs, seg: str) -> ModelContext:
    if isinstance(ctxs, ModelContext):
        return ctxs
    return ctxs.get(seg, ctxs.get("*", ModelContext()))


def _layers(tree, group: ScanGroup):
    """Per-layer views of a group's (possibly stacked) tree."""
    if group.repeats == 1:
        return [tree]
    return [layer_slice(tree, i) for i in range(group.repeats)]


#: the products ``remat="dots"`` saves: the weight products (``dense``,
#: the ``wo`` contraction), which reach ``aten.mm`` with no batch dims
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, clause):
    """The reference's ``_remat`` (``src/repro/models/model.py:58``) as a
    non-reentrant ``torch.utils.checkpoint``.

    ``full`` saves only the superblock's inputs and reruns it in the
    backward.  ``dots`` also saves the outputs of ``aten.mm``/``addmm``
    and recomputes everything else, for the reference's
    ``checkpoint_dots_with_no_batch_dims``: the weight products are saved,
    the attention score matrices (``aten.bmm``, batched over heads) are
    not.  The two sets are not the same: XLA's dot set is decided on its
    HLO, this one on ATen's ops, and the mLSTM's head projections
    (``einsum`` with no batch dims, which ATen runs as ``bmm``) are saved
    by the reference and recomputed here.  A rerun launches the CUDA
    kernels again.
    """
    if clause.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if clause.remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_dots))
    if clause.remat != "none":
        raise ValueError(f"remat={clause.remat!r}; expected none, dots or "
                         f"full")
    return fn


def _run_group(x, gparams, group: ScanGroup, cfg, ctx, positions):
    """Forward one group. Returns (x, aux)."""
    def superblock(x, layer_params):
        aux = 0.0
        for j, kind in enumerate(group.pattern):
            x, a = block_apply(kind, layer_params[f"b{j}"], x, cfg, ctx,
                               positions)
            aux = aux + a
        return x, aux
    fn = _remat(superblock, ctx.clause) if torch.is_grad_enabled() \
        else superblock
    aux = 0.0
    for layer_params in _layers(gparams, group):
        x, a = fn(x, layer_params)
        aux = aux + a
    return x, aux


def embed_tokens(params, tokens, cfg: ArchConfig, ctx: ModelContext):
    return F.embedding(tokens, params[SEG_EMBED]["tok"])


def _matmul_f32(x, w):
    """x (..., d) @ w (d, V) with f32 output, accumulated in f32 from the
    stored dtypes (the reference's ``preferred_element_type=f32``).

    On the card without grad, one bf16 tensor-core product with an f32
    output; ``torch.mm``'s ``out_dtype`` has no derivative, so with grad
    (and on the CPU) the product runs on f32 copies, whose backward is the
    reference's: f32 products, cast back to the stored dtypes.
    """
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda and not (torch.is_grad_enabled()
                          and (x.requires_grad or w.requires_grad)):
        out = torch.mm(x2, w.to(x.dtype), out_dtype=torch.float32)
    else:
        out = x2.float() @ w.float()
    return out.reshape(*x.shape[:-1], w.shape[-1])


def lm_head(params, x, cfg: ArchConfig, ctx: ModelContext):
    x = norm_apply(params[SEG_HEAD]["norm"], x, cfg.norm)
    w = params[SEG_EMBED]["tok"].T if cfg.tie_embeddings \
        else params[SEG_HEAD]["out"]
    return _matmul_f32(x, w)


def forward(params, batch, cfg: ArchConfig, ctxs):
    """Train/prefill forward. batch: {"tokens": (B,S) int}.  (The
    reference's ``"embeds"`` input feeds the vlm/audio stub frontends,
    which come with ROADMAP Queue 1 item 6.)

    Returns (logits (B,S,V) f32, aux_loss scalar f32 tensor).
    """
    x = embed_tokens(params, batch["tokens"], cfg, _ctx_for(ctxs, SEG_EMBED))
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    aux = 0.0
    for gi, group in enumerate(cfg.stack_plan()):
        seg = f"g{gi}"
        x, a = _run_group(x, params[seg], group, cfg, _ctx_for(ctxs, seg),
                          positions)
        aux = aux + a
    logits = lm_head(params, x, cfg, _ctx_for(ctxs, SEG_HEAD))
    return logits, torch.as_tensor(aux, dtype=torch.float32,
                                   device=x.device)


# --- decode ------------------------------------------------------------------

def cache_specs(cfg: ArchConfig, batch: int, smax: int):
    """Decode cache shapes for the whole stack (stacked per group)."""
    caches = {}
    for gi, group in enumerate(cfg.stack_plan()):
        gcache = {}
        for j, kind in enumerate(group.pattern):
            cs = block_cache_spec(kind, cfg, batch, smax)
            if group.repeats > 1:
                cs = tree_map(lambda s: TensorSpec(
                    (group.repeats,) + s.shape, s.dtype), cs)
            gcache[f"b{j}"] = cs
        caches[f"g{gi}"] = gcache
    return caches


def init_cache(cfg: ArchConfig, batch: int, smax: int, device="cuda"):
    dev = resolve_device(device)
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
                    cache_specs(cfg, batch, smax))


def _write_state(dst: torch.Tensor, src: torch.Tensor):
    if src is not dst:
        dst.copy_(src)


def decode_step(params, caches, tokens, pos, cfg: ArchConfig, ctxs):
    """One decoding step. tokens: (B,) int; pos: an ``int`` (every row at
    one position) or a (B,) tensor of per-row positions.

    Returns (logits (B,V) f32, caches); the caches are updated in place.
    A stacked group's per-layer caches are views of its stacked leaves, so
    recurrent state is written back into them with ``copy_`` (a new tensor
    bound to the tree would be lost).
    """
    x = embed_tokens(params, tokens, cfg, _ctx_for(ctxs, SEG_EMBED))
    for gi, group in enumerate(cfg.stack_plan()):
        seg = f"g{gi}"
        ctx = _ctx_for(ctxs, seg).with_(decode=True)
        for lp, lc in zip(_layers(params[seg], group),
                          _layers(caches[seg], group)):
            for j, kind in enumerate(group.pattern):
                x, new = block_decode(kind, lp[f"b{j}"], x, lc[f"b{j}"], pos,
                                      cfg, ctx)
                tree_map(_write_state, lc[f"b{j}"], new)
    logits = lm_head(params, x, cfg, _ctx_for(ctxs, SEG_HEAD))
    return logits, caches
