"""Timer: per-segment cost attribution, as the reference's
``src/repro/core/timer.py``.

ComPar's Timer wraps every enumerated loop with wall-clock probes.  The
port builds, per segment, a standalone program under the combination's
clause: :func:`segment_program` returns a callable and its concrete
arguments on a device.  Train shapes measure forward and backward (the
gradients of one scalar), and with ``knobs.microbatches > 1`` accumulate
them over batch slices, as the reference's ``_with_bwd`` and
``_with_microbatches`` do.  Under a mesh (a ``DeviceMesh``) the
segment's params (:func:`_pshard`), its activations and its caches are
DTensors laid out by the provider's rules, and the program runs as the
step factories run it; without one the provider's mapping changes
nothing, so the clause is all of the combination that reaches the program.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.combinator import Combination, GlobalKnobs
from repro_torch.core.plan import dp_shards
from repro_torch.core.providers import get_provider
from repro_torch.core.segment import Segment
from repro_torch.device import resolve_device
from repro_torch.models.blocks import block_decode
from repro_torch.models.context import ModelContext
from repro_torch.models.loss import softmax_xent
from repro_torch.models.model import (SEG_EMBED, SEG_HEAD, _layers,
                                      _run_group, _write_state, cache_specs,
                                      embed_tokens, lm_head, model_specs)
from repro_torch.models.params import param_pspecs, tree_leaves, tree_map
from repro_torch.runtime.sharding import (Rules, Sharding, distribute,
                                          mesh_axis_sizes, mesh_scope,
                                          placements)

#: the reference's ``_materialize`` draws its arguments from one key: 42
SEED = 42


def _materializer(dev: torch.device, seed: int):
    """Concrete tensors as the reference's ``_materialize`` makes them:
    normal x 0.02 in the tensor's dtype, zeros for integers."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def make(shape, dtype: torch.dtype) -> torch.Tensor:
        if not dtype.is_floating_point:
            return torch.zeros(shape, dtype=dtype, device=dev)
        x = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return x.mul_(0.02).to(dtype)
    return make


def _unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _pshard(spec_tree, rules: Rules, mesh):
    """The placements of a segment's params under ``rules`` (None without
    a mesh), as the reference's ``_pshard`` gives NamedShardings."""
    if mesh is None:
        return None
    return tree_map(lambda s, ps: Sharding(mesh, placements(
        mesh, ps, shape=s.shape)), spec_tree, param_pspecs(spec_tree, rules))


def _in_scope(fn, meshed: bool):
    def wrapped(*args):
        with mesh_scope(meshed):
            return fn(*args)
    return wrapped


def _with_bwd(fn, argnums=(0,), scalar: bool = False):
    """Wrap a segment fn so it returns the gradients of one scalar (the
    output itself when ``scalar``, else ``sum(square(out.float()))``)
    against the arguments ``argnums``: a tuple of trees like them."""
    def wrapped(*args):
        out = fn(*args)
        loss = out if scalar else out.float().square().sum()
        wrt = {i: args[i] for i in argnums}
        grads = torch.autograd.grad(loss, tree_leaves(wrt))
        return tuple(_unflatten(wrt, grads).values())
    return wrapped


def _with_microbatches(fn, mb: int):
    """Gradient accumulation for segment scoring: split the batch (arg 1;
    arg 0 is the segment's params) into ``mb`` slices, run the fwd+bwd
    ``fn`` on each and average the gradients, the same program shape as
    ``train/step.py`` builds."""
    if mb <= 1:
        return fn

    def wrapped(p, x):
        if x.shape[0] % mb:
            raise ValueError(f"global_batch {x.shape[0]} not divisible by "
                             f"microbatches={mb}")
        acc = None
        for xi in x.chunk(mb):
            g = dict(enumerate(fn(p, xi)))
            acc = g if acc is None else tree_map(torch.add, acc, g)
        return tuple(tree_map(lambda t: t / mb, acc).values())
    return wrapped


def segment_program(cfg: ArchConfig, shape: ShapeConfig, seg: Segment,
                    combo: Combination, *, device,
                    knobs: Optional[GlobalKnobs] = None,
                    params=None, mesh=None) -> Tuple[Callable, Tuple]:
    """Build ``(fn, args)`` for one segment: ``fn(*args)`` runs the
    segment's compute under the combination's clause on ``device``.

    * ``embed``: the embedding of zero tokens;
    * ``head``: the loss of the head's logits on zero targets;
    * a stack group at train or prefill shape: the group's layers
      (``models.model._run_group``);
    * a stack group at decode shape: each block's ``block_decode`` over
      the group's caches at scalar pos 0, the caches updated in place.

    Train shapes return the gradients (see :func:`_with_bwd`), averaged
    over ``knobs.microbatches`` batch slices.  The arguments come from a
    ``torch.Generator`` seeded :data:`SEED` (see :func:`_materializer`);
    ``params`` replaces the segment's parameter tree (the reference's
    weights, carried through numpy, for instance).  Under ``mesh`` the
    arguments are drawn in full and placed (each rank its shard).
    """
    dev = resolve_device(device)
    fn, args = _segment_program(cfg, shape, seg, combo, dev, knobs, params,
                                mesh)
    return _in_scope(fn, mesh is not None), args


def _segment_program(cfg, shape, seg, combo, dev, knobs, params, mesh):
    make = _materializer(dev, SEED)
    mapping = get_provider(combo.provider).mapping(
        cfg, mesh_axis_sizes(mesh), combo.flags, seg)
    rules = Rules(mapping, mesh)
    ctx = ModelContext(rules=rules, clause=combo.clause,
                       moe_groups=dp_shards(mesh))

    def place(t, axes):
        return t if mesh is None else rules.distribute(t, axes)
    specs = model_specs(cfg)
    B, S = shape.global_batch, shape.seq_len
    train = shape.kind == "train"
    decode = shape.kind == "decode"
    mb = knobs.microbatches if (train and knobs is not None) else 1
    dt = specs[SEG_EMBED]["tok"].tdtype

    if seg.kind == "embed":
        need = {SEG_EMBED: specs[SEG_EMBED]}
    elif seg.kind == "head":
        need = {SEG_HEAD: specs[SEG_HEAD]}
        if cfg.tie_embeddings:
            need[SEG_EMBED] = specs[SEG_EMBED]
    else:
        need = specs[seg.name]
    p = params if params is not None else \
        tree_map(lambda s: make(s.shape, s.tdtype), need)
    if train:
        p = tree_map(lambda t: t.detach().requires_grad_(), p)
    sh = _pshard(need, rules, mesh)
    if sh is not None:
        p = tree_map(lambda t, s: distribute(t, s), p, sh)

    if seg.kind == "embed":
        tokens = place(make((B,) if decode else (B, S), torch.long),
                       ("batch",) if decode else ("batch", "seq"))

        def fn(p, tokens):
            return embed_tokens(p, tokens, cfg, ctx)
        if train:
            return _with_microbatches(_with_bwd(fn, (0,)), mb), (p, tokens)
        return torch.no_grad()(fn), (p, tokens)

    x = make((B, cfg.d_model) if decode else (B, S, cfg.d_model), dt)
    if train:
        x.requires_grad_()
    x = place(x, ("batch", "embed") if decode else ("batch", "seq", "embed"))

    if seg.kind == "head":
        def fn(p, x):
            logits = lm_head(p, x, cfg, ctx)
            tgt = place(torch.zeros(logits.shape[:-1], dtype=torch.long,
                                    device=dev), ("batch", "seq"))
            loss, _ = softmax_xent(logits, tgt)
            return loss
        if train:
            return (_with_microbatches(_with_bwd(fn, (0, 1), scalar=True),
                                       mb), (p, x))
        return torch.no_grad()(fn), (p, x)

    group = cfg.stack_plan()[int(seg.name[1:])]

    if decode:
        from repro_torch.serve.step import cache_axes
        caches = tree_map(lambda s: make(s.shape, s.dtype),
                          cache_specs(cfg, B, S)[seg.name])
        caches = tree_map(place, caches, cache_axes(cfg)[seg.name])
        dctx = ctx.with_(decode=True)

        @torch.no_grad()
        def fn(p, caches, x, pos):
            for lp, lc in zip(_layers(p, group), _layers(caches, group)):
                for j, kind in enumerate(group.pattern):
                    x, new = block_decode(kind, lp[f"b{j}"], x, lc[f"b{j}"],
                                          pos, cfg, dctx)
                    tree_map(_write_state, lc[f"b{j}"], new)
            return x, caches
        return fn, (p, caches, x, 0)

    positions = torch.arange(S, dtype=torch.int32, device=dev)

    def fn(p, x):
        y, _ = _run_group(x, p, group, cfg, ctx, positions)
        return y
    if train:
        return _with_microbatches(_with_bwd(fn, (0, 1)), mb), (p, x)
    return torch.no_grad()(fn), (p, x)
