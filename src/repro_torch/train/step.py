"""Train-step factory: applies a ComParX plan to a training step.

The step is ``(params, opt_state, batch) -> (params, opt_state, metrics)``
as in the reference (``src/repro/train/step.py``), with the sharding
rules, remat policies, kernel selections and gradient-accumulation
microbatching taken from the plan.  Under a mesh (a ``DeviceMesh``) the
params and the AdamW state are DTensors placed by ``param_shardings`` and
the batch by ``batch_shardings``; ``place_batch`` places a batch.
PyTorch runs eagerly, so ``jit_train_step`` has no counterpart.  The
update is always in place (``optim/adamw.py``), so the plan's ``donate``
knob changes nothing here.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.plan import Plan, build_contexts, segment_rules
from repro_torch.device import resolve_device
from repro_torch.models.loss import softmax_xent
from repro_torch.models.model import SEG_EMBED, forward, model_specs
from repro_torch.models.params import (DTYPES, TensorSpec, abstract_params,
                                       init_params, param_pspecs,
                                       place_params, tree_leaves, tree_map)
from repro_torch.optim.adamw import (AdamWState, adamw_abstract_state,
                                     adamw_init, adamw_update, cosine_lr)
from repro_torch.runtime import trace
from repro_torch.runtime.sharding import (Sharding, full, is_device_mesh,
                                          mesh_scope, placements)

AUX_LOSS_WEIGHT = 0.01


#: the logical axes of each batch entry
BATCH_AXES = {"tokens": ("batch", "seq"), "targets": ("batch", "seq"),
              "embeds": ("batch", "seq", "embed")}


def _as_shardings(pspecs, mesh):
    if mesh is None:
        return pspecs
    return tree_map(lambda ps: Sharding(mesh, placements(mesh, ps)), pspecs)


def param_shardings(cfg: ArchConfig, plan: Plan, mesh=None):
    """Per-segment pspec tree for params (``Sharding``s with a
    DeviceMesh)."""
    rules = segment_rules(cfg, plan, mesh)
    pspecs = {seg: param_pspecs(tree, rules[seg])
              for seg, tree in model_specs(cfg).items()}
    return _as_shardings(pspecs, mesh if is_device_mesh(mesh) else None)


def opt_shardings(cfg: ArchConfig, plan: Plan, mesh=None) -> AdamWState:
    ps = param_shardings(cfg, plan, mesh)
    return AdamWState(step=(), m=ps, v=ps)


def batch_specs(cfg: ArchConfig, shape) -> dict:
    """The training batch as ``TensorSpec``s (the dry run's stand-ins):
    int64 targets, and tokens or (a stub frontend's) embeds."""
    B, S = shape.global_batch, shape.seq_len
    out = {"targets": TensorSpec((B, S), torch.int64)}
    if cfg.frontend != "none":
        out["embeds"] = TensorSpec((B, S, cfg.d_model), DTYPES[cfg.dtype])
    else:
        out["tokens"] = TensorSpec((B, S), torch.int64)
    return out


def batch_shardings(cfg: ArchConfig, shape, plan: Plan, mesh=None):
    """The batch's pspecs (``Sharding``s with a DeviceMesh) by the embed
    segment's rules, as the reference's."""
    rules = build_contexts(cfg, plan, mesh)[SEG_EMBED].rules
    out = {k: rules.pspec(BATCH_AXES[k], s.shape)
           for k, s in batch_specs(cfg, shape).items()}
    return _as_shardings(out, mesh if is_device_mesh(mesh) else None)


def place_batch(batch, cfg: ArchConfig, plan: Plan, mesh):
    """A batch (full on every rank) as DTensors by the embed segment's
    rules; unchanged without a mesh."""
    if mesh is None:
        return batch
    rules = build_contexts(cfg, plan, mesh)[SEG_EMBED].rules
    return {k: rules.distribute(t, BATCH_AXES[k]) for k, t in batch.items()}


def _unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def make_grads(cfg: ArchConfig, plan: Plan, *, device="cuda", mesh=None):
    """Returns ``grads_of(params, batch) -> (loss, metrics, grads)``: the
    loss (cross-entropy + z-loss + ``AUX_LOSS_WEIGHT`` x aux) and its
    gradient, a tree like ``params`` in each leaf's dtype.

    Every leaf must require grad (:func:`init_train_state` sets that), and
    every leaf must reach the loss: a leaf the graph skips raises, so a
    dropped gradient cannot pass unseen.  The one exception is the
    embedding table under an ``embeds`` batch (a stub frontend's), which
    the forward does not read unless the head is tied to it: its gradient
    is zero, as the reference's.

    Under ``mesh`` the params and the batch are DTensors (placed by
    :func:`init_train_state` and :func:`place_batch`), and so are the
    grads: each in the layout autograd gives it (a replicated leaf's grad
    may be ``Partial``); the update redistributes it to its leaf's.

    With the tracer on (``runtime/trace.py``) each call is the span
    ``train.grads``, holding ``train.forward`` (the forward and the loss)
    and ``train.backward`` (``torch.autograd.grad``).
    """
    resolve_device(device)
    ctxs = build_contexts(cfg, plan, mesh)

    meshed = ctxs[SEG_EMBED].meshed

    def grads_of(params, batch):
        # mesh_scope: the backward meets plain tensors
        with trace.span("train.grads"), mesh_scope(meshed):
            return _grads_of(params, batch)

    def _grads_of(params, batch):
        with trace.span("train.forward"):
            logits, aux = forward(params, batch, cfg, ctxs)
            loss, metrics = softmax_xent(logits, batch["targets"])
            total = loss + AUX_LOSS_WEIGHT * aux
        leaves = tree_leaves(params)
        unread = params[SEG_EMBED]["tok"] \
            if "embeds" in batch and not cfg.tie_embeddings else None
        # the kernel ops' backward spans open on autograd's device thread
        with trace.span("train.backward", lend=True):
            got = iter(torch.autograd.grad(
                total, [t for t in leaves if t is not unread]))
        grads = [torch.zeros_like(t) if t is unread else next(got)
                 for t in leaves]
        metrics = {k: full(t.detach())
                   for k, t in dict(metrics, loss=loss, aux_loss=aux).items()}
        return full(total.detach()), metrics, _unflatten(params, grads)

    return grads_of


def make_train_step(cfg: ArchConfig, plan: Plan, *, device="cuda",
                    mesh=None, peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10000, weight_decay: float = 0.1,
                    clip_norm: float = 1.0):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``.  ``params`` and the optimizer state are updated
    in place and returned.

    With ``plan.knobs.microbatches`` = mb > 1 the batch is split along its
    first axis into mb microbatches whose gradients are summed in f32 and
    divided by mb; the loss is the mean over microbatches and the other
    metrics are the last microbatch's, as in the reference.

    With the tracer on (``runtime/trace.py``) each call is the span
    ``train.step`` (counted), holding one ``train.grads`` per microbatch
    and ``train.optimizer``.
    """
    grads_of = make_grads(cfg, plan, device=device, mesh=mesh)
    mb = plan.knobs.microbatches

    def train_step(params, opt_state, batch):
        with trace.span("train.step", counted=True, step=opt_state.step):
            return _train_step(params, opt_state, batch)

    def _train_step(params, opt_state, batch):
        if mb > 1:
            # every batch has targets; a frontend batch has embeds, no
            # tokens
            if batch["targets"].shape[0] % mb:
                raise ValueError(f"batch of {batch['targets'].shape[0]} "
                                 f"does not split into {mb} microbatches")
            gsum, lsum = None, 0.0
            for i in range(mb):
                part = {k: t.chunk(mb)[i] for k, t in batch.items()}
                loss, metrics, grads = grads_of(params, part)
                if gsum is None:
                    gsum = tree_map(lambda g, p: _like(g, p).float(), grads,
                                    params)
                else:
                    tree_map(lambda a, g: a.add_(_like(g, a)), gsum, grads)
                lsum = lsum + loss
            grads = tree_map(lambda g: g.div_(mb), gsum)
            loss = lsum / mb
        else:
            loss, metrics, grads = grads_of(params, batch)
        lr = cosine_lr(opt_state.step, peak_lr=peak_lr, warmup=warmup,
                       total=total_steps)
        with trace.span("train.optimizer"):
            params, opt_state, opt_metrics = adamw_update(
                grads, opt_state, params, lr=lr, weight_decay=weight_decay,
                clip_norm=clip_norm)
        return params, opt_state, dict(metrics, **opt_metrics,
                                       total_loss=loss)

    return train_step


def _like(g, p):
    """``g`` in ``p``'s layout (DTensors; plain tensors pass)."""
    from torch.distributed.tensor import DTensor
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def abstract_train_state(cfg: ArchConfig, plan: Plan):
    """``(params, opt_state)`` as ``TensorSpec`` trees: the params' specs
    and an AdamW state in ``plan.knobs.opt_state_dtype`` (the dry run)."""
    params = abstract_params(model_specs(cfg))
    return params, adamw_abstract_state(params, plan.knobs.opt_state_dtype)


def init_train_state(cfg: ArchConfig, plan: Plan,
                     generator: torch.Generator, device="cuda", mesh=None,
                     params=None):
    """Parameters from ``generator``'s seed (or the full tree ``params``,
    the same on every rank), made trainable here, once, and placed on
    ``mesh`` by :func:`param_shardings`; and a zero AdamW state in
    ``plan.knobs.opt_state_dtype``, laid out as the params."""
    specs = model_specs(cfg)
    if params is None:
        params = init_params(specs, generator, device)
    tree_map(lambda t: t.requires_grad_(), params)
    if mesh is not None:
        params = place_params(params, specs, segment_rules(cfg, plan, mesh))
    return params, adamw_init(params, plan.knobs.opt_state_dtype)
