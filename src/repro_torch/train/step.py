"""Train-step factory: applies a ComParX plan to a training step.

The step is ``(params, opt_state, batch) -> (params, opt_state, metrics)``
as in the reference (``src/repro/train/step.py``), with the remat
policies, kernel selections and gradient-accumulation microbatching taken
from the plan.  Without a mesh the reference's sharding helpers
(``param_shardings``, ``opt_shardings``, ``batch_shardings``) have nothing
to say, and PyTorch runs eagerly, so ``jit_train_step`` has no
counterpart.  The update is always in place (``optim/adamw.py``), so the
plan's ``donate`` knob changes nothing here.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.plan import Plan, build_contexts
from repro_torch.device import resolve_device
from repro_torch.models.loss import softmax_xent
from repro_torch.models.model import forward, model_specs
from repro_torch.models.params import init_params, tree_leaves, tree_map
from repro_torch.optim.adamw import adamw_init, adamw_update, cosine_lr

AUX_LOSS_WEIGHT = 0.01


def _unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def make_grads(cfg: ArchConfig, plan: Plan, *, device="cuda"):
    """Returns ``grads_of(params, batch) -> (loss, metrics, grads)``: the
    loss (cross-entropy + z-loss + ``AUX_LOSS_WEIGHT`` x aux) and its
    gradient, a tree like ``params`` in each leaf's dtype.

    Every leaf must require grad (:func:`init_train_state` sets that), and
    every leaf must reach the loss: a leaf the graph skips raises, so a
    dropped gradient cannot pass unseen.
    """
    resolve_device(device)
    ctxs = build_contexts(cfg, plan)

    def grads_of(params, batch):
        logits, aux = forward(params, batch, cfg, ctxs)
        loss, metrics = softmax_xent(logits, batch["targets"])
        total = loss + AUX_LOSS_WEIGHT * aux
        grads = torch.autograd.grad(total, tree_leaves(params))
        metrics = {k: t.detach()
                   for k, t in dict(metrics, loss=loss, aux_loss=aux).items()}
        return total.detach(), metrics, _unflatten(params, grads)

    return grads_of


def make_train_step(cfg: ArchConfig, plan: Plan, *, device="cuda",
                    peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10000, weight_decay: float = 0.1,
                    clip_norm: float = 1.0):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``.  ``params`` and the optimizer state are updated
    in place and returned.

    With ``plan.knobs.microbatches`` = mb > 1 the batch is split along its
    first axis into mb microbatches whose gradients are summed in f32 and
    divided by mb; the loss is the mean over microbatches and the other
    metrics are the last microbatch's, as in the reference.
    """
    grads_of = make_grads(cfg, plan, device=device)
    mb = plan.knobs.microbatches

    def train_step(params, opt_state, batch):
        if mb > 1:
            if batch["tokens"].shape[0] % mb:
                raise ValueError(f"batch of {batch['tokens'].shape[0]} does "
                                 f"not split into {mb} microbatches")
            gsum, lsum = None, 0.0
            for i in range(mb):
                part = {k: t.chunk(mb)[i] for k, t in batch.items()}
                loss, metrics, grads = grads_of(params, part)
                if gsum is None:
                    gsum = tree_map(lambda g: g.float(), grads)
                else:
                    tree_map(lambda a, g: a.add_(g), gsum, grads)
                lsum = lsum + loss
            grads = tree_map(lambda g: g.div_(mb), gsum)
            loss = lsum / mb
        else:
            loss, metrics, grads = grads_of(params, batch)
        lr = cosine_lr(opt_state.step, peak_lr=peak_lr, warmup=warmup,
                       total=total_steps)
        params, opt_state, opt_metrics = adamw_update(
            grads, opt_state, params, lr=lr, weight_decay=weight_decay,
            clip_norm=clip_norm)
        return params, opt_state, dict(metrics, **opt_metrics,
                                       total_loss=loss)

    return train_step


def init_train_state(cfg: ArchConfig, plan: Plan,
                     generator: torch.Generator, device="cuda"):
    """Parameters from ``generator``'s seed (made trainable here, once) and
    a zero AdamW state in ``plan.knobs.opt_state_dtype``."""
    params = init_params(model_specs(cfg), generator, device)
    tree_map(lambda t: t.requires_grad_(), params)
    return params, adamw_init(params, plan.knobs.opt_state_dtype)
