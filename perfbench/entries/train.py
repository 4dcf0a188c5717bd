"""Training under a frozen plan: ``repro_torch.train.step.make_train_step``.

Set-up makes the weights and the rows from the seed, builds one train
step with its state, and drives it through the first ``check_steps``
steps (which warm up every kernel and shape).  The window then runs the
same step on new rows until ``--seconds`` have passed; a step counts when
its loss has been read back.  ``train_tok_s`` is B x S per counted step
over the seconds from the window's start to the last step's end.

After the window the program's state is freed and the reference repeats
the first steps from the same weights and rows (``reference/train.py``).
Compared: each step's loss, the first step's logits over a sample of
places drawn from the seed (read where the step hands them to its loss),
each leaf's first gradient (as the optimizer got it: AdamW's m after one
step over 1 - b1), by its norm and element by element over a sample drawn
from the seed, and each leaf's change over the steps.
"""
from __future__ import annotations

import gc
import math
import time

from perfbench.harness import inputs, verdict
from perfbench.harness.trace import Spans, no_span, timed_window
from perfbench.reference import train as ref_train

#: the keys of a traffic's ``optimizer`` that ``make_train_step`` takes
STEP_KWARGS = ("peak_lr", "warmup", "total_steps", "weight_decay",
               "clip_norm")


def arch_config(arch: dict):
    from repro_torch.configs.base import ArchConfig
    fields = dict(arch, block_pattern=tuple(arch["block_pattern"]))
    return ArchConfig(**fields)


def plan_of(plan_json: dict):
    from repro_torch.core.plan import Plan
    return Plan.from_json(plan_json)


def flat(tree, prefix="") -> dict:
    """A nested dict tree as {"a/b/c": leaf}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _norm(t, chunk=1 << 25) -> float:
    x = t.detach().reshape(-1)
    return math.sqrt(sum(float(c.float().square().sum())
                         for c in x.split(chunk)))


def _change_norm(now, before, chunk=1 << 25) -> float:
    a, b = now.detach().reshape(-1), before.reshape(-1)
    return math.sqrt(sum(float((x.float() - y.float()).square().sum())
                         for x, y in zip(a.split(chunk), b.split(chunk))))


def logits_index(ctx, arch: dict, feed) -> object:
    """The places of the first step's logits that are compared."""
    batch, seq = feed.shape[0], feed.shape[1] - 1
    return inputs.sample_index(ctx.torch, ctx.seed, "logits",
                               batch * seq * arch["vocab_size"])


class Program:
    """One train step with its model and optimizer state, built from the
    seed's weights.  ``spans`` times the gradient and the optimizer calls
    of every step (the module globals the step reads are wrapped)."""

    def __init__(self, ctx, arch: dict, plan_json: dict, traffic: dict,
                 spans=None):
        import repro_torch.train.step as S
        from repro_torch.models.model import model_specs
        torch, dev = ctx.torch, ctx.device
        self.ctx, self.arch, self.S = ctx, arch, S
        cfg, plan = arch_config(arch), plan_of(plan_json)
        weights = inputs.make_weights(torch, arch, ctx.seed, dev)
        tree = inputs.as_tree(weights, model_specs(cfg))
        del weights
        self.params, self.opt = S.init_train_state(cfg, plan, None, dev,
                                                   params=tree)
        opt = {k: traffic["optimizer"][k] for k in STEP_KWARGS}
        self._saved = (S.make_grads, S.adamw_update)
        if spans is not None:
            make_grads = S.make_grads
            S.make_grads = lambda *a, **k: spans.wrap(make_grads(*a, **k),
                                                      "fwd_bwd")
            S.adamw_update = spans.wrap(S.adamw_update, "adamw")
        try:
            self.step = S.make_train_step(cfg, plan, device=dev, **opt)
        finally:
            S.make_grads = self._saved[0]
        self.feed = inputs.TokenFeed(torch, ctx.seed, traffic["batch"],
                                     traffic["seq"], arch["vocab_size"], dev)

    def run_step(self, spans=None) -> float:
        """One step on new rows; its loss, read back (waits for it)."""
        span = spans.span if spans is not None else no_span
        with span("step"):
            batch = self.feed.next()
            self.params, self.opt, m = self.step(self.params, self.opt,
                                                 batch)
        with span("loss_read"):
            return float(m["total_loss"])

    def _step_tapping_logits(self, index) -> tuple:
        """One step whose logits are read at ``index`` (flat, into (B, S,
        V)) as the step hands them to its loss: (loss, those logits)."""
        xent, taken = self.S.softmax_xent, []

        def tap(logits, targets, **kw):
            taken.append(logits.detach().reshape(-1)[index.to(logits.device)]
                         .float().cpu())
            return xent(logits, targets, **kw)
        self.S.softmax_xent = tap
        try:
            loss = self.run_step()
        finally:
            self.S.softmax_xent = xent
        if len(taken) != 1:
            raise ValueError(f"the step computed its loss {len(taken)} times; "
                             f"the logits are read from one")
        return loss, taken[0]

    def first_steps(self, n: int) -> dict:
        """Run the first ``n`` steps and read what the comparison needs."""
        torch = self.ctx.torch
        losses, grads = [], {}
        for i in range(n):
            if i == 0:
                loss, logits = self._step_tapping_logits(
                    logits_index(self.ctx, self.arch, self.feed))
                losses.append(loss)
            else:
                losses.append(self.run_step())
            if i == 0:
                grads = {p: _norm(m) / (1 - ref_train.B1)
                         for p, m in flat(self.opt.m).items()}
                samples = {
                    p: (m.detach().reshape(-1)[inputs.sample_index(
                        torch, self.ctx.seed, p, m.numel()).to(m.device)]
                        .float() / (1 - ref_train.B1)).cpu()
                    for p, m in flat(self.opt.m).items()}
        dtype = getattr(torch, self.arch["dtype"])
        change = {}
        params = flat(self.params)
        for leaf in inputs.layout(self.arch):
            w0 = inputs.draw_leaf(torch, leaf, self.ctx.seed, self.ctx.device,
                                  dtype)
            change[leaf[0]] = _change_norm(params[leaf[0]], w0)
            del w0
        return {"losses": losses, "grad_norms": grads,
                "change_norms": change, "grad_samples": samples,
                "logits_sample": logits}

    def close(self):
        """Drop the program's state and put back what was wrapped."""
        self.S.make_grads, self.S.adamw_update = self._saved
        self.params = self.opt = self.step = self.feed = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            self.ctx.torch.cuda.empty_cache()


def reference_readings(ctx, arch: dict, traffic: dict,
                       precision: str = "float32") -> dict:
    """The reference's readings of the first steps, from the seed."""
    torch = ctx.torch
    weights = inputs.make_weights(torch, arch, ctx.seed, ctx.device)
    feed = inputs.TokenFeed(torch, ctx.seed, traffic["batch"],
                            traffic["seq"], arch["vocab_size"], ctx.device)
    batches = [feed.next() for _ in range(traffic["check_steps"])]
    samples = {p: inputs.sample_index(torch, ctx.seed, p, t.numel())
               for p, t in weights.items()}
    out = ref_train.steps(arch, weights, batches, traffic["optimizer"],
                          precision, samples, logits_index(ctx, arch, feed))
    del weights, batches
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def run(ctx) -> dict:
    torch, cell = ctx.torch, ctx.cell
    arch, traffic = cell.arch, cell.traffic
    cuda = ctx.device.type == "cuda"
    spans = Spans(torch, device_timing=cuda) if ctx.trace else None
    prog = Program(ctx, arch, cell.plan, traffic, spans)
    try:
        first = prog.first_steps(traffic["check_steps"])
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        if spans is not None:
            spans.clear()
        setup_s = time.perf_counter() - ctx.t0
        ctx.log(f"set-up {setup_s:.2f} s; first losses {first['losses']}")
        losses = []
        window_s, trace = timed_window(
            torch, ctx.seconds, lambda: losses.append(prog.run_step(spans)),
            ctx.trace and cuda, spans)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
    finally:
        prog.close()
    n = len(losses)
    tokens = traffic["batch"] * traffic["seq"]
    ctx.log(f"window {window_s:.3f} s, {n} steps, losses "
            f"{losses[0]:.5f} .. {losses[-1]:.5f}")
    ref = reference_readings(ctx, arch, traffic)
    gaps = verdict.training_gaps(first, ref)
    for name, g in gaps.items():
        ctx.log(f"{name} at {g['at']}")
    bad = sum(not math.isfinite(x) for x in losses)
    readings = {"steps": n, "batch": traffic["batch"], "seq": traffic["seq"],
                "arch": arch, "trace": trace,
                "spans_ms": spans.device_ms() if spans and cuda else {}}
    return {"setup_s": setup_s, "e2e": {"train_tok_s": n * tokens / window_s},
            "readings": readings, "attempted": n, "failed": bad,
            "memory_peak_bytes": peak, "trace": trace, "gaps": gaps}
