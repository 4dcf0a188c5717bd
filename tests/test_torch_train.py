"""The port's training path on the CPU against the JAX package.

The reference runs its Pallas kernels in interpret mode, as
``tests/test_kernels.py`` runs them; the port runs the kernels' plain
versions (every op's forward on a CPU tensor) under the same
``autograd.Function``s that launch the kernels on the card.  Inputs,
parameters (``test_torch_model._params``: the reference's init with
stable per-leaf keys) and the reference's own batches go through numpy.

Tolerances:
  * op gradients: the floors of ``tests/test_kernels.py`` (rglru's grad
    floor 1e-4 / 1e-3; the forward floors for the rest: flash-attention
    f32 2e-5, mlstm 5e-4 / 5e-3, rmsnorm f32 1e-5);
  * train steps, f32: the loss curve at rtol 1e-4; step-0 grads at atol
    1e-5 + 1e-4 of each leaf's largest |grad| (the reference's read back
    from its first moment after one update); parameters after N steps at
    atol 2 N max(lr).  Adam's first steps move a weight by about lr
    whatever the size of its grad, so a grad near zero whose sign differs
    between XLA's and PyTorch's sums moves that weight by 2 lr a step;
    the loss curve and the grads carry the tight checks.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import get_shape as jget_shape
from repro.core.combinator import GlobalKnobs as JKnobs
from repro.core.plan import uniform_plan as juniform_plan
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.context import SegmentClause as JClause
from repro.models.loss import softmax_xent as jsoftmax_xent
from repro.optim import adamw as JA
from repro.train.step import jit_train_step
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import get_arch, get_shape
from repro_torch.core import validator as V
from repro_torch.core.combinator import Combination, GlobalKnobs
from repro_torch.core.plan import uniform_plan
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import ops
from repro_torch.launch.train import train
from repro_torch.models.context import SegmentClause
from repro_torch.models.convert import params_from_numpy, tensor_to_numpy
from repro_torch.models.loss import softmax_xent
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim import adamw as TA
from repro_torch.train.step import (init_train_state, make_grads,
                                    make_train_step)
from test_torch_model import _flat, _params

KERNEL = {"plain": "xla", "cuda": "pallas"}     # port clause -> reference
N_STEPS = 5
PEAK_LR, WARMUP = 1e-3, 2      # the loss curve moves within N_STEPS


def _np(x):
    return tensor_to_numpy(x) if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# --- the ops' gradients --------------------------------------------------------

def _fa(window):
    def make(rng):
        q = _rand(rng, (2, 64, 4, 16))
        k = _rand(rng, (2, 64, 2, 16))
        v = _rand(rng, (2, 64, 2, 16))
        return (q, k, v)
    return (make,
            lambda q, k, v: jops.flash_attention(
                q, k, v, window=window, block_q=32, block_k=32),
            lambda q, k, v: ops.flash_attention(q, k, v, window=window,
                                                block_q=32),
            (2e-5, 2e-5))


def _rglru_inputs(rng):
    return (-np.abs(_rand(rng, (1, 32, 8))) * 0.2, _rand(rng, (1, 32, 8)))


def _mlstm_inputs(rng):
    B, H, S, dh = 1, 2, 64, 16
    lf = -np.logaddexp(0, -_rand(rng, (B, H, S)))      # log-sigmoid
    return (_rand(rng, (B, H, S, dh), dh ** -0.5), _rand(rng, (B, H, S, dh)),
            _rand(rng, (B, H, S, dh)), _rand(rng, (B, H, S)),
            lf.astype(np.float32))


def _jvjp(fn, xs, ct):
    """The reference's output and its vjp against ``ct``, under one jit
    (eager Pallas interpret runs op by op, several times slower)."""
    def both(*a):
        out, vjp = jax.vjp(fn, *a)
        return out, vjp(jnp.asarray(ct))
    return jax.jit(both)(*map(jnp.asarray, xs))


OPS = {
    "flash_attention": _fa(0),
    "flash_attention_window": _fa(24),
    "rglru": (_rglru_inputs, lambda la, b: jops.rglru(la, b, chunk=16),
              ops.rglru, (1e-4, 1e-3)),
    "mlstm": (_mlstm_inputs,
              lambda *a: jops.mlstm_chunkwise(*a, chunk=16),
              lambda *a: ops.mlstm_chunkwise(*a, chunk=16), (5e-4, 5e-3)),
    "rmsnorm": (lambda rng: (_rand(rng, (3, 8, 64)), _rand(rng, (64,))),
                jops.rmsnorm, ops.rmsnorm, (1e-5, 1e-5)),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_grads_match_reference(name):
    """The forward and the gradient of every input, against a random
    cotangent, through ``repro.kernels.ops`` (jax.grad of its custom_vjp)
    and the port's autograd Function."""
    make, jfn, tfn, (atol, rtol) = OPS[name]
    rng = np.random.default_rng(0)
    xs = make(rng)
    ct = _rand(rng, jax.eval_shape(jfn, *xs).shape)
    jout, jgrads = _jvjp(jfn, xs, ct)
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    tout = tfn(*ts)
    tgrads = torch.autograd.grad(tout, ts, torch.from_numpy(ct))
    np.testing.assert_allclose(_np(tout), np.asarray(jout), atol=atol,
                               rtol=rtol)
    for i, (t, j) in enumerate(zip(tgrads, jgrads)):
        np.testing.assert_allclose(_np(t), np.asarray(j), atol=atol,
                                   rtol=rtol, err_msg=f"input {i}")


@pytest.mark.parametrize("window", [0, 24])
def test_flash_attention_non_causal_grads_match_reference_math(window):
    """causal=False: the reference's ``custom_vjp`` differentiates its
    causal ``_ref`` whatever it is asked, so the port's backward is held
    to jax.grad of the reference's plain ``flash_attention_ref`` instead."""
    rng = np.random.default_rng(1)
    xs = [_rand(rng, (2, 48, h, 16)) for h in (4, 2, 2)]
    ct = _rand(rng, (2, 48, 4, 16))

    def jfn(q, k, v):
        o = jref.flash_attention_ref(*(jnp.moveaxis(t, 2, 1) for t in
                                       (q, k, v)), causal=False,
                                     window=window)
        return jnp.moveaxis(o, 1, 2)
    _, jgrads = _jvjp(jfn, xs, ct)
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    tgrads = torch.autograd.grad(
        ops.flash_attention(*ts, causal=False, window=window, block_q=16),
        ts, torch.from_numpy(ct))
    for i, (t, j) in enumerate(zip(tgrads, jgrads)):
        np.testing.assert_allclose(_np(t), np.asarray(j), atol=2e-5,
                                   rtol=2e-5, err_msg=f"input {i}")


def test_flash_decode_raises_under_grad():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(_rand(rng, (1, 4, 16)))
    kc = torch.from_numpy(_rand(rng, (1, 32, 2, 16)))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_decode(q.requires_grad_(), kc, kc, 5)
    with torch.no_grad():
        assert ops.flash_decode(q, kc, kc, 5).shape == (1, 4, 16)


# --- loss and optimizer ------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_matches_reference(masked):
    rng = np.random.default_rng(0)
    logits = _rand(rng, (3, 5, 11), 3.0)
    targets = rng.integers(0, 11, (3, 5))
    mask = (rng.random((3, 5)) < 0.6).astype(np.float32) if masked else None
    jl, jm = jsoftmax_xent(jnp.asarray(logits), jnp.asarray(targets),
                           mask=None if mask is None else jnp.asarray(mask))
    jg = jax.grad(lambda x: jsoftmax_xent(
        x, jnp.asarray(targets),
        mask=None if mask is None else jnp.asarray(mask))[0])(
            jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    tl, tm = softmax_xent(x, torch.from_numpy(targets),
                          mask=None if mask is None else torch.from_numpy(mask))
    (tg,) = torch.autograd.grad(tl, x)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   rtol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-7,
                               rtol=1e-5)


def test_cosine_lr_and_global_norm_match_reference():
    for step in (0, 3, 10, 11, 55, 100, 150):
        want = float(JA.cosine_lr(jnp.int32(step), peak_lr=3e-4, warmup=10,
                                  total=100))
        assert TA.cosine_lr(step, peak_lr=3e-4, warmup=10, total=100) == \
            pytest.approx(want, rel=1e-6, abs=1e-12)
    rng = np.random.default_rng(0)
    tree = {"a": _rand(rng, (7, 5)), "b": {"c": _rand(rng, (300,), 3.0)}}
    want = float(JA.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = float(TA.global_norm(tree_map(torch.from_numpy, tree)))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(state_dtype):
    """Three clipped updates of an f32 and a bf16 leaf on the same grads;
    the in-place chunked update against the reference's."""
    rng = np.random.default_rng(0)
    p_np = {"w": _rand(rng, (9, 7)),
            "b": _rand(rng, (33,)).astype(jnp.bfloat16)}
    grads = [{"w": _rand(rng, (9, 7), 2.0),
              "b": _rand(rng, (33,), 2.0).astype(jnp.bfloat16)}
             for _ in range(3)]
    jp = jax.tree.map(jnp.asarray, p_np)
    js = JA.adamw_init(jp, state_dtype)
    tp = params_from_numpy(p_np, "cpu")
    ts = TA.adamw_init(tp, state_dtype)
    for i, g in enumerate(grads):
        lr = 1e-2 * (i + 1)
        jp, js, jm = JA.adamw_update(jax.tree.map(jnp.asarray, g), js, jp,
                                     lr=lr)
        tp, ts, tm = TA.adamw_update(params_from_numpy(g, "cpu"), ts, tp,
                                     lr=lr)
        assert float(jm["grad_norm"]) > 1.0          # the clip is active
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
    assert ts.step == int(js.step) == 3
    assert ts.m["b"].dtype == getattr(torch, state_dtype)
    # a few f32 ulps after three updates (PyTorch fuses a * x + y where
    # XLA rounds twice); one ulp of a bf16 leaf
    ulp = {"w": 1e-5, "b": 2 ** -7}
    for k in p_np:
        np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k], np.float32),
                                   atol=0, rtol=ulp[k], err_msg=k)
        for mine, ref in ((ts.m, js.m), (ts.v, js.v)):
            np.testing.assert_allclose(
                _np(mine[k]), np.asarray(ref[k], np.float32),
                rtol=1e-5 if state_dtype == "float32" else 2 ** -7, err_msg=k)


# --- the train step -----------------------------------------------------------

def _train_setup(name, kernel, remat, mb):
    jcfg = jget_arch(name).smoke()
    tcfg = get_arch(name).smoke()
    jplan = juniform_plan(jcfg, "fsdp",
                          clause=JClause(kernel=KERNEL[kernel], remat=remat),
                          knobs=JKnobs(microbatches=mb, donate=False))
    tplan = uniform_plan(tcfg, "fsdp",
                         clause=SegmentClause(kernel=kernel, remat=remat),
                         knobs=GlobalKnobs(microbatches=mb))
    return jcfg, tcfg, jplan, tplan


@functools.lru_cache(maxsize=None)
def _ref_params(name):
    """The reference's smoke weights of ``name``, drawn once a process
    (JAX arrays are immutable; each test bridges its own torch copy)."""
    return _params(jget_arch(name).smoke())[0]


def _ref_batches(jcfg, n=N_STEPS, seed=3):
    data = JSyntheticLM(jcfg, jget_shape("train_4k").smoke(), seed=seed)
    return [{k: np.asarray(v) for k, v in data.batch_at(s).items()}
            for s in range(n)]


def _torch_batch(b):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in b.items()}


def _trainable(tree):
    return tree_map(lambda t: t.requires_grad_(), tree)


def _assert_grads_close(got, want):
    for path, g in _flat(got).items():
        w = np.asarray(want[path], np.float32)
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=1e-5 + 1e-4 * np.abs(w).max(),
                                   err_msg=path)


@pytest.mark.parametrize("name,kernel,remat,mb", [
    ("granite-8b", "plain", "none", 1),
    ("granite-8b", "plain", "full", 2),
    ("granite-8b", "cuda", "dots", 1),
    ("granite-8b", "cuda", "none", 2),
    ("recurrentgemma-2b", "cuda", "dots", 1),
    ("xlstm-125m", "cuda", "full", 1),
    ("qwen3-moe-30b-a3b", "cuda", "dots", 1),
    ("kimi-k2-1t-a32b", "cuda", "none", 1),
])
def test_train_step_matches_reference(name, kernel, remat, mb):
    """N_STEPS of ``make_train_step`` against ``jit_train_step`` (f32 smoke
    config, the reference's batches): the loss curve, the MoE aux loss, the
    grad norms, the step-0 grads (mb = 1) and the parameters at the
    end."""
    jcfg, tcfg, jplan, tplan = _train_setup(name, kernel, remat, mb)
    batches = _ref_batches(jcfg)
    jp = _ref_params(name)
    tp = _trainable(params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    if mb == 1:
        _, _, tg = make_grads(tcfg, tplan, device="cpu")(
            tp, _torch_batch(batches[0]))

    jstep, _ = jit_train_step(jcfg, None, jplan, peak_lr=PEAK_LR,
                              warmup=WARMUP)
    tstep = make_train_step(tcfg, tplan, device="cpu", peak_lr=PEAK_LR,
                            warmup=WARMUP)
    js = JA.adamw_init(jp)
    ts = TA.adamw_init(tp)
    jl, tl, jn, tn, lrs, ja, ta = [], [], [], [], [], [], []
    for b in batches:
        jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, b))
        if mb == 1 and not tl:
            # the reference's step-0 grads, read back from its f32 first
            # moment: one update from zero leaves m = (1 - b1) * clip * g
            # (a rounding or two, far inside the tolerance), and the test
            # compiles no second gradient program for them
            clip = min(1.0, 1.0 / max(float(jm["grad_norm"]), 1e-9))
            _assert_grads_close(tg, {k: m / ((1 - 0.9) * clip) for k, m in
                                     _flat_jax(js.m).items()})
        tp, ts, tm = tstep(tp, ts, _torch_batch(b))
        jl.append(float(jm["total_loss"]))
        tl.append(float(tm["total_loss"]))
        jn.append(float(jm["grad_norm"]))
        tn.append(float(tm["grad_norm"]))
        lrs.append(float(tm["lr"]))
        ja.append(float(jm["aux_loss"]))
        ta.append(float(tm["aux_loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    np.testing.assert_allclose(ta, ja, rtol=1e-4)
    np.testing.assert_allclose(tn, jn, rtol=1e-4)
    assert jl[-1] != jl[0]                           # the curve moved
    atol = 2 * N_STEPS * max(lrs)
    want = _flat_jax(jp)
    for path, t in _flat(tp).items():
        np.testing.assert_allclose(_np(t), want[path], rtol=0, atol=atol,
                                   err_msg=path)


def _flat_jax(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("name", ["granite-8b", "recurrentgemma-2b",
                                  "xlstm-125m", "qwen3-moe-30b-a3b"])
@pytest.mark.parametrize("kernel", ["plain", "cuda"])
def test_remat_is_exact_on_cpu(name, kernel):
    """remat none, dots and full give the same loss and grads bit for bit
    on the CPU (recomputation reruns the same ops), and no leaf is left
    without a gradient."""
    cfg = get_arch(name).smoke()
    params, _ = init_train_state(cfg, uniform_plan(cfg, "fsdp"),
                                 torch.Generator().manual_seed(0), "cpu")
    batch = SyntheticLM(cfg, get_shape("train_4k").smoke(), seed=1,
                        device="cpu").batch_at(0)
    out = {}
    for remat in ("none", "dots", "full"):
        plan = uniform_plan(cfg, "fsdp", clause=SegmentClause(
            kernel=kernel, remat=remat))
        loss, _, grads = make_grads(cfg, plan, device="cpu")(params, batch)
        out[remat] = (loss, tree_leaves(grads))
    for remat in ("dots", "full"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, b)
    assert all(float(g.abs().max()) > 0 for g in out["none"][1])


# --- data and checkpoints -----------------------------------------------------

def test_data_pure_function_of_step():
    cfg = get_arch("granite-8b").smoke()
    shape = get_shape("train_4k").smoke()
    d1, d2 = (SyntheticLM(cfg, shape, seed=5, device="cpu") for _ in "ab")
    for step in (0, 1, 17):
        b1, b2 = d1.batch_at(step), d2.batch_at(step)
        assert torch.equal(b1["tokens"], b2["tokens"])
        assert b1["tokens"].shape == (shape.global_batch, shape.seq_len)
        assert int(b1["tokens"].max()) < cfg.vocab_size
        assert torch.equal(b1["tokens"][:, 1:], b1["targets"][:, :-1])
    assert not torch.equal(d1.batch_at(0)["tokens"],
                           d1.batch_at(1)["tokens"])
    other = SyntheticLM(cfg, shape, seed=6, device="cpu")
    assert not torch.equal(other.batch_at(0)["tokens"],
                           d1.batch_at(0)["tokens"])


def test_data_host_slices_differ_and_snapshot_restores():
    cfg = get_arch("granite-8b").smoke()
    shape = get_shape("train_4k").smoke()
    hs = [SyntheticLM(cfg, shape, seed=1, host_index=i, host_count=4,
                      device="cpu") for i in range(4)]
    toks = [h.batch_at(0)["tokens"] for h in hs]
    assert toks[0].shape[0] == shape.global_batch // 4
    for i in range(4):
        for j in range(i + 1, 4):
            assert not torch.equal(toks[i], toks[j])
    d = SyntheticLM(cfg, shape, seed=2, device="cpu")
    next(d), next(d)
    snap = d.snapshot()
    want = next(d)
    e = SyntheticLM(cfg, shape, seed=0, device="cpu")
    e.restore(json.loads(json.dumps(snap)))
    assert snap == {"seed": 2, "step": 2}
    assert torch.equal(next(e)["tokens"], want["tokens"])


@pytest.mark.parametrize("asynchronous", [False, True])
def test_checkpoint_restart_exact_replay(tmp_path, asynchronous):
    """6 steps straight against 3, a save, a restore into fresh objects and
    3 more: the same losses and parameters bit for bit.  bf16 weights and
    bf16 optimizer state, so the uint16 storage is on the path."""
    cfg = dataclasses.replace(get_arch("granite-8b").smoke(),
                              dtype="bfloat16")
    shape = get_shape("train_4k").smoke()
    plan = uniform_plan(cfg, "fsdp", knobs=GlobalKnobs(
        opt_state_dtype="bfloat16"))

    def fresh():
        return init_train_state(cfg, plan, torch.Generator().manual_seed(0),
                                "cpu")

    def run(params, opt, lo, hi):
        step = make_train_step(cfg, plan, device="cpu", peak_lr=PEAK_LR,
                               warmup=WARMUP)
        data = SyntheticLM(cfg, shape, seed=7, device="cpu")
        losses = []
        for s in range(lo, hi):
            params, opt, m = step(params, opt, data.batch_at(s))
            losses.append(float(m["total_loss"]))
        return params, opt, losses

    pa, _, la = run(*fresh(), 0, 6)
    pb, ob, _ = run(*fresh(), 0, 3)
    store = CheckpointStore(str(tmp_path), keep=2)
    save = store.save_async if asynchronous else store.save
    save(3, {"params": pb, "opt": ob}, extra={"data": {"seed": 7, "step": 3}})
    store.wait()
    s0, state, extra = CheckpointStore(str(tmp_path)).restore(
        {"params": fresh()[0], "opt": fresh()[1]})
    assert s0 == 3 and extra["data"]["step"] == 3
    assert state["opt"].step == 3
    assert state["params"]["embed"]["tok"].dtype == torch.bfloat16
    assert state["params"]["embed"]["tok"].requires_grad
    pc, _, lc = run(state["params"], state["opt"], 3, 6)
    assert lc == la[3:]
    for a, c in zip(tree_leaves(pa), tree_leaves(pc)):
        assert torch.equal(a, c)


def test_checkpoint_ignores_a_write_without_manifest(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=5)
    tree = {"w": torch.ones(4)}
    store.save(1, {"params": tree})
    (tmp_path / "step_00000002").mkdir()      # a crash mid-write of step 2
    assert store.latest_step() == 1
    step, out, _ = store.restore({"params": tree})
    assert step == 1 and torch.equal(out["params"]["w"], tree["w"])
    for s in range(3, 9):
        store.save(s, {"params": tree})
    assert store.steps() == [4, 5, 6, 7, 8]


# --- validator and CLI --------------------------------------------------------

@pytest.mark.parametrize("clause,broken,expect", [
    (dict(remat="dots", kernel="plain"), None, "ok"),
    (dict(remat="full", kernel="cuda", mlstm_chunk=16, block_q=16), None,
     "ok"),
    (dict(remat="full"), "nan", "NaN"),
    (dict(remat="full"), "offset", "mismatch"),
])
def test_validate_plan(monkeypatch, clause, broken, expect):
    """A good plan passes; a plan whose forward goes wrong (corrupted for
    remat='full' candidates only, as the reference's test does) fails."""
    real = V.forward

    def corrupted(params, batch, cfg, ctxs):
        logits, aux = real(params, batch, cfg, ctxs)
        if any(c.clause.remat == "full" for c in ctxs.values()):
            logits = logits + (float("nan") if broken == "nan" else 7.0)
        return logits, aux

    if broken:
        monkeypatch.setattr(V, "forward", corrupted)
    cfg = get_arch("recurrentgemma-2b")
    ok, msg = V.validate_combination(cfg, Combination(
        "fsdp", frozenset(), SegmentClause(**clause)))
    assert ok == (broken is None), msg
    assert expect in msg


def test_launch_train_resumes_where_it_stopped(tmp_path):
    """``launch.train`` on the CPU with a plan file written by the
    reference (``pallas`` -> ``cuda``): 4 steps straight, against 2 steps
    and a restart from the latest checkpoint."""
    jcfg = jget_arch("xlstm-125m").smoke()
    plan = tmp_path / "plan.json"
    juniform_plan(jcfg, "fsdp", clause=JClause(kernel="pallas",
                                               remat="dots")).save(str(plan))
    common = ["--arch", "xlstm-125m", "--smoke", "--device", "cpu",
              "--plan", str(plan), "--lr", str(PEAK_LR), "--warmup",
              str(WARMUP)]
    straight = train(common + ["--steps", "4", "--resume", "never",
                               "--ckpt-dir", str(tmp_path / "a")])
    first = train(common + ["--steps", "2", "--ckpt-dir",
                            str(tmp_path / "b")])
    rest = train(common + ["--steps", "4", "--ckpt-dir",
                           str(tmp_path / "b")])
    assert len(straight) == 4 and first == straight[:2]
    assert rest == straight[2:]
    assert CheckpointStore(str(tmp_path / "b")).steps() == [2, 4]
