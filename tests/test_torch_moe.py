"""The port's MoE FFN and MoE archs on the CPU against the JAX package.

Smoke configs (d 64, 8 experts top-2; qwen3-moe-30b-a3b-smoke has 2
``attn_moe`` layers, kimi-k2-1t-a32b-smoke a dense ``attn`` layer and 2
``attn_moe`` layers), weights and inputs made from a numpy seed or drawn
as ``test_torch_model._params`` draws them.  The reference runs as its
own tests run it (its ``pallas`` clause in interpret mode); the port's
``cuda`` clause takes the kernels' plain versions on the CPU.

Tolerances: ``moe_apply`` and its aux loss 2e-5 in f32, the flash-attention
kernel's f32 floor; f32 logits 2e-4 (``test_torch_model``).  In bf16 a
one-ulp difference of two sums can swap a near-tie of the router's top-k,
which changes that token's FFN output by O(1): bf16 logits are held
pointwise (5e-2) only at tokens whose expert sets agree in every layer,
and the agreeing share is held too.
"""
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_shape as jget_shape
from repro.core.segment import fragment as jfragment
from repro.core.tuner import ComParTuner as JTuner
from repro.core import cost_model as JCM
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.models.context import ModelContext as JCtx
from repro.models.layers import dense as jdense
from repro_torch.configs import get_arch, get_shape
from repro_torch.core import cost_model as TCM
from repro_torch.core.plan import uniform_plan
from repro_torch.core.segment import fragment
from repro_torch.core.tuner import ComParTuner
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models import params as TP
from repro_torch.models.context import ModelContext, SegmentClause
from repro_torch.models.params import init_params, param_count, tree_leaves
from repro_torch.serve.engine import ServeEngine
from test_torch_model import TOL, _cfgs, _close, _ctxs, _params
from test_torch_sweep import (TableExecutor, _clause_json, _plan_key,
                              _swept)

MOE = ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"]
MOE_TOL = 2e-5


def _moe_weights(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s.shape) * s.scale).astype(np.float32)
            for k, s in TMOE.moe_specs(cfg).items()}


def _run_both(jcfg, tcfg, w, x, groups=1):
    jy, jaux = JMOE.moe_apply({k: jnp.asarray(v) for k, v in w.items()},
                              jnp.asarray(x), jcfg, JCtx(moe_groups=groups))
    ty, taux = TMOE.moe_apply({k: torch.from_numpy(v) for k, v in w.items()},
                              torch.from_numpy(x), tcfg,
                              ModelContext(moe_groups=groups))
    return (np.asarray(jy), float(jaux)), (ty.numpy(), float(taux))


def _ref_route(jcfg, router, xf):
    """The reference's router math on (G, S, d): gates, idx."""
    logits = jdense(jnp.asarray(xf), jnp.asarray(router)).astype(
        jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    gates, idx = jax.lax.top_k(probs, jcfg.experts_per_token)
    gates = gates / jnp.clip(jnp.sum(gates, -1, keepdims=True), 1e-9)
    return gates, idx


# --- the MoE FFN ----------------------------------------------------------------

@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("name", MOE)
def test_moe_apply_matches_reference(name, groups):
    jcfg, tcfg = _cfgs(name)
    w = _moe_weights(tcfg)
    x = np.random.default_rng(1).standard_normal(
        (2, 24, tcfg.d_model)).astype(np.float32)
    (jy, jaux), (ty, taux) = _run_both(jcfg, tcfg, w, x, groups)
    np.testing.assert_allclose(ty, jy, atol=MOE_TOL, rtol=MOE_TOL)
    assert taux == pytest.approx(jaux, abs=MOE_TOL, rel=MOE_TOL)
    assert taux > 0


@pytest.mark.parametrize("name", MOE)
def test_forced_overflow_drops_the_same_assignments(name):
    """moe_capacity_factor lowered so that C is below the busiest expert's
    count: the same (token, slot) assignments are dropped, the dispatch
    info and the kept buffer rows are the reference's exactly, and the
    outputs agree."""
    jcfg, tcfg = _cfgs(name)
    jcfg = dataclasses.replace(jcfg, moe_capacity_factor=0.3)
    tcfg = dataclasses.replace(tcfg, moe_capacity_factor=0.3)
    E, k, d = tcfg.num_experts, tcfg.experts_per_token, tcfg.d_model
    w = _moe_weights(tcfg, seed=2)
    x = np.random.default_rng(3).standard_normal((2, 24, d)).astype(
        np.float32)
    T = x.shape[0] * x.shape[1]
    C = TMOE.capacity(tcfg, T)
    assert C == JMOE.capacity(jcfg, T)
    xf = x.reshape(1, T, d)
    jg, ji = _ref_route(jcfg, w["router"], xf)
    _, tg, ti = TMOE.route(torch.from_numpy(w["router"]),
                           torch.from_numpy(xf), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)
    counts = np.bincount(np.asarray(ji).ravel(), minlength=E)
    assert counts.max() > C                # the overflow is forced
    jbuf, jinfo = JMOE._dispatch_group(jnp.asarray(xf[0]), jg[0], ji[0], E,
                                       C)
    tbuf, tinfo = TMOE._dispatch_group(torch.from_numpy(xf[0]), tg[0],
                                       ti[0], E, C)
    for j, t in zip(jinfo, tinfo):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    jslot, jorder = np.asarray(jinfo[1]), np.asarray(jinfo[3])
    tslot, torder = tinfo[1].numpy(), tinfo[3].numpy()
    dropped = {(int(o) // k, int(o) % k) for o, s in zip(jorder, jslot)
               if s == C}
    assert dropped == {(int(o) // k, int(o) % k)
                       for o, s in zip(torder, tslot) if s == C}
    assert len(dropped) == int(np.maximum(counts - C, 0).sum()) > 0
    # the kept rows of the buffer (the reference's slot C holds a dropped
    # token, which its combine zeroes; the port does not build that row)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf)[:, :C])
    (jy, jaux), (ty, taux) = _run_both(jcfg, tcfg, w, x)
    np.testing.assert_allclose(ty, jy, atol=MOE_TOL, rtol=MOE_TOL)
    assert taux == pytest.approx(jaux, abs=MOE_TOL, rel=MOE_TOL)


def test_top_k_ties_put_the_lower_expert_first():
    """A tie in the router's probabilities: the port's stable sort orders
    it as ``jax.lax.top_k`` does (the lower index first)."""
    probs = np.array([[0.1, 0.3, 0.2, 0.3, 0.1]], np.float32)
    _, want = jax.lax.top_k(jnp.asarray(probs), 3)
    got = torch.sort(torch.from_numpy(probs), dim=-1, descending=True,
                     stable=True).indices[..., :3]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and route() keeps that order through a router
    router = torch.eye(5)
    _, _, idx = TMOE.route(router, torch.log(torch.from_numpy(probs)), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))


def test_combine_is_deterministic_and_row_independent():
    """Each token's output depends on its own inputs alone while no token
    is dropped: a row computed in a batch of 8 equals the row computed
    alone (both at full capacity, as the serving engine's batched step
    always is), bit for bit."""
    cfg = get_arch("qwen3-moe-30b-a3b").smoke()
    w = {k: torch.from_numpy(v) for k, v in _moe_weights(cfg).items()}
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (8, 1, cfg.d_model)).astype(np.float32))
    ctx = ModelContext(decode=True)
    full, aux = TMOE.moe_apply(w, x, cfg, ctx)
    assert aux is None                          # decode discards it
    for b in range(8):
        solo = x.clone()
        solo[np.arange(8) != b] = 0.0
        y, _ = TMOE.moe_apply(w, solo, cfg, ctx)
        assert torch.equal(y[b], full[b])
    again, _ = TMOE.moe_apply(w, x, cfg, ctx)
    assert torch.equal(again, full)


# --- the MoE archs --------------------------------------------------------------

def test_param_counts_within_reference_windows():
    """The windows of the reference's ``test_param_counts_match_nominal``
    (specs only: nothing is allocated)."""
    windows = {"qwen3-moe-30b-a3b": (28e9, 32e9),
               "kimi-k2-1t-a32b": (0.95e12, 1.1e12)}
    for name, (lo, hi) in windows.items():
        n = param_count(TM.model_specs(get_arch(name)))
        assert lo <= n <= hi, f"{name}: {n / 1e9:.2f}B"
    # qwen3: 30.53 B, 56.9 GiB in bf16 (one H100 holds it)
    q = param_count(TM.model_specs(get_arch("qwen3-moe-30b-a3b")))
    assert round(q / 1e9, 2) == 30.53


@pytest.mark.parametrize("name", MOE)
def test_decode_vector_pos_matches_reference(name):
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(jcfg)
    jctx, tctx = _ctxs(jcfg, tcfg, "cuda")
    B, Smax = 3, 8
    base = np.array([0, 2, 1])
    jc, tc = JM.init_cache(jcfg, B, Smax), TM.init_cache(tcfg, B, Smax, "cpu")
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (3, B))
    for i in range(3):
        pos = base + i
        jl, jc = JM.decode_step(jp, jc, jnp.asarray(toks[i], jnp.int32),
                                jnp.asarray(pos, jnp.int32), jcfg, jctx)
        tl, tc = TM.decode_step(tp, tc, torch.from_numpy(toks[i]),
                                torch.from_numpy(pos), tcfg, tctx)
        _close(tl, jl)
    g = f"g{len(tcfg.stack_plan()) - 1}"          # the MoE group
    _close(tc[g]["b0"]["k"], jc[g]["b0"]["k"])


def _record_port_routes(monkeypatch):
    got = []
    orig = TMOE.route

    def rec(router, xf, k):
        out = orig(router, xf, k)
        got.append(out[2].reshape(-1, k).numpy())
        return out
    monkeypatch.setattr(TMOE, "route", rec)
    return got


def _record_ref_routes(monkeypatch):
    """The reference's top-k of every MoE layer, in layer order, through a
    debug callback (its stacked groups run under ``lax.scan``)."""
    got = []
    orig = jax.lax.top_k

    def rec(x, k):
        vals, idx = orig(x, k)
        jax.debug.callback(lambda i: got.append(np.asarray(i)), idx,
                           ordered=True)
        return vals, idx
    monkeypatch.setattr(jax.lax, "top_k", rec)
    return got


def _kept_experts(idx, E, C):
    """Each token's kept experts (a dropped assignment reads -1), sorted,
    from one layer's (T, k) routing: the dispatch's stable order gives an
    assignment the slot of its rank among the earlier assignments to its
    expert, and a slot >= C is dropped."""
    flat = idx.reshape(-1)
    hot = flat[:, None] == np.arange(E)
    rank = (np.cumsum(hot, axis=0) - 1)[np.arange(flat.size), flat]
    return np.sort(np.where(rank < C, flat, -1).reshape(idx.shape), -1)


def routing_agreement(routes_a, routes_b, shape, E, C):
    """(share of (token, layer) pairs whose kept experts agree, the tokens
    to hold pointwise).  A token is held when its kept experts agree in
    every layer and so do those of every earlier token of its sequence: a
    changed expert set changes that token's output by O(1), and causal
    attention carries it to the later tokens."""
    same = np.stack([(_kept_experts(a, E, C) == _kept_experts(b, E, C)
                      ).all(-1) for a, b in zip(routes_a, routes_b)])
    clean = same.all(0).reshape(shape)
    return float(same.mean()), np.cumprod(clean, axis=-1).astype(bool)


@pytest.mark.parametrize("name", MOE)
def test_bf16_forward_routing_agreement(monkeypatch, name):
    """bf16 logits: the kept expert sets are compared per token and layer
    first (at least 90% of the pairs must agree); the logits are held
    pointwise at the tokens whose routing, and that of every earlier token
    of their sequence, agrees in every layer."""
    jcfg, tcfg = _cfgs(name, "bfloat16")
    jp, tp = _params(jcfg)
    jctx, tctx = _ctxs(jcfg, tcfg, "plain")
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 32))
    jroutes = _record_ref_routes(monkeypatch)
    # XLA's CPU runtime has no bf16 x bf16 -> f32 dot (the reference's
    # expert einsums, ``preferred_element_type=f32``): the same products on
    # f32 copies, which are exact, summed in f32 as the card's would be
    einsum = jnp.einsum

    def f32_einsum(spec, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            ops = [o.astype(jnp.float32) for o in ops]
        return einsum(spec, *ops, preferred_element_type=
                      preferred_element_type, **kw)
    monkeypatch.setattr(jnp, "einsum", f32_einsum)
    jl, _ = JM.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jcfg,
                       jctx)
    jax.effects_barrier()
    troutes = _record_port_routes(monkeypatch)
    tl, _ = TM.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg, tctx)
    n_moe = tcfg.num_layers - tcfg.first_k_dense
    assert len(jroutes) == len(troutes) == n_moe
    k = tcfg.experts_per_token
    share, held = routing_agreement(
        [j.reshape(-1, k) for j in jroutes], troutes, toks.shape,
        tcfg.num_experts, TMOE.capacity(tcfg, toks.size))
    assert share >= 0.9, share
    assert held.mean() >= 0.25, held.mean()   # the pointwise check bites
    got = tl.float().numpy()[held]
    want = np.asarray(jl, np.float32)[held]
    np.testing.assert_allclose(got, want, atol=TOL["bfloat16"],
                               rtol=TOL["bfloat16"])


def test_engine_logs_the_moe_warning(caplog):
    def plan(cfg):
        return uniform_plan(cfg, "tensor_par", set(), SegmentClause())
    with caplog.at_level(logging.WARNING, logger="repro_torch.serve"):
        cfg = get_arch("qwen3-moe-30b-a3b").smoke()
        ServeEngine(cfg, plan(cfg), device="cpu")
    assert any("is MoE" in r.getMessage() and cfg.name in r.getMessage()
               for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="repro_torch.serve"):
        cfg = get_arch("granite-8b").smoke()
        ServeEngine(cfg, plan(cfg), device="cpu")
    assert not [r for r in caplog.records if "is MoE" in r.getMessage()]


def test_engine_bounds_moe_requests_by_cache_len():
    """An attn_moe stack's KV caches bound a request's length, as an attn
    stack's do."""
    from repro_torch.serve.engine import Request
    cfg = get_arch("qwen3-moe-30b-a3b").smoke()
    eng = ServeEngine(cfg, uniform_plan(cfg, "tensor_par", set()),
                      capacity=2, cache_len=8, device="cpu")
    with pytest.raises(ValueError, match="cache_len=8"):
        eng.run([Request(rid="a", prompt=(1, 2, 3), max_new_tokens=6)])


# --- weights --------------------------------------------------------------------

def _old_init(specs, seed, device="cpu"):
    """``init_params`` as it drew before large draws were sliced: a leaf
    whole, a stacked leaf one layer at a time."""
    root = torch.Generator().manual_seed(seed).initial_seed()

    def one(path, spec):
        if spec.init in ("zeros", "ones"):
            return (torch.zeros if spec.init == "zeros" else torch.ones)(
                spec.shape, dtype=spec.tdtype)
        g = torch.Generator(device=device)
        g.manual_seed(TP.leaf_seed(root, path))

        def draw(shape):
            return torch.randn(shape, generator=g, dtype=torch.float32).mul_(
                spec.scale).to(spec.tdtype)
        if spec.logical_axes[0] != "layers":
            return draw(spec.shape)
        return torch.stack([draw(spec.shape[1:])
                            for _ in range(spec.shape[0])])
    return TP.tree_map_with_path(one, specs)


@pytest.mark.parametrize("name", ["granite-8b", "qwen3-moe-30b-a3b"])
def test_init_draws_unchanged_below_the_slice_size(name):
    cfg = get_arch(name).smoke()
    specs = TM.model_specs(cfg)
    for a, b in zip(tree_leaves(init_params(
            specs, torch.Generator().manual_seed(3), "cpu")),
            tree_leaves(_old_init(specs, 3))):
        assert torch.equal(a, b)
    # at full width no leaf of granite or qwen3 reaches a sliced draw
    for s in tree_leaves(TM.model_specs(get_arch(name))):
        shape = s.shape[1:] if s.logical_axes[0] == "layers" else s.shape
        assert np.prod(shape) <= TP.MAX_DRAW


def test_large_draws_go_in_slices(monkeypatch):
    """A draw of more than MAX_DRAW elements is made in slices along its
    first axis: seeded, of the same shape and dtype."""
    cfg = get_arch("kimi-k2-1t-a32b").smoke()
    specs = TM.model_specs(cfg)
    whole = init_params(specs, torch.Generator().manual_seed(0), "cpu")
    monkeypatch.setattr(TP, "MAX_DRAW", 1000)
    a = init_params(specs, torch.Generator().manual_seed(0), "cpu")
    b = init_params(specs, torch.Generator().manual_seed(0), "cpu")
    wi = a["g1"]["b0"]["ffn"]["wi"]            # (layers, 8, 64, 96)
    assert wi.shape == whole["g1"]["b0"]["ffn"]["wi"].shape
    assert wi.dtype == whole["g1"]["b0"]["ffn"]["wi"].dtype
    assert torch.equal(wi, b["g1"]["b0"]["ffn"]["wi"])
    # the CPU generator's stream runs on across the slices, so there the
    # slices give the whole draw's values (the card's Philox offsets do
    # not: its sliced draws differ from a whole one)
    assert torch.equal(wi, whole["g1"]["b0"]["ffn"]["wi"])
    assert not torch.equal(wi[0, 0], wi[0, 1])
    tok = a["embed"]["tok"]
    assert tok.shape == (cfg.vocab_size, cfg.d_model)
    assert float(tok.float().std()) == pytest.approx(1.0, rel=0.1)
    # kimi at full width: its embedding and expert leaves are sliced
    full = TM.model_specs(get_arch("kimi-k2-1t-a32b"))
    assert np.prod(full["embed"]["tok"].shape) > 2 ** 30
    assert np.prod(full["g1"]["b0"]["ffn"]["wi"].shape[1:]) > 2 ** 30


# --- the sweep over an MoE model ------------------------------------------------

def test_tuner_on_moe_matches_reference():
    """Both tuners on qwen3-moe-30b-a3b-smoke through one table executor:
    the same segments, relevant clause fields (``moe_dispatch`` on the MoE
    stack), rows (``expert_par``'s among them) and plan; then the port's
    dry run completes every row."""
    jcfg, tcfg = _cfgs("qwen3-moe-30b-a3b")
    jshape, tshape = jget_shape("train_4k").smoke(), \
        get_shape("train_4k").smoke()
    for js, ts in zip(jfragment(jcfg), fragment(tcfg)):
        assert ts.to_json() == js.to_json()
        assert ts.relevant_clause_fields("train") == \
            js.relevant_clause_fields("train")
    stack = [s for s in fragment(tcfg) if s.kind == "stack"]
    assert stack and all("moe_dispatch" in s.relevant_clause_fields("train")
                         for s in stack)
    jt = JTuner(jcfg, jshape, None, executor="dryrun")
    tt = ComParTuner(tcfg, tshape, device="cpu", executor="dryrun")
    jplan, jrep = _swept(jt, TableExecutor(JCM.CostTerms))
    tplan, trep = _swept(tt, TableExecutor(TCM.CostTerms))
    assert _plan_key(tplan) == _plan_key(jplan)
    for f in ("n_combinations", "n_done", "n_inapplicable", "n_scored",
              "n_shared", "per_knob_total_s"):
        assert getattr(trep, f) == getattr(jrep, f), f

    def rows(tuner):
        return [(r["segment"], _clause_json(r["combo"]), r["status"])
                for r in tuner.db.results(tuner.project)]
    assert rows(tt) == rows(jt)
    ep = [r for r in rows(tt) if r[1][0] == "expert_par"]
    assert {r[0] for r in ep} == {s.name for s in fragment(tcfg)}
    assert all(r[2] == "done" for r in ep)

    dry = ComParTuner(tcfg, tshape, device="cpu", executor="dryrun")
    plan, rep = dry.sweep(["expert_par", "fsdp"],
                          {"remat": ("none", "dots"),
                           "kernel": ("plain", "cuda"), "block_q": (16,)})
    assert rep.n_done == rep.n_combinations > 0
    assert all(v["max"] <= 1.0 for v in dry.audit_soundness().values())
