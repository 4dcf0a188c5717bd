"""The port's model on the CPU against the JAX package, on the same weights.

Reference parameters are drawn as ``repro.models.params.init_params``
draws them, with per-leaf keys that do not change between runs (see
``_params``), carried through numpy into the port by
``params_from_numpy``, and both packages run the same seeded tokens.  Tolerances: 2e-4 on f32 logits
(XLA and PyTorch sum matrix products in different orders); 5e-2 on bf16
logits (one bf16 ulp of the residual stream is 2^-8 relative).
"""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core.plan import build_contexts as jbuild_contexts
from repro.core.plan import uniform_plan as juniform_plan
from repro.models import model as JM
from repro.models.context import SegmentClause as JClause
from repro.models.params import is_spec
from repro.serve.step import make_prefill as jmake_prefill
from repro_torch.configs import get_arch
from repro_torch.core.plan import build_contexts, uniform_plan
from repro_torch.models import model as TM
from repro_torch.models.context import SegmentClause
from repro_torch.models.convert import (params_from_numpy, tensor_from_numpy,
                                        tensor_to_numpy)
from repro_torch.models.params import init_params, tree_leaves
from repro_torch.serve.step import make_prefill, make_prefill_cache

TOL = {"float32": 2e-4, "bfloat16": 5e-2}
KERNEL = {"plain": "xla", "cuda": "pallas"}     # port clause -> reference


def _cfgs(name, dtype="float32"):
    j = dataclasses.replace(jget_arch(name).smoke(), dtype=dtype)
    t = dataclasses.replace(get_arch(name).smoke(), dtype=dtype)
    return j, t


def _ctxs(jcfg, tcfg, kernel):
    jplan = juniform_plan(jcfg, "tensor_par", set(),
                          JClause(kernel=KERNEL[kernel]))
    tplan = uniform_plan(tcfg, "tensor_par", set(),
                         SegmentClause(kernel=kernel))
    return jbuild_contexts(jcfg, None, jplan), build_contexts(tcfg, tplan)


def _params(jcfg, seed=0):
    """Reference weights as ``repro.models.params.init_params`` draws them,
    but each leaf's key folds in the crc32 of its path where the reference
    folds in ``hash()``, which changes with every process: the same weights
    in every run.  Returns (reference params, the port's bridged copy)."""
    key = jax.random.key(seed)

    def init_one(path, spec):
        if spec.init in ("zeros", "ones"):
            return (jnp.zeros if spec.init == "zeros" else jnp.ones)(
                spec.shape, spec.jdtype)
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        k = jax.random.fold_in(key, zlib.crc32(name.encode()) % (2**31 - 1))
        return (jax.random.normal(k, spec.shape, jnp.float32) * spec.scale
                ).astype(spec.jdtype)

    jp = jax.tree_util.tree_map_with_path(init_one, JM.model_specs(jcfg),
                                          is_leaf=is_spec)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _np(x):
    return tensor_to_numpy(x) if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


def _close(got, want, dtype="float32"):
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


# --- weights ----------------------------------------------------------------

def test_bf16_bits_carried_exactly():
    x = np.array([1.0, -2.5, 3.140625, 1e-3, 65504.0, -0.0],
                 dtype=ml_dtypes.bfloat16)
    t = tensor_from_numpy(x, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  x.view(np.int16))
    np.testing.assert_array_equal(tensor_to_numpy(t), x.astype(np.float32))


JAX_TO_TORCH = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@pytest.mark.parametrize("name", ["granite-8b", "stablelm-3b",
                                  "recurrentgemma-2b", "xlstm-125m",
                                  "qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"])
def test_param_tree_matches_reference(name):
    jcfg, tcfg = _cfgs(name, "bfloat16")
    jp, tp = _params(jcfg)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    seen = _flat(tp)
    assert sorted(seen) == sorted(flat)
    for path, t in seen.items():
        assert tuple(t.shape) == flat[path].shape, path
        # bf16 leaves; the recurrent archs' f32 gate / state weights and
        # the MoE routers are f32
        assert t.dtype == JAX_TO_TORCH[flat[path].dtype.name], path
        np.testing.assert_array_equal(tensor_to_numpy(t),
                                      np.asarray(flat[path], np.float32))
    # the port's own init gives the same tree of shapes and dtypes
    own = _flat(init_params(TM.model_specs(tcfg),
                            torch.Generator().manual_seed(0), "cpu"))
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in seen.items()}


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "xlstm-125m",
                                  "qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"])
def test_full_config_specs_match_reference(name):
    """At the published widths (no weights made): the same leaves, shapes
    and dtypes, the same cache / state shapes, and the same stack plan."""
    from repro.models.params import param_count as jparam_count
    from repro_torch.models.params import param_count
    jspecs = JM.model_specs(jget_arch(name))
    tspecs = TM.model_specs(get_arch(name))
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
             for path, leaf in jax.tree_util.tree_flatten_with_path(
                 jspecs, is_leaf=lambda x: hasattr(x, "logical_axes"))[0]}
    tflat = _flat(tspecs)
    assert sorted(tflat) == sorted(jflat)
    for path, spec in tflat.items():
        want = jflat[path]
        assert (spec.shape, spec.dtype, spec.logical_axes) == (
            tuple(want.shape), want.dtype, tuple(want.logical_axes)), path
    assert param_count(tspecs) == jparam_count(jspecs)
    jc = _flat(JM.cache_specs(jget_arch(name), 2, 4096))
    tc = _flat(TM.cache_specs(get_arch(name), 2, 4096))
    assert {k: (tuple(v.shape), v.dtype.name) for k, v in jc.items()} == \
        {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
         for k, v in tc.items()}
    assert [(g.pattern, g.repeats) for g in get_arch(name).stack_plan()] \
        == [(g.pattern, g.repeats) for g in jget_arch(name).stack_plan()]


def test_init_params_seeded_and_stable():
    tcfg = get_arch("granite-8b").smoke()
    specs = TM.model_specs(tcfg)
    a = init_params(specs, torch.Generator().manual_seed(3), "cpu")
    b = init_params(specs, torch.Generator().manual_seed(3), "cpu")
    c = init_params(specs, torch.Generator().manual_seed(4), "cpu")
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    wq = a["g0"]["b0"]["attn"]["wq"]
    assert not torch.equal(wq, c["g0"]["b0"]["attn"]["wq"])
    # stacked layers are drawn slice by slice, so they differ
    assert not torch.equal(wq[0], wq[1])


# --- forward ----------------------------------------------------------------

@pytest.mark.parametrize("name,dtype,kernel", [
    ("granite-8b", "float32", "plain"),
    ("stablelm-3b", "float32", "plain"),
    ("granite-8b", "bfloat16", "plain"),
    ("granite-8b", "float32", "cuda"),      # plain version on CPU vs Pallas
    ("recurrentgemma-2b", "float32", "plain"),
    ("recurrentgemma-2b", "float32", "cuda"),
    ("xlstm-125m", "float32", "plain"),
    ("xlstm-125m", "float32", "cuda"),
    ("qwen3-moe-30b-a3b", "float32", "plain"),
    ("qwen3-moe-30b-a3b", "float32", "cuda"),
    ("kimi-k2-1t-a32b", "float32", "plain"),
    ("kimi-k2-1t-a32b", "float32", "cuda"),
])
def test_forward_logits_match_reference(name, dtype, kernel):
    jcfg, tcfg = _cfgs(name, dtype)
    jp, tp = _params(jcfg)
    jctx, tctx = _ctxs(jcfg, tcfg, kernel)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 16))
    jl, jaux = JM.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                          jcfg, jctx)
    tl, aux = TM.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg, tctx)
    assert tl.dtype == torch.float32 and tl.shape == (2, 16, jcfg.vocab_size)
    # the MoE archs' load-balancing loss; 0 for every other arch
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5, abs=1e-5)
    assert (float(aux) > 0) == tcfg.is_moe
    _close(tl, jl, dtype)


# --- decode -----------------------------------------------------------------

@pytest.mark.parametrize("name,kernel", [("granite-8b", "cuda"),
                                         ("stablelm-3b", "plain"),
                                         ("qwen3-moe-30b-a3b", "cuda"),
                                         ("kimi-k2-1t-a32b", "plain")])
def test_decode_step_scalar_pos_matches_reference(name, kernel):
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(jcfg)
    jctx, tctx = _ctxs(jcfg, tcfg, kernel)
    B, Smax = 2, 8
    jc, tc = JM.init_cache(jcfg, B, Smax), TM.init_cache(tcfg, B, Smax, "cpu")
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (3, B))
    for i in range(3):
        jl, jc = JM.decode_step(jp, jc, jnp.asarray(toks[i], jnp.int32),
                                jnp.int32(i), jcfg, jctx)
        tl, tc = TM.decode_step(tp, tc, torch.from_numpy(toks[i]), i, tcfg,
                                tctx)
        _close(tl, jl)
    _close(tc["g0"]["b0"]["k"], jc["g0"]["b0"]["k"])
    _close(tc["g0"]["b0"]["v"], jc["g0"]["b0"]["v"])


@pytest.mark.parametrize("upcast", [True, False])
def test_decode_step_vector_pos_matches_reference(upcast):
    jcfg, tcfg = _cfgs("granite-8b")
    jp, tp = _params(jcfg)
    jplan = juniform_plan(jcfg, "tensor_par", set(),
                          JClause(kernel="pallas", cache_upcast=upcast))
    tplan = uniform_plan(tcfg, "tensor_par", set(),
                         SegmentClause(kernel="cuda", cache_upcast=upcast))
    jctx, tctx = jbuild_contexts(jcfg, None, jplan), build_contexts(tcfg,
                                                                    tplan)
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
    _close(tc["g0"]["b0"]["k"], jc["g0"]["b0"]["k"])


@pytest.mark.parametrize("kernel", ["plain", "cuda"])
def test_prefill_cache_last_logits_match_prefill(kernel):
    jcfg, tcfg = _cfgs("granite-8b")
    jp, tp = _params(jcfg)
    tplan = uniform_plan(tcfg, "tensor_par", set(),
                         SegmentClause(kernel=kernel))
    prompt = torch.tensor([[3, 1, 4, 1, 5, 9, 2]])
    first, last, caches = make_prefill_cache(tcfg, tplan, device="cpu")(
        tp, TM.init_cache(tcfg, 1, 16, "cpu"), prompt)
    full = make_prefill(tcfg, tplan, device="cpu")(tp, {"tokens": prompt})
    _close(last[0], full[0, -1])
    assert int(first[0]) == int(torch.argmax(full[0, -1]))
    # the filled cache holds exactly the prompt's slots
    k = caches["g0"]["b0"]["k"]
    assert k[:, :, :, :7].abs().sum() > 0 and k[:, :, 7:].abs().sum() == 0
    # and the full-sequence prefill agrees with the reference's
    jplan = juniform_plan(jcfg, "tensor_par", set(),
                          JClause(kernel=KERNEL[kernel]))
    jfwd, _ = jmake_prefill(jcfg, None, jplan)
    _close(full, jfwd(jp, {"tokens": jnp.asarray(prompt.numpy(),
                                                  jnp.int32)}))


# --- sliding window (no registered arch uses it yet; the code path is kept) --

@pytest.mark.parametrize("window", [0, 4])
def test_chunked_attention_matches_reference(window):
    from repro.models.attention import chunked_attention as jchunked
    from repro_torch.models.attention import chunked_attention
    rng = np.random.default_rng(window)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 32, 4, 16), (2, 32, 2, 16), (2, 32, 2, 16)))
    pos = np.arange(32)
    want = jchunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    pos_q=jnp.asarray(pos), pos_k=jnp.asarray(pos),
                    window=window, q_chunk=8)
    tp = torch.from_numpy(pos)
    got = chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), pos_q=tp, pos_k=tp,
                            window=window, q_chunk=8)
    _close(got, want)


def test_windowed_decode_ring_buffer_matches_reference():
    jcfg, tcfg = (dataclasses.replace(c, window_size=4)
                  for c in _cfgs("granite-8b"))
    jp, tp = _params(jcfg)
    jctx, tctx = _ctxs(jcfg, tcfg, "plain")
    B, Smax = 2, 8                          # cache_len = window = 4: wraps
    jc, tc = JM.init_cache(jcfg, B, Smax), TM.init_cache(tcfg, B, Smax, "cpu")
    assert tc["g0"]["b0"]["k"].shape[2] == 4
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (6, B))
    for i in range(6):
        jl, jc = JM.decode_step(jp, jc, jnp.asarray(toks[i], jnp.int32),
                                jnp.int32(i), jcfg, jctx)
        tl, tc = TM.decode_step(tp, tc, torch.from_numpy(toks[i]), i, tcfg,
                                tctx)
        _close(tl, jl)


# --- recurrent archs: decode state and prefill cache ---------------------------

def _deep_cfgs(name):
    """Smoke widths with a stacked group (repeats 2) and a tail group, so
    recurrent state lives in per-layer views of stacked leaves; for
    recurrentgemma a window of 4, so the attention ring buffer wraps."""
    layers = {"recurrentgemma-2b": 7, "xlstm-125m": 9}[name]
    kw = dict(num_layers=layers)
    if name == "recurrentgemma-2b":
        kw["window_size"] = 4
    return tuple(dataclasses.replace(c, **kw) for c in _cfgs(name))


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "xlstm-125m"])
@pytest.mark.parametrize("vector_pos", [False, True])
def test_recurrent_decode_step_matches_reference(name, vector_pos):
    jcfg, tcfg = _deep_cfgs(name)
    assert [g.repeats for g in tcfg.stack_plan()] == [2, 1]
    jp, tp = _params(jcfg)
    jctx, tctx = _ctxs(jcfg, tcfg, "cuda")
    B = 3
    base = np.array([0, 2, 1]) if vector_pos else np.zeros(B, np.int64)
    jc, tc = JM.init_cache(jcfg, B, 8), TM.init_cache(tcfg, B, 8, "cpu")
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (6, B))
    jstep = jax.jit(lambda p, c, t, i: JM.decode_step(p, c, t, i, jcfg,
                                                      jctx))
    for i in range(6):
        if vector_pos:
            jpos, tpos = jnp.asarray(base + i, jnp.int32), \
                torch.from_numpy(base + i)
        else:
            jpos, tpos = jnp.int32(i), i
        jl, jc = jstep(jp, jc, jnp.asarray(toks[i], jnp.int32), jpos)
        tl, tc = TM.decode_step(tp, tc, torch.from_numpy(toks[i]), tpos,
                                tcfg, tctx)
        _close(tl, jl)
    # every cache leaf, recurrent state of the stacked group included
    jflat, tflat = _flat(jc), _flat(tc)
    assert sorted(jflat) == sorted(tflat)
    for path in jflat:
        _close(tflat[path], jflat[path])


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "xlstm-125m"])
def test_recurrent_prefill_cache_last_logits_match_prefill(name):
    jcfg, tcfg = _deep_cfgs(name)
    jp, tp = _params(jcfg)
    tplan = uniform_plan(tcfg, "tensor_par", set(),
                         SegmentClause(kernel="cuda"))
    prompt = torch.tensor([[3, 1, 4, 1, 5, 9, 2]])    # longer than window 4
    first, last, caches = make_prefill_cache(tcfg, tplan, device="cpu")(
        tp, TM.init_cache(tcfg, 1, 16, "cpu"), prompt)
    full = make_prefill(tcfg, tplan, device="cpu")(tp, {"tokens": prompt})
    _close(last[0], full[0, -1])
    assert int(first[0]) == int(torch.argmax(full[0, -1]))
    # the stacked group's recurrent state was written (not left at zero)
    state = caches["g0"]["b0"]
    leaf = state["h"] if name == "recurrentgemma-2b" else state["C"]
    assert all(leaf[i].abs().sum() > 0 for i in range(leaf.shape[0]))
    jplan = juniform_plan(jcfg, "tensor_par", set(), JClause(kernel="pallas"))
    jfwd, _ = jmake_prefill(jcfg, None, jplan)
    _close(full, jfwd(jp, {"tokens": jnp.asarray(prompt.numpy(),
                                                  jnp.int32)}))
