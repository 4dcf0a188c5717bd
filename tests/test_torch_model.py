"""The port's model on the CPU against the JAX package, on the same weights.

Reference parameters are made by ``repro.models.params.init_params``,
carried through numpy into the port by ``params_from_numpy``, and both
packages run the same seeded tokens.  Tolerances: 2e-4 on f32 logits
(XLA and PyTorch sum matrix products in different orders); 5e-2 on bf16
logits (one bf16 ulp of the residual stream is 2^-8 relative).
"""
import dataclasses

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
from repro.models.params import init_params as jinit_params
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
    jp = jinit_params(JM.model_specs(jcfg), jax.random.key(seed))
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


@pytest.mark.parametrize("name", ["granite-8b", "stablelm-3b"])
def test_param_tree_matches_reference(name):
    jcfg, tcfg = _cfgs(name, "bfloat16")
    jp, tp = _params(jcfg)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    seen = _flat(tp)
    assert sorted(seen) == sorted(flat)
    for path, t in seen.items():
        assert tuple(t.shape) == flat[path].shape, path
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(tensor_to_numpy(t),
                                      np.asarray(flat[path], np.float32))
    # the port's own init gives the same tree of shapes and dtypes
    own = _flat(init_params(TM.model_specs(tcfg),
                            torch.Generator().manual_seed(0), "cpu"))
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in seen.items()}


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
])
def test_forward_logits_match_reference(name, dtype, kernel):
    jcfg, tcfg = _cfgs(name, dtype)
    jp, tp = _params(jcfg)
    jctx, tctx = _ctxs(jcfg, tcfg, kernel)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 16))
    jl, _ = JM.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jcfg,
                       jctx)
    tl, aux = TM.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg, tctx)
    assert tl.dtype == torch.float32 and tl.shape == (2, 16, jcfg.vocab_size)
    assert float(aux) == 0.0
    _close(tl, jl, dtype)


# --- decode -----------------------------------------------------------------

@pytest.mark.parametrize("name,kernel", [("granite-8b", "cuda"),
                                         ("stablelm-3b", "plain")])
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
