"""The port's mesh-only clauses on a (1, 1) mesh (a world-size-1 gloo
group), each held to the JAX package's function on the same weights, as
``tests/test_optimizations.py`` holds the reference's: the all-to-all MoE
dispatch (``moe_dispatch="a2a"``) against the sorted one, its gradients,
and the sequence-sharded decode (``decode_shardmap``) against the ordinary
decode.  f32 throughout; weights and inputs drawn with numpy."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch.mesh import make_test_mesh as jmake_test_mesh
from repro.models import attention as JA
from repro.models import moe as JMOE
from repro.models.context import ModelContext as JCtx
from repro.models.context import SegmentClause as JClause
from repro.runtime.sharding import Rules as JRules
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import destroy_group, make_test_mesh
from repro_torch.models import attention as TA
from repro_torch.models import moe as TMOE
from repro_torch.models.context import ModelContext, SegmentClause
from repro_torch.runtime.sharding import Rules, full, mesh_scope

F32_ATOL, F32_RTOL = 2e-5, 1e-5
GRAD_REL_L2 = 1e-4
MOE_RULES = {"batch": "data", "experts": "model"}
SEQ_RULES = {"batch": "data", "kv_seq": "model", "kv_heads": None}


@pytest.fixture(scope="module")
def meshes():
    """The port's (1, 1) mesh and the reference's."""
    destroy_group()
    mesh = make_test_mesh(1, 1, "cpu")
    yield mesh, jmake_test_mesh(1, 1)
    destroy_group()


def _f32(name):
    return (dataclasses.replace(jget_arch(name).smoke(), dtype="float32"),
            dataclasses.replace(get_arch(name).smoke(), dtype="float32"))


def _weights(specs, seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s.shape) * s.scale).astype(np.float32)
            for k, s in specs.items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _moe(p, x, cfg, mesh, dispatch):
    ctx = ModelContext(rules=Rules(MOE_RULES, mesh),
                       clause=SegmentClause(moe_dispatch=dispatch))
    with mesh_scope(True):
        y, aux = TMOE.moe_apply(p, x, cfg, ctx)
        return full(y), full(aux)


def test_a2a_moe_matches_sorted_and_reference(meshes):
    mesh, jmesh = meshes
    jcfg, cfg = _f32("qwen3-moe-30b-a3b")
    w = _weights(TMOE.moe_specs(cfg), 0)
    x = (np.random.default_rng(1).standard_normal((2, 16, cfg.d_model))
         * 0.5).astype(np.float32)
    p = {k: torch.from_numpy(v) for k, v in w.items()}
    y1, a1 = _moe(p, torch.from_numpy(x), cfg, mesh, "sorted")
    y2, a2 = _moe(p, torch.from_numpy(x), cfg, mesh, "a2a")
    # the same token -> expert choices and kept slots: equal up to the
    # order of the f32 sums
    torch.testing.assert_close(y2, y1, atol=F32_ATOL, rtol=F32_RTOL)
    assert float(a2) == pytest.approx(float(a1), rel=1e-5)
    jy, ja = JMOE.moe_apply(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x), jcfg,
        JCtx(rules=JRules(MOE_RULES, jmesh),
             clause=JClause(moe_dispatch="a2a")))
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy), atol=F32_ATOL,
                               rtol=F32_RTOL)
    assert float(a2) == pytest.approx(float(ja), rel=1e-5)


def test_a2a_moe_grads_match_reference(meshes):
    mesh, jmesh = meshes
    jcfg, cfg = _f32("qwen3-moe-30b-a3b")
    w = _weights(TMOE.moe_specs(cfg), 0)
    x = (np.random.default_rng(1).standard_normal((1, 8, cfg.d_model))
         * 0.5).astype(np.float32)
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in w.items()}
    y, aux = _moe(p, torch.from_numpy(x), cfg, mesh, "a2a")
    g = dict(zip(p, torch.autograd.grad(y.sum() + aux, list(p.values()))))
    jctx = JCtx(rules=JRules(MOE_RULES, jmesh),
                clause=JClause(moe_dispatch="a2a"))

    def loss(jp):
        jy, ja = JMOE.moe_apply(jp, jnp.asarray(x), jcfg, jctx)
        return jy.sum() + ja
    jg = jax.grad(loss)({k: jnp.asarray(v) for k, v in w.items()})
    for k, t in g.items():
        assert torch.isfinite(t).all(), k
        assert float(t.abs().max()) > 0, k
        assert _rel(t.numpy(), jg[k]) <= GRAD_REL_L2, k
    # and the meshless (sorted) gradient, the true derivative
    q = {k: torch.from_numpy(v).requires_grad_() for k, v in w.items()}
    y0, a0 = TMOE.moe_apply(q, torch.from_numpy(x), cfg, ModelContext())
    g0 = torch.autograd.grad(y0.sum() + a0, list(q.values()))
    for (k, t), t0 in zip(g.items(), g0):
        assert _rel(t.numpy(), t0.numpy()) <= GRAD_REL_L2, k


def test_shardmap_decode_matches_ordinary_and_reference(meshes):
    mesh, jmesh = meshes
    jcfg, cfg = _f32("granite-8b")
    w = _weights(TA.attn_specs(cfg), 0)
    B, S = 2, 32
    KV, D = cfg.num_kv_heads, cfg.head_dim_
    x = (np.random.default_rng(1).standard_normal((B, cfg.d_model))
         * 0.3).astype(np.float32)
    p = {k: torch.from_numpy(v) for k, v in w.items()}
    rules = Rules(SEQ_RULES, mesh)
    axes = ("batch", "kv_seq", "kv_heads", None)

    def caches():
        return {n: rules.distribute(torch.zeros(B, S, KV, D), axes)
                for n in ("k", "v")}
    ctx0 = ModelContext(rules=rules, clause=SegmentClause())
    ctx1 = ModelContext(rules=rules,
                        clause=SegmentClause(decode_shardmap=True))
    assert TA._seq_sharded(ctx1, caches())
    jctx = JCtx(rules=JRules(SEQ_RULES, jmesh),
                clause=JClause(decode_shardmap=True))
    jp = {k: jnp.asarray(v) for k, v in w.items()}
    c0, c1 = caches(), caches()
    jc = {n: jnp.zeros((B, S, KV, D)) for n in ("k", "v")}
    xt = torch.from_numpy(x)
    for pos in range(6):
        with mesh_scope(True):
            y0, c0 = TA.attn_decode(p, xt, c0, pos, cfg, ctx0)
            y1, c1 = TA.attn_decode(p, xt, c1, pos, cfg, ctx1)
        jy, jc = JA.attn_decode(jp, jnp.asarray(x), jc, jnp.int32(pos),
                                jcfg, jctx)
        torch.testing.assert_close(full(y1), full(y0), atol=F32_ATOL,
                                   rtol=F32_RTOL)
        np.testing.assert_allclose(full(y1).numpy(), np.asarray(jy),
                                   atol=F32_ATOL, rtol=F32_RTOL)
        for n in ("k", "v"):
            assert torch.equal(full(c1[n]), full(c0[n]))
            # the reference's RoPE rounds its last bit differently
            np.testing.assert_allclose(full(c1[n]).numpy(),
                                       np.asarray(jc[n]), atol=F32_ATOL,
                                       rtol=F32_RTOL)
