"""The port on multi-device meshes: spawned gloo groups on the CPU.

One spawn per mesh shape, 4 ranks (2 for the launcher), ``file://``
stores under the test's temporary directory, a join timeout: a hung rank
fails its cases instead of holding the suite.  Every rank runs every case
of its spawn on the same weights (the JAX package's, converted, f32) and
the same batch, and rank 0 writes what it measured:

* the forward logits against the meshless port's (atol 2e-5 + rtol 1e-5,
  the f32 kernel floor), and the step-0 grads per leaf (relative L2 <=
  1e-4);
* the same logits and grads against the JAX package's, at the same
  bounds: the parent runs it (its plain path, meshless, at the case's
  ``moe_groups``; its output does not depend on the mesh) on the same
  weights and the same batch;
* granite at (2,2) ``tensor_par`` also takes one AdamW step (held to the
  meshless port's step and to the JAX package's) and serves a
  ``ServeEngine`` (batched == sequential == meshless); the (1,4) GQA
  layout serves too; ``machine._collective_points`` measures at 4 ranks.

The clause is ``kernel="cuda"``: the kernel ops' sharding rules run, with
the kernels' plain versions on the CPU.  The MoE cases compare at the
same ``moe_groups`` (``dp_shards`` of the mesh: 2); under
``moe_dispatch="a2a"`` each data rank's tokens are one dispatch group
whose capacity is the meshless group's, so each expert keeps the same
tokens and only the combine's order of sums differs.  The
``decode_shardmap`` case (2 kv heads on a model axis of 4: the cache is
split along its sequence) also decodes 6 positions, held to the meshless
port's and the JAX package's decode, and serves.  The count case holds
the dry run's ``OpCounter`` of one train segment on the real group to
the same count on a fake group of 4 ranks (``launch.mesh.fake_group``,
opened by rank 0 once the real group is gone): flops, bytes and every
``coll_<kind>``, exactly.

One named exception: xlstm's logits under ``tensor_par`` move by more
than the f32 floor whenever the f32 sums of its projections are reordered,
mesh or no mesh: the meshless port itself, with each contraction split in
two partial sums as the model axis splits it, moves as far (~2e-4 at
logits of ~58), and the JAX package's sums are in another order again.
That case's logits are held, against the meshless port and against the
JAX package, to twice that measured reorder sensitivity, and its grads to
the common bound.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

LOGIT_ATOL, LOGIT_RTOL = 2e-5, 1e-5
GRAD_REL_L2 = 1e-4
UPDATE_REL_L2 = 1e-4
JOIN_TIMEOUT_S = 240
#: the decode case: positions, batch and cache length (model 4 splits
#: the cache's 32 positions into blocks of 8)
DECODE_STEPS, DECODE_B, DECODE_SMAX = 6, 4, 32

GRANITE, RGEMMA, XLSTM, QWEN = ("granite-8b", "recurrentgemma-2b",
                                "xlstm-125m", "qwen3-moe-30b-a3b")

#: mesh shape -> cases (name, arch, provider, flags, extras)
SPAWNS = {
    (2, 2): [("granite_tp_2x2", GRANITE, "tensor_par", (),
              ("adamw", "engine", "collectives")),
             ("granite_hybrid2d_2x2", GRANITE, "hybrid2d", (), ()),
             ("recurrentgemma_tp_2x2", RGEMMA, "tensor_par", (), ()),
             ("xlstm_tp_2x2", XLSTM, "tensor_par", (), ("reorder",)),
             ("qwen3_moe_expert_par_2x2", QWEN, "expert_par", (), ()),
             ("qwen3_moe_a2a_2x2", QWEN, "expert_par", (), ("a2a",)),
             ("granite_dryrun_count_2x2", GRANITE, "tensor_par", (),
              ("count",))],
    (1, 4): [("granite_tp_1x4_gqa", GRANITE, "tensor_par", (), ("engine",)),
             ("granite_tp_1x4_decode_shardmap", GRANITE, "tensor_par", (),
              ("decode_shardmap", "engine"))],
    (4, 1): [("granite_fsdp_both_4x1", GRANITE, "fsdp",
              ("shard_both_axes",), ())],
}
CASES = [(shape, c[0]) for shape, cs in SPAWNS.items() for c in cs]
BATCH_SEED = 7


def _tokens(rng, cfg, shape):
    """The case's token batch: the same on every rank and in the parent."""
    return rng.integers(0, cfg.vocab_size, (shape.global_batch,
                                            shape.seq_len))


# --- rank side (imports torch and the port only) ---------------------------------

def _load(path):
    from repro_torch.models.convert import params_from_numpy
    tree = {}
    with np.load(path) as z:
        for k in z.files:
            node = tree
            *head, leaf = k.split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[leaf] = z[k]
    return params_from_numpy(tree, "cpu")


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _paths(tree):
    from repro_torch.models.params import tree_map_with_path
    out = []
    tree_map_with_path(lambda p, t: out.append("/".join(p)), tree)
    return out


def _against_reference(ref, logits, grads, paths):
    """The meshed port's gathered logits and grads against the JAX
    package's on the same batch."""
    want = torch.from_numpy(ref["logits"])
    return {"ref_logit_max_abs": float((logits - want).abs().max()),
            "ref_logit_close": bool(torch.allclose(
                logits, want, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)),
            "ref_grad_rel_l2": max(
                _rel(g, torch.from_numpy(ref["grad/" + p]))
                for p, g in zip(paths, grads))}


def _case(case, mesh, wdir):
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.core.plan import build_contexts, dp_shards, uniform_plan
    from repro_torch.models.context import SegmentClause
    from repro_torch.models.loss import softmax_xent
    from repro_torch.models.model import forward
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.runtime.sharding import full
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train.step import (AUX_LOSS_WEIGHT, init_train_state,
                                        make_train_step, place_batch)
    name, arch, provider, flags, extras = case
    cfg = get_arch(arch).smoke()
    plan = uniform_plan(cfg, provider, frozenset(flags), _clause(extras))
    if "count" in extras:
        return {"real": _dry_count(cfg, plan, mesh)}
    shape = get_shape("train_4k").smoke()
    rng = np.random.default_rng(BATCH_SEED)
    toks = torch.from_numpy(_tokens(rng, cfg, shape))
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
    p0 = _load(os.path.join(wdir, f"{arch}.npz"))
    ref = dict(np.load(os.path.join(wdir, f"{name}.ref.npz")))

    def clone(tree):
        return tree_map(lambda t: t.detach().clone().requires_grad_(), tree)

    def loss_grads(params, ctxs, b):
        logits, aux = forward(params, b, cfg, ctxs)
        loss = softmax_xent(logits, b["targets"])[0] + AUX_LOSS_WEIGHT * aux
        return logits, torch.autograd.grad(loss, tree_leaves(params))

    from repro_torch.runtime.sharding import mesh_scope
    plain = clone(p0)
    ctx0 = {k: c.with_(moe_groups=dp_shards(mesh))
            for k, c in build_contexts(cfg, plan).items()}
    logits0, g0 = loss_grads(plain, ctx0, batch)
    params, opt = init_train_state(cfg, plan, None, "cpu", mesh=mesh,
                                   params=clone(p0))
    placed = place_batch(batch, cfg, plan, mesh)
    with mesh_scope(True):
        logits1, g1 = loss_grads(params, build_contexts(cfg, plan, mesh),
                                 placed)
    logits1 = full(logits1).detach()
    g1 = [full(g) for g in g1]
    if "reorder" in extras:
        out_sens = _reorder_sensitivity(cfg, plain, ctx0, batch, logits0,
                                        mesh.size(1))
    out = {"logit_max_abs": float((logits1 - logits0).abs().max()),
           "logit_close": bool(torch.allclose(
               logits1, logits0.detach(), atol=LOGIT_ATOL, rtol=LOGIT_RTOL)),
           "grad_rel_l2": max(_rel(b, a) for a, b in zip(g0, g1)),
           "n_leaves": len(g0),
           "placements": sorted({str(tuple(t.placements))
                                 for t in tree_leaves(params)}),
           **_against_reference(ref, logits1, g1, _paths(p0))}
    if "reorder" in extras:
        out["reorder_sensitivity"] = out_sens
    if "adamw" in extras:
        step0 = make_train_step(cfg, plan, device="cpu", warmup=0)
        step1 = make_train_step(cfg, plan, device="cpu", mesh=mesh, warmup=0)
        q0, o0 = init_train_state(cfg, plan, None, "cpu", params=clone(p0))
        before = [t.detach().clone() for t in tree_leaves(q0)]
        q0, o0, m0 = step0(q0, o0, batch)
        q1, o1, m1 = step1(params, opt, placed)
        out["loss"] = [float(m0["total_loss"]), float(m1["total_loss"])]
        out["update_rel_l2"] = max(
            _rel(full(b).detach() - p, a.detach() - p)
            for a, b, p in zip(tree_leaves(q0), tree_leaves(q1), before)
            if float((a.detach() - p).norm()) > 0)
        out["ref_loss"] = float(ref["loss"])
        out["ref_update_rel_l2"] = max(
            _rel(full(b).detach() - p, torch.from_numpy(ref["update/" + k]))
            for k, b, p in zip(_paths(p0), tree_leaves(q1), before)
            if float(np.abs(ref["update/" + k]).max()) > 0)
        out["opt_step"] = [o0.step, o1.step]
    if "engine" in extras:
        reqs = [dict(rid=f"r{i}", prompt=tuple(int(x) for x in rng.integers(
            1, cfg.vocab_size, 3 + i)), max_new_tokens=4) for i in range(5)]
        e0 = ServeEngine(cfg, plan, capacity=4, cache_len=32,
                         params=clone(p0), device="cpu")
        e1 = ServeEngine(cfg, plan, capacity=4, cache_len=32,
                         params=clone(p0), device="cpu", mesh=mesh)
        r0, r1 = e0.run(reqs), e1.run(reqs)
        r2 = e1.run(reqs, max_active=1)
        out["engine_batched_eq_sequential"] = all(
            r1[k].tokens == r2[k].tokens for k in r1)
        out["engine_eq_meshless"] = all(
            r1[k].tokens == r0[k].tokens for k in r0)
    if "decode_shardmap" in extras:
        out.update(_shardmap_decode(cfg, plan, p0, mesh, ref, clone))
    if "collectives" in extras:
        from repro_torch.core.machine import _collective_points
        pts = _collective_points(1 << 16, 2, torch.device("cpu"))
        out["collectives"] = {k: v["bytes_s"] for k, v in pts.items()}
    return out


def _clause(extras):
    from repro_torch.models.context import SegmentClause
    return SegmentClause(kernel="cuda",
                         moe_dispatch="a2a" if "a2a" in extras else "sorted",
                         decode_shardmap="decode_shardmap" in extras)


def _decode_inputs(cfg):
    """The decode case's batch: (B,) tokens for each of DECODE_STEPS
    positions, the same on every rank and in the parent."""
    rng = np.random.default_rng(BATCH_SEED + 1)
    return rng.integers(0, cfg.vocab_size, (DECODE_STEPS, DECODE_B))


def _shardmap_decode(cfg, plan, p0, mesh, ref, clone):
    """DECODE_STEPS positions of ``decode_step`` on the mesh (the sharded
    decode) against the meshless port's and the JAX package's logits; the
    gathered caches against the meshless port's."""
    from repro_torch.core.plan import build_contexts, segment_rules
    from repro_torch.models.model import decode_step, init_cache, model_specs
    from repro_torch.models.params import place_params, tree_leaves
    from repro_torch.runtime.sharding import full, mesh_scope
    from repro_torch.serve.step import place_caches
    toks = torch.from_numpy(_decode_inputs(cfg))
    c0 = init_cache(cfg, DECODE_B, DECODE_SMAX, "cpu")
    c1 = place_caches(init_cache(cfg, DECODE_B, DECODE_SMAX, "cpu"), cfg,
                      plan, mesh)
    ctx0, ctx1 = build_contexts(cfg, plan), build_contexts(cfg, plan, mesh)
    p1 = place_params(clone(p0), model_specs(cfg),
                      segment_rules(cfg, plan, mesh))
    want = torch.from_numpy(ref["decode_logits"])
    worst, worst_ref, ok = 0.0, 0.0, True
    with torch.no_grad():
        for pos in range(DECODE_STEPS):
            l0, c0 = decode_step(p0, c0, toks[pos], pos, cfg, ctx0)
            with mesh_scope(True):
                l1, c1 = decode_step(p1, c1, toks[pos], pos, cfg, ctx1)
            l1 = full(l1)
            worst = max(worst, float((l1 - l0).abs().max()))
            worst_ref = max(worst_ref, float((l1 - want[pos]).abs().max()))
            ok &= bool(torch.allclose(l1, l0, atol=LOGIT_ATOL,
                                      rtol=LOGIT_RTOL)) and bool(
                torch.allclose(l1, want[pos], atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL))
    caches_close = all(
        bool(torch.allclose(full(b), a, atol=LOGIT_ATOL, rtol=LOGIT_RTOL))
        for a, b in zip(tree_leaves(c0), tree_leaves(c1)))
    seq_split = sorted({str(tuple(t.placements)) for t in tree_leaves(c1)})
    return {"decode_max_abs": worst, "decode_ref_max_abs": worst_ref,
            "decode_close": ok, "decode_caches_close": caches_close,
            "cache_placements": seq_split}


def _dry_count(cfg, plan, mesh):
    """The dry run's count of the first stack segment's train program on
    ``mesh``: flops, bytes and collective bytes by kind."""
    from repro_torch.configs import get_shape
    from repro_torch.core.executor import DryRunExecutor
    from repro_torch.core.segment import fragment
    seg = next(s for s in fragment(cfg) if s.kind == "stack")
    combo = plan.segments[seg.name]
    counter = DryRunExecutor().count(cfg, get_shape("train_4k").smoke(),
                                     seg, combo, mesh=mesh)
    return counter.analysis()


def _reorder_sensitivity(cfg, params, ctxs, batch, logits, parts):
    """How far the meshless port's logits move when every dense
    contraction is summed in ``parts`` partial sums (the order a model
    axis of that size gives them): its f32 rounding floor."""
    import repro_torch.models.layers as L
    from repro_torch.models.model import forward
    mods = [m for m in list(sys.modules.values())
            if getattr(m, "dense", None) is L.dense
            and getattr(m, "__name__", "").startswith("repro_torch.models")]
    orig = L.dense

    def split(x, w):
        w = w.to(x.dtype)
        ks = torch.tensor_split(torch.arange(x.shape[-1]), parts)
        return sum(torch.tensordot(x[..., k], w[k], dims=([x.ndim - 1], [0]))
                   for k in ks)
    try:
        for m in mods:
            m.dense = split
        with torch.no_grad():
            moved, _ = forward(params, batch, cfg, ctxs)
    finally:
        for m in mods:
            m.dense = orig
    return float((moved - logits.detach()).abs().max())


def _rank_main(rank, world, store, shape, cases, wdir, out_path):
    import logging
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import destroy_group, device_mesh, init_group
    init_group("cpu", rank, world, store, timeout_s=JOIN_TIMEOUT_S / 2)
    mesh = device_mesh(shape, ("data", "model"), "cpu")
    results = {}
    for case in cases:
        try:
            results[case[0]] = _case(case, mesh, wdir)
        except Exception as e:       # recorded; the other ranks carry on
            results[case[0]] = {"error": f"{type(e).__name__}: {e}"}
    destroy_group()
    if rank == 0:
        for case in cases:
            if "count" in case[4] and "error" not in results[case[0]]:
                results[case[0]]["fake"] = _fake_count(case, shape)
        with open(out_path, "w") as f:
            json.dump(results, f)


def _fake_count(case, shape):
    """The count case on a fake group of 4 ranks (this process's real
    group destroyed first: a process holds one default group)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.plan import uniform_plan
    from repro_torch.launch.mesh import device_mesh, fake_group
    name, arch, provider, flags, extras = case
    cfg = get_arch(arch).smoke()
    plan = uniform_plan(cfg, provider, frozenset(flags), _clause(extras))
    try:
        with fake_group(4):
            return _dry_count(cfg, plan, device_mesh(
                shape, ("data", "model"), "cpu"))
    except Exception as e:
        return {"error": f"{type(e).__name__}: {e}"}


# --- parent side ----------------------------------------------------------------

def _flat_jax(tree):
    import jax
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _weights(wdir, shape):
    """The JAX package's smoke weights of every arch the spawn's cases
    use, as flattened numpy archives the ranks load; and, per case, the
    JAX package's logits and step-0 grads on the case's batch (and the
    update of one AdamW step where the case takes one), meshless, at the
    case's ``moe_groups``."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch as jget_arch
    from repro.configs import get_shape as jget_shape
    from repro.core.plan import build_contexts as jbuild_contexts
    from repro.core.plan import uniform_plan as juniform_plan
    from repro.models.context import SegmentClause as JClause
    from repro.models.loss import softmax_xent as jxent
    from repro.models.model import forward as jforward
    from repro.optim import adamw as JA
    from repro.train.step import AUX_LOSS_WEIGHT as JAUX
    from repro.train.step import make_train_step as jmake_train_step
    from test_torch_model import _params
    groups = shape[0]                   # dp_shards of a (data, model) mesh
    for name, arch, provider, flags, extras in SPAWNS[shape]:
        path = os.path.join(wdir, f"{name}.ref.npz")
        if os.path.exists(path) or "count" in extras:
            continue
        jcfg = jget_arch(arch).smoke()
        jp, _ = _params(jcfg)
        wpath = os.path.join(wdir, f"{arch}.npz")
        if not os.path.exists(wpath):
            np.savez(wpath, **_flat_jax(jp))
        jplan = juniform_plan(jcfg, provider, frozenset(flags),
                              JClause(kernel="xla"))
        ctxs = {k: dataclasses.replace(c, moe_groups=groups) for k, c in
                jbuild_contexts(jcfg, None, jplan).items()}
        toks = _tokens(np.random.default_rng(BATCH_SEED), jcfg,
                       jget_shape("train_4k").smoke())
        batch = {"tokens": jnp.asarray(toks, jnp.int32),
                 "targets": jnp.asarray(np.roll(toks, -1, 1), jnp.int32)}

        def loss_fn(params):
            logits, aux = jforward(params, batch, jcfg, ctxs)
            return jxent(logits, batch["targets"])[0] + JAUX * aux, logits
        (loss, logits), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(jp)
        out = {"logits": np.asarray(logits, np.float32),
               "loss": np.asarray(loss, np.float32)}
        out.update({"grad/" + k: v for k, v in _flat_jax(grads).items()})
        if "decode_shardmap" in extras:
            from repro.models.model import decode_step as jdecode_step
            from repro.models.model import init_cache as jinit_cache
            jc = jinit_cache(jcfg, DECODE_B, DECODE_SMAX)
            dtoks = _decode_inputs(jcfg)
            step = jax.jit(lambda p, c, t, i: jdecode_step(p, c, t, i, jcfg,
                                                           ctxs))
            logits = []
            for i in range(DECODE_STEPS):
                li, jc = step(jp, jc, jnp.asarray(dtoks[i], jnp.int32),
                              jnp.int32(i))
                logits.append(np.asarray(li, np.float32))
            out["decode_logits"] = np.stack(logits)
        if "adamw" in extras:
            step, _ = jmake_train_step(jcfg, None, jplan, warmup=0)
            jp1, _, m = jax.jit(step)(jp, JA.adamw_init(jp), batch)
            before = _flat_jax(jp)
            out["loss"] = np.asarray(m["total_loss"], np.float32)
            out.update({"update/" + k: v - before[k]
                        for k, v in _flat_jax(jp1).items()})
        np.savez(path, **out)


def _spawn(fn, args, nprocs, deadline_s):
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    end = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > end:
                raise TimeoutError(f"ranks still running after "
                                   f"{deadline_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


_RESULTS = {}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    def get(shape):
        if shape not in _RESULTS:
            d = tmp_path_factory.mktemp(f"mesh{shape[0]}x{shape[1]}")
            wdir = str(tmp_path_factory.getbasetemp() / "weights")
            os.makedirs(wdir, exist_ok=True)
            _weights(wdir, shape)
            out = str(d / "results.json")
            try:
                _spawn(_rank_main, (4, str(d / "store"), shape, SPAWNS[shape],
                                    wdir, out), 4, JOIN_TIMEOUT_S)
                with open(out) as f:
                    _RESULTS[shape] = json.load(f)
            except Exception as e:
                _RESULTS[shape] = {"spawn_error": f"{type(e).__name__}: {e}"}
        return _RESULTS[shape]
    return get


@pytest.mark.parametrize("shape,name", CASES,
                         ids=[n for _, n in CASES])
def test_meshed_port_matches_meshless(spawned, shape, name):
    res = spawned(shape)
    assert "spawn_error" not in res, res
    r = res[name]
    assert "error" not in r, r["error"]
    if "real" in r:
        # the dry run's count on the real group == on a fake group
        assert "error" not in r["fake"], r["fake"]
        assert r["real"] == r["fake"], r
        assert r["real"]["flops"] > 0 and r["real"]["collective"] > 0
        return
    # the meshless port, then the JAX package, on the same weights and batch
    if "reorder_sensitivity" in r:
        assert r["logit_max_abs"] <= 2 * r["reorder_sensitivity"], r
        assert r["ref_logit_max_abs"] <= 2 * r["reorder_sensitivity"], r
    else:
        assert r["logit_close"], r
        assert r["ref_logit_close"], r
    assert r["grad_rel_l2"] <= GRAD_REL_L2, r
    assert r["ref_grad_rel_l2"] <= GRAD_REL_L2, r
    if "loss" in r:
        assert r["loss"][0] == pytest.approx(r["loss"][1], rel=1e-6)
        assert r["loss"][1] == pytest.approx(r["ref_loss"], rel=1e-5)
        assert r["update_rel_l2"] <= UPDATE_REL_L2, r
        assert r["ref_update_rel_l2"] <= UPDATE_REL_L2, r
        assert r["opt_step"] == [1, 1]
    if "engine_batched_eq_sequential" in r:
        assert r["engine_batched_eq_sequential"], r
        assert r["engine_eq_meshless"], r
    if "decode_close" in r:
        assert r["decode_close"], r
        assert r["decode_caches_close"], r
        # the cache is split along its sequence (dim 2 of a stacked leaf)
        assert any("Shard(dim=1)" in p or "Shard(dim=2)" in p
                   for p in r["cache_placements"]), r
    if "collectives" in r:
        assert sorted(k.split(":")[0] for k in r["collectives"]) == \
            ["all_gather", "all_reduce"]
        assert all(v > 0 for v in r["collectives"].values())


def test_layouts_are_sharded(spawned):
    """The cases do shard: tensor_par splits heads on ``model``, fsdp's
    ``shard_both_axes`` one dim over both axes, and the GQA layout keeps
    kv heads whole where the model axis does not divide them."""
    tp = spawned((2, 2))["granite_tp_2x2"]["placements"]
    assert "(Replicate(), Shard(dim=2))" in tp
    fs = spawned((4, 1))["granite_fsdp_both_4x1"]["placements"]
    assert "(Shard(dim=0), Shard(dim=0))" in fs or \
        "(Shard(dim=1), Shard(dim=1))" in fs
    gqa = spawned((1, 4))["granite_tp_1x4_gqa"]["placements"]
    assert "(Replicate(), Shard(dim=2))" in gqa     # q heads 4 / 4
    assert "(Replicate(), Replicate())" in gqa      # kv heads 2: whole


def test_launch_train_on_a_two_rank_group(tmp_path):
    """``launch/train.py`` under ``torch.distributed.run`` with 2 ranks:
    a (2, 1) data mesh, the same losses on both ranks, one checkpoint."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--standalone", "--nproc-per-node", "2",
           "-m", "repro_torch.launch.train", "--arch", "granite-8b",
           "--smoke", "--device", "cpu", "--steps", "2", "--log-every", "1",
           "--ckpt-dir", str(tmp_path / "ckpt")]
    p = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=JOIN_TIMEOUT_S)
    assert p.returncode == 0, p.stderr[-3000:]
    # both ranks print; their lines may interleave
    steps = sorted(re.findall(r"\[train\] step\s+(\d+) loss=(\S+)", p.stdout))
    assert [st for st, _ in steps] == ["0", "0", "1", "1"], p.stdout
    assert steps[0] == steps[1] and steps[2] == steps[3]
    assert "mesh={'data': 2, 'model': 1}" in p.stdout
    assert os.listdir(tmp_path / "ckpt") == ["step_00000002"]
