"""The port's sharding rules and mesh points held to the JAX package's.

``Rules.pspec`` (through every provider x flag subset x segment x leaf),
the cache and batch pspecs, the residual-stream pspec of the boundary
costs, ``dp_shards``, ``_batch_shard_degree``, ``combo_lower_bound``'s
collective floor and ``MeshSpec``'s keys must equal the reference's
exactly.  The reference's ``Rules`` reads only ``mesh.axis_names`` and
``mesh.devices.shape``, so a duck mesh gives both packages any shape in
this one-device process; the specs are resolved at full width from the
spec trees alone, with nothing allocated.  Pure Python, fast.
"""
from __future__ import annotations

import dataclasses
import itertools
from types import SimpleNamespace

import numpy as np
import pytest
from jax.sharding import PartitionSpec

from repro.configs import get_arch as jget_arch
from repro.configs import get_shape as jget_shape
from repro.core import cost_model as JCM
from repro.core import fusion as JF
from repro.core import meshspec as JM
from repro.core.combinator import Combination as JCombination
from repro.core.plan import build_contexts as jbuild_contexts
from repro.core.plan import dp_shards as jdp_shards
from repro.core.plan import uniform_plan as juniform_plan
from repro.core.providers import all_providers as jall_providers
from repro.core.segment import fragment as jfragment
from repro.models.model import cache_specs as jcache_specs
from repro.models.model import model_specs as jmodel_specs
from repro.models.params import param_pspecs as jparam_pspecs
from repro.serve.step import cache_axes as jcache_axes
from repro.train.step import batch_specs as jbatch_specs
from repro_torch.configs import get_arch, get_shape
from repro_torch.core import cost_model as TCM
from repro_torch.core import fusion as TF
from repro_torch.core import meshspec as TM
from repro_torch.core.combinator import Combination
from repro_torch.core.plan import build_contexts, dp_shards, uniform_plan
from repro_torch.core.providers import all_providers
from repro_torch.core.segment import fragment
from repro_torch.models.context import SegmentClause
from repro_torch.models.model import SEG_EMBED, model_specs
from repro_torch.models.params import param_pspecs
from repro_torch.runtime.sharding import placements
from repro_torch.serve.step import cache_pspecs
from repro_torch.train.step import batch_shardings

ARCHS = ("granite-8b", "qwen3-moe-30b-a3b", "recurrentgemma-2b",
         "xlstm-125m", "chatglm3-6b")
MESHES = {"1x1": (("data", 1), ("model", 1)),
          "2x2": (("data", 2), ("model", 2)),
          "4x1": (("data", 4), ("model", 1)),
          "1x4": (("data", 1), ("model", 4)),
          "2x4": (("data", 2), ("model", 4)),
          "pod2x2x2": (("pod", 2), ("data", 2), ("model", 2))}
TRAIN, DECODE = "train_4k", "decode_32k"


def _duck(axes):
    """A mesh the reference's Rules (and the port's) can resolve against:
    axis names and a devices array of the mesh's shape."""
    return SimpleNamespace(axis_names=tuple(n for n, _ in axes),
                           devices=np.empty(tuple(s for _, s in axes)))


def _flag_sets(providers):
    """provider -> every flag subset of at most 2 flags."""
    return {name: [frozenset(c) for k in range(3)
                   for c in itertools.combinations(sorted(p.flags), k)]
            for name, p in providers.items()}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


def _ref_pspec(ps):
    return tuple(ps) if isinstance(ps, PartitionSpec) else ps


def _plans(tcfg, jcfg):
    """(port plan, reference plan) for every provider x flag subset."""
    tflags, jflags = _flag_sets(all_providers()), _flag_sets(jall_providers())
    assert {k: sorted(map(sorted, v)) for k, v in tflags.items()} == \
        {k: sorted(map(sorted, v)) for k, v in jflags.items()}
    for name, subsets in sorted(tflags.items()):
        for flags in subsets:
            yield (name, flags, uniform_plan(tcfg, name, flags),
                   juniform_plan(jcfg, name, flags))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_reference(arch, mesh):
    tcfg, jcfg = get_arch(arch), jget_arch(arch)
    duck = _duck(MESHES[mesh])
    tspecs, jspecs = model_specs(tcfg), jmodel_specs(jcfg)
    n = 0
    for name, flags, tplan, jplan in _plans(tcfg, jcfg):
        tctx = build_contexts(tcfg, tplan, duck)
        jctx = jbuild_contexts(jcfg, duck, jplan)
        assert sorted(tctx) == sorted(jctx)
        for seg in tspecs:
            tp = _flat(param_pspecs(tspecs[seg], tctx[seg].rules))
            jp = _flat(jparam_pspecs(jspecs[seg], jctx[seg].rules))
            assert sorted(tp) == sorted(jp), (name, seg)
            for path in tp:
                assert tp[path] == _ref_pspec(jp[path]), \
                    (arch, mesh, name, sorted(flags), seg, path)
                n += 1
        assert tctx[SEG_EMBED].moe_groups == jctx[SEG_EMBED].moe_groups \
            == dp_shards(duck) == jdp_shards(duck)
    assert n > 0


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_pspecs_match_reference(arch, mesh):
    tcfg, jcfg = get_arch(arch), jget_arch(arch)
    duck = _duck(MESHES[mesh])
    tshape, jshape = get_shape(TRAIN), jget_shape(TRAIN)
    B, S = 8, 4096
    jcs, jax_ = jcache_specs(jcfg, B, S), jcache_axes(jcfg)
    for name, flags, tplan, jplan in _plans(tcfg, jcfg):
        jctx = jbuild_contexts(jcfg, duck, jplan)
        tcache = _flat(cache_pspecs(tcfg, B, S, tplan, duck))
        jcache = {}
        for seg, seg_axes in jax_.items():
            specs = _flat(jcs[seg])
            for path, axes in _flat(seg_axes).items():
                jcache[f"{seg}/{path}"] = _ref_pspec(
                    jctx[seg].rules.pspec(axes, specs[path].shape))
        assert tcache == jcache, (arch, mesh, name, sorted(flags))
        tb = batch_shardings(tcfg, tshape, tplan, duck)
        rules = jctx[SEG_EMBED].rules
        axes = {"tokens": ("batch", "seq"), "targets": ("batch", "seq"),
                "embeds": ("batch", "seq", "embed")}
        jb = {k: _ref_pspec(rules.pspec(axes[k], sds.shape))
              for k, sds in jbatch_specs(jcfg, jshape).items()}
        assert tb == jb, (arch, mesh, name, sorted(flags))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_boundary_and_bound_terms_match_reference(arch, mesh):
    """``_residual_pspec`` (train and decode), the batch shard degree and
    ``combo_lower_bound`` with its collective floor, on the same
    hardware constants."""
    tcfg, jcfg = get_arch(arch), jget_arch(arch)
    duck = _duck(MESHES[mesh])
    axes = dict(MESHES[mesh])
    chips = int(np.prod([s for _, s in MESHES[mesh]]))
    hw = TCM.H100
    jhw = JCM.Hardware(**dataclasses.asdict(hw))
    tflags = _flag_sets(all_providers())
    for kind in (TRAIN, DECODE):
        tshape, jshape = get_shape(kind), jget_shape(kind)
        for tseg, jseg in zip(fragment(tcfg), jfragment(jcfg)):
            for name, subsets in sorted(tflags.items()):
                for flags in subsets:
                    tc = Combination(name, flags, SegmentClause())
                    jc = JCombination(name, flags, _jclause())
                    assert TF._residual_pspec(tcfg, tshape, duck, tc, tseg) \
                        == _ref_pspec(JF._residual_pspec(jcfg, jshape, duck,
                                                         jc, jseg))
                    assert TCM._batch_shard_degree(
                        tcfg, tshape, tseg, tc, axes) == \
                        JCM._batch_shard_degree(jcfg, jshape, jseg, jc, axes)
                    assert TCM.combo_lower_bound(
                        tcfg, tshape, tseg, tc, chips, hw, mesh_axes=axes) \
                        == JCM.combo_lower_bound(
                            jcfg, jshape, jseg, jc, chips, jhw,
                            mesh_axes=axes)
        assert TF.max_boundary_cost_s(tcfg, tshape, chips, hw) == \
            JF.max_boundary_cost_s(jcfg, jshape, chips, jhw)


def _jclause():
    from repro.models.context import SegmentClause as JClause
    return JClause()


SPECS = [(), (("data", 2),), (("data", 2), ("model", 2)),
         (("pod", 2), ("data", 4), ("model", 8)), (("model", 4),)]


@pytest.mark.parametrize("kind", ["", "cpu", "cuda"])
def test_meshspec_keys_match_reference(kind):
    """``key``, ``mid``, the wire form and the coercions: byte for byte,
    so DB rows keyed by a mesh interoperate between the packages."""
    assert TM.MESH_KEY_VERSION == JM.MESH_KEY_VERSION == 2
    for axes in SPECS:
        t, j = TM.MeshSpec(axes, kind), JM.MeshSpec(axes, kind)
        assert (t.key(), t.mid, t.to_json()) == (j.key(), j.mid, j.to_json())
        assert TM.MeshSpec.from_json(j.to_json()) == t
        assert (t.n_devices, t.shape, t.axis_names, t.is_local) == \
            (j.n_devices, j.shape, j.axis_names, j.is_local)
        short = dict(axes, **({"device_kind": kind} if kind else {}))
        for m in (short, t.to_json()):
            assert TM.as_mesh_point(m).mid == JM.as_mesh_point(m).mid
        assert TM.as_mesh_point(_duck(axes) if axes else None).mid == \
            JM.as_mesh_point(_duck(axes) if axes else None).mid
    assert TM.LOCAL.mid == JM.LOCAL.mid == "local"


@pytest.mark.parametrize("n", range(1, 9))
def test_default_mesh_space_matches_reference(n):
    t, j = TM.default_mesh_space(n), JM.default_mesh_space(n)
    assert [(m.key(), m.mid) for m in t] == [(m.key(), m.mid) for m in j]


def test_default_mesh_space_counts_the_process_group():
    """Without a process group the port counts one device (the reference
    counts ``jax.device_count()``: a named departure)."""
    assert TM.default_mesh_space() == [TM.LOCAL]


def test_pspec_to_placements_table():
    from torch.distributed.tensor import Replicate, Shard
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"))
    R = Replicate()
    table = {
        (): (R, R),
        ("data",): (Shard(0), R),
        (None, "model"): (R, Shard(1)),
        ("data", None, "model"): (Shard(0), Shard(2)),
        ("model", "data"): (Shard(1), Shard(0)),
        # one dim over both axes, in the mesh's (major-to-minor) order
        (("data", "model"),): (Shard(0), Shard(0)),
        (None, ("data", "model")): (Shard(1), Shard(1)),
    }
    for ps, want in table.items():
        assert placements(mesh, ps, 3) == want, ps
    # a dim of size 1 stays whole (only axes of size 1 divide it)
    assert placements(mesh, ("data", "model"), shape=(1, 8)) == (R, Shard(1))
    pod = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert placements(pod, (("pod", "data", "model"),)) == \
        (Shard(0), Shard(0), Shard(0))
    assert placements(pod, (("pod", "data"), "model")) == \
        (Shard(0), Shard(0), Shard(1))
    # an order DTensor cannot express, an absent axis, an axis used
    # twice, a spec longer than the tensor: each raises
    for bad in ((("model", "data"),), ("pod",), ("data", "data")):
        with pytest.raises(ValueError):
            placements(mesh, bad)
    with pytest.raises(ValueError):
        placements(mesh, ("data", None, "model"), 2)
