"""The port's plan registry (``serve/registry.py``), the tuner's
``registry=``, ``launch/serve.py --registry-db`` and
``examples/serve_batched.py`` against the JAX package, on the CPU.

Exact: a registered plan round-trips byte for byte, and the same
registrations in both packages' registries give the same exact, nearest
and miss lookups (the entry's shape, exactness and tag) over a grid of
serving shapes.  The CLIs run with ``--device cpu``.
"""
import itertools
import json

import pytest
from repro.core.meshspec import MeshSpec as JMeshSpec

from repro.configs import get_arch as jget_arch
from repro.core.db import SweepDB as JSweepDB
from repro.core.plan import uniform_plan as juniform_plan
from repro.models.context import SegmentClause as JClause
from repro.serve.registry import PlanRegistry as JRegistry
from repro.serve.registry import serving_shape as jserving_shape
from repro_torch.configs import get_arch
from repro_torch.core.db import SweepDB
from repro_torch.core.plan import Plan, uniform_plan
from repro_torch.core.tuner import ComParTuner
from repro_torch.examples import serve_batched
from repro_torch.launch.serve import resolve_plan, serve
from repro_torch.models.context import SegmentClause
from repro_torch.serve import PlanRegistry, serving_shape

ARCH = "stablelm-3b"


def _plan(cfg, **clause):
    return uniform_plan(cfg, "tensor_par", {"shard_vocab"},
                        SegmentClause(**clause))


def test_registry_roundtrip_byte_identical_plan(tmp_path):
    cfg = get_arch(ARCH).smoke()
    plan = _plan(cfg, kernel="cuda")
    plan.meta["predicted_total_s"] = 1.25e-4
    reg = PlanRegistry(str(tmp_path / "reg.db"))
    shape = serving_shape(4, 64)
    assert shape == serving_shape(4, 64) and shape.kind == "decode"
    assert (shape.name, shape.seq_len, shape.global_batch) == \
        (jserving_shape(4, 64).name, 64, 4)
    reg.register(cfg, shape, plan, report={"note": "t"}, cache_tag="dry")
    e = reg.lookup(cfg, shape, cache_tag="dry")
    assert e is not None and e.exact and e.mesh_mid == "local"
    assert json.dumps(e.plan.to_json(), sort_keys=True) == \
        json.dumps(plan.to_json(), sort_keys=True)
    assert e.total_s == pytest.approx(1.25e-4) and e.report == {"note": "t"}
    assert e.kind == "decode" and (e.seq_len, e.batch) == (64, 4)
    assert e.describe().startswith(f"{cfg.name} decode:64x4 mesh=local")
    # re-registering the key replaces the plan (newest wins)
    reg.register(cfg, shape, _plan(cfg), cache_tag="dry")
    assert reg.lookup(cfg, shape).plan.to_json() == _plan(cfg).to_json()
    assert len(reg.entries(cfg.name)) == 1
    # the registry shares its file with the score cache
    assert PlanRegistry(SweepDB(str(tmp_path / "reg.db"))).lookup(
        cfg, shape) is not None
    # a plan is keyed by its mesh: another mesh is a miss, never a
    # fallback, and a plan registered for a mesh is found under it
    assert reg.lookup(cfg, shape, {"data": 2}) is None
    reg.register(cfg, shape, _plan(cfg), mesh={"data": 2}, cache_tag="dry")
    e2 = reg.lookup(cfg, shape, {"data": 2})
    assert e2.mesh_mid == JMeshSpec.of(data=2).mid != "local"


def test_lookups_match_reference(tmp_path):
    tcfg, jcfg = get_arch(ARCH).smoke(), jget_arch(ARCH).smoke()
    treg = PlanRegistry(str(tmp_path / "t.db"))
    jreg = JRegistry(JSweepDB(str(tmp_path / "j.db")))
    regs = [(4, 64, "dry"), (4, 256, "dry"), (8, 32, "wall"), (2, 128, "dry"),
            (16, 512, "wall"), (1, 64, "wall")]
    for batch, cache, tag in regs:
        treg.register(tcfg, serving_shape(batch, cache), _plan(tcfg),
                      cache_tag=tag)
        jreg.register(jcfg, jserving_shape(batch, cache),
                      juniform_plan(jcfg, "tensor_par", {"shard_vocab"},
                                    JClause(kernel="xla")), cache_tag=tag)
    n_exact = n_near = n_miss = 0
    for batch, cache in itertools.product((1, 3, 4, 8, 64), (16, 64, 96,
                                                             300, 4096)):
        for tag in (None, "dry", "wall", "other"):
            for nearest in (True, False):
                t = treg.lookup(tcfg, serving_shape(batch, cache),
                                cache_tag=tag, nearest=nearest)
                j = jreg.lookup(jcfg, jserving_shape(batch, cache),
                                cache_tag=tag, nearest=nearest)
                got = None if t is None else (t.shape, t.exact, t.cache_tag)
                want = None if j is None else (j.shape, j.exact, j.cache_tag)
                assert got == want, (batch, cache, tag, nearest)
                n_miss += got is None
                n_exact += bool(got and got[1])
                n_near += bool(got and not got[1])
    assert n_exact and n_near and n_miss
    # another arch is a miss, nearest or not
    assert treg.lookup(get_arch("granite-8b").smoke(),
                       serving_shape(4, 64)) is None


SPACE = {"remat": ("none",), "kernel": ("plain",),
         "cache_upcast": (True, False)}


def test_tuner_registers_the_fused_plan(tmp_path):
    cfg = get_arch(ARCH).smoke()
    shape = serving_shape(2, 32)
    db = SweepDB(str(tmp_path / "sweep.db"))
    with ComParTuner(cfg, shape, device="cpu", db=db, project="r",
                     registry=True) as tuner:
        plan, rep = tuner.sweep(providers=("tensor_par",),
                                clause_space=SPACE, max_flags=0,
                                backend="sequential")
    e = tuner.registry.lookup(cfg, shape, cache_tag=tuner.executor.cache_tag)
    assert e is not None and e.exact
    assert json.dumps(e.plan.to_json(), sort_keys=True) == \
        json.dumps(plan.to_json(), sort_keys=True)
    assert e.total_s == pytest.approx(plan.meta["predicted_total_s"])
    assert "summary" in e.report
    # a path, or any object with register/lookup, works as well
    path = str(tmp_path / "other.db")
    ComParTuner(cfg, shape, device="cpu", registry=path).sweep(
        providers=("fsdp",), clause_space=SPACE, max_flags=0)
    assert PlanRegistry(path).lookup(cfg, shape).exact
    seen = []

    class Spy:
        def register(self, *a, **kw):
            seen.append(kw["cache_tag"])

        def lookup(self, *a, **kw):
            return None
    ComParTuner(cfg, shape, device="cpu", registry=Spy()).sweep(
        providers=("fsdp",), clause_space=SPACE, max_flags=0)
    assert seen == ["dryrun:h100-sxm"]
    assert ComParTuner(cfg, shape, device="cpu", registry=False).registry \
        is None


def test_registry_cli_and_serve_from_it(tmp_path, capsys):
    from repro_torch.serve.registry import main
    path = str(tmp_path / "reg.db")
    argv = ["--db", path, "--arch", ARCH, "--smoke", "--batch", "2",
            "--cache-len", "32", "--device", "cpu"]
    assert main(argv) == 0
    assert "registered:" in capsys.readouterr().out
    assert main(["--db", path, "--list"]) == 0
    assert "1 registered plan(s)" in capsys.readouterr().out

    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "2",
            "--tokens", "2", "--cache-len", "32", "--registry-db", path]
    done = serve(args + ["--batch", "2"])
    assert sorted(done) == ["r0", "r1"]
    assert "plan=registry " in capsys.readouterr().out
    serve(args + ["--batch", "4"])          # nearest registered shape
    assert "plan=registry~decode:32x2 " in capsys.readouterr().out
    # the order is the reference's: a --plan file before the registry
    cfg = get_arch(ARCH).smoke()
    plan_path = str(tmp_path / "plan.json")
    _plan(cfg, cache_upcast=False).save(plan_path)
    plan, src = resolve_plan(cfg, serving_shape(2, 32), plan_path=plan_path,
                             registry_db=path)
    assert src == f"file:{plan_path}" and plan.to_json() == \
        Plan.load(plan_path).to_json()
    assert resolve_plan(cfg, serving_shape(2, 32))[1] == "default"
    with pytest.raises(SystemExit, match="no plan registered"):
        resolve_plan(get_arch("granite-8b").smoke(), serving_shape(2, 32),
                     registry_db=path)


def test_serve_batched_example_on_cpu(capsys):
    out = serve_batched.main(["--device", "cpu"])
    assert sorted(out) == ["granite-8b", "recurrentgemma-2b"]
    for name, seqs in out.items():
        assert tuple(seqs.shape) == (4, 24)
        assert int(seqs.max()) < get_arch(name).smoke().vocab_size
    assert "tok/s" in capsys.readouterr().out
    # greedy decoding from seeded weights and prompts is deterministic
    again = serve_batched.generate("granite-8b", device="cpu")
    assert again.tolist() == out["granite-8b"].tolist()
