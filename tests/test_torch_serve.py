"""The port's serving path on the CPU: the engine's byte-identity contract,
its token streams against the JAX package's ServeEngine on the same f32
smoke weights and seeded requests, plans written by the JAX package, and
the CLI."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core.plan import uniform_plan as juniform_plan
from repro.models.context import SegmentClause as JClause
from repro.models.model import model_specs as jmodel_specs
from repro.models.params import init_params as jinit_params
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_arch
from repro_torch.core.plan import Plan, uniform_plan
from repro_torch.launch.serve import serve
from repro_torch.models.context import SegmentClause
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import init_cache
from repro_torch.serve.engine import Request, ServeEngine, cache_batch_axes


def _plan(cfg, kernel="plain"):
    return uniform_plan(cfg, "tensor_par", set(),
                        SegmentClause(kernel=kernel))


def _reqs(cls, vocab, n, *, seed=0, tokens=6, prompt_len=3):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        p = max(1, prompt_len + int(rng.randint(-1, 2)))
        out.append(cls(rid=f"r{i}",
                       prompt=tuple(int(t) for t in rng.randint(0, vocab, p)),
                       max_new_tokens=tokens + i % 3))
    return out


def _engine(name="granite-8b", kernel="plain", **kw):
    cfg = get_arch(name).smoke()
    return ServeEngine(cfg, _plan(cfg, kernel), device="cpu", **kw)


@pytest.mark.parametrize("name,kernel", [
    ("granite-8b", "plain"), ("granite-8b", "cuda"),
    ("recurrentgemma-2b", "cuda"), ("xlstm-125m", "cuda"),
    ("qwen3-moe-30b-a3b", "cuda")])
def test_engine_batched_equals_sequential_byte_identical(name, kernel):
    eng = _engine(name, kernel=kernel, capacity=4, cache_len=32)
    reqs = _reqs(Request, eng.cfg.vocab_size, 7)
    batched = eng.run(reqs)
    assert eng.stats.peak_active >= 3
    assert eng.stats.n_completed == len(reqs)
    sequential = eng.run(reqs, max_active=1)
    assert eng.stats.peak_active == 1
    for r in reqs:
        assert batched[r.rid].tokens == sequential[r.rid].tokens, r.rid
        assert batched[r.rid].finish_reason == \
            sequential[r.rid].finish_reason


@pytest.mark.parametrize("name", ["granite-8b", "recurrentgemma-2b",
                                  "xlstm-125m", "qwen3-moe-30b-a3b"])
def test_engine_streams_match_reference_engine(name):
    """Same f32 smoke weights, same seeded requests: the port's engine
    emits the reference engine's token streams."""
    jcfg = jget_arch(name).smoke()
    jparams = jinit_params(jmodel_specs(jcfg), jax.random.key(0))
    jeng = JServeEngine(jcfg, juniform_plan(jcfg, "tensor_par", set(),
                                            JClause(kernel="xla")),
                        capacity=3, cache_len=16, params=jparams)
    eng = _engine(name, capacity=3, cache_len=16,
                  params=params_from_numpy(jax.tree.map(np.asarray, jparams),
                                           "cpu"))
    want = jeng.run(_reqs(JRequest, jcfg.vocab_size, 4, tokens=4))
    got = eng.run(_reqs(Request, jcfg.vocab_size, 4, tokens=4))
    assert sorted(got) == sorted(want)
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].finish_reason == want[rid].finish_reason


def test_engine_eos_recycles_slot():
    eng = _engine(capacity=2, cache_len=32)
    ref = eng.run([Request(rid="p", prompt=(1, 2, 3),
                           max_new_tokens=20)])["p"].tokens
    k = next(i for i in range(1, len(ref)) if ref[i] not in ref[:i])
    done = eng.run([Request(rid="p", prompt=(1, 2, 3), max_new_tokens=20,
                            eos_id=ref[k]),
                    Request(rid="q", prompt=(4, 4), max_new_tokens=12)])
    assert done["p"].finish_reason == "eos"
    assert done["p"].tokens == ref[:k + 1]
    assert done["q"].finish_reason == "length"
    assert done["p"].done_step <= done["q"].done_step


def test_engine_overflow_and_duplicate_rid_rejected():
    eng = _engine(capacity=2, cache_len=8)
    with pytest.raises(ValueError, match="cache_len"):
        eng.run([Request(rid="a", prompt=(1, 2, 3, 4), max_new_tokens=8)])
    with pytest.raises(ValueError, match="duplicate"):
        eng.run([Request(rid="a", prompt=(1,), max_new_tokens=2),
                 Request(rid="a", prompt=(2,), max_new_tokens=2)])
    with pytest.raises(ValueError, match="empty prompt"):
        Request(rid="a", prompt=())


def test_cache_batch_axes_match_cache_ranks():
    for name in ("granite-8b", "stablelm-3b", "recurrentgemma-2b",
                 "xlstm-125m"):
        cfg = get_arch(name).smoke()
        for c in (cfg, dataclasses.replace(cfg, num_layers=3 * cfg.num_layers)):
            caches = init_cache(c, 3, 8, "cpu")
            axes = cache_batch_axes(c)
            for g in caches:
                for b in caches[g]:
                    for leaf, ax in zip(caches[g][b].values(),
                                        axes[g][b].values()):
                        assert leaf.shape[ax] == 3, (c.name, g, b)


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "xlstm-125m"])
def test_engine_recycled_slot_starts_from_reset_state(name):
    """One slot, two requests: the second is admitted into the slot the
    first left, after the first ran its recurrent (and conv) state forward.
    Its stream equals the stream it gets in a fresh run, and its admitted
    state equals a fresh prefill's."""
    cfg = get_arch(name).smoke()
    cfg = dataclasses.replace(cfg, num_layers=2 * cfg.num_layers)  # stacked
    eng = ServeEngine(cfg, _plan(cfg, "cuda"), capacity=1, cache_len=16,
                      device="cpu")
    a = Request(rid="a", prompt=(5, 6, 7, 8), max_new_tokens=6)
    b = Request(rid="b", prompt=(9, 2), max_new_tokens=5)
    both = eng.run([a, b])
    assert both["b"].slot == both["a"].slot == 0
    alone = eng.run([b])
    assert both["b"].tokens == alone["b"].tokens
    # admission over a dirty slot leaves exactly the fresh prefill's state
    caches = init_cache(cfg, 1, 16, "cpu")
    eng._admit(caches, 0, a, eng.stats)
    eng._admit(caches, 0, b, eng.stats)
    fresh = init_cache(cfg, 1, 16, "cpu")
    eng._admit(fresh, 0, b, eng.stats)
    for g in caches:
        for blk in caches[g]:
            for key, leaf in caches[g][blk].items():
                assert torch.equal(leaf, fresh[g][blk][key]), (g, blk, key)


def test_engine_recurrent_archs_ignore_cache_len():
    """Recurrent state and windowed caches bound no request length."""
    for name in ("recurrentgemma-2b", "xlstm-125m"):
        eng = _engine(name, capacity=2, cache_len=4)
        done = eng.run([Request(rid="a", prompt=(1, 2, 3), max_new_tokens=6)])
        assert len(done["a"].tokens) == 6


@pytest.mark.parametrize("jkernel,kernel", [("xla", "plain"),
                                            ("pallas", "cuda")])
def test_reference_plan_json_loads_unchanged(jkernel, kernel):
    jcfg = jget_arch("granite-8b").smoke()
    jplan = juniform_plan(jcfg, "tensor_par", {"shard_vocab"},
                          JClause(kernel=jkernel, block_q=256))
    plan = Plan.from_json(json.loads(json.dumps(jplan.to_json())))
    assert sorted(plan.segments) == sorted(jplan.segments)
    for c in plan.segments.values():
        assert c.clause.kernel == kernel and c.clause.block_q == 256
        assert c.flags == frozenset({"shard_vocab"})
    again = Plan.from_json(json.loads(json.dumps(plan.to_json())))
    assert again.to_json() == plan.to_json()


def test_arch_registry_names_pending_roadmap_items():
    assert get_arch("granite-8b").num_layers == 36
    assert get_arch("stablelm-3b-smoke").norm == "layernorm"
    assert get_arch("xlstm-125m").block_kinds().count("mlstm") == 9
    assert get_arch("recurrentgemma-2b-smoke").head_dim == 16
    assert get_arch("qwen3-moe-30b-a3b").num_experts == 128
    assert get_arch("kimi-k2-1t-a32b-smoke").first_k_dense == 1
    with pytest.raises(KeyError, match="ROADMAP Queue 1 item 6"):
        get_arch("chatglm3-6b")
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("nope")
    with pytest.raises(ValueError, match="kernel"):
        SegmentClause(kernel="pallas")


@pytest.mark.parametrize("arch", ["granite-8b", "recurrentgemma-2b",
                                  "xlstm-125m", "qwen3-moe-30b-a3b"])
def test_cli_serves_on_cpu(capsys, arch):
    done = serve(["--arch", arch, "--smoke", "--device", "cpu",
                  "--requests", "2", "--tokens", "3", "--cache-len", "16"])
    assert sorted(done) == ["r0", "r1"]
    assert all(len(c.tokens) == 3 for c in done.values())
    assert "plan=default" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="not ported"):
        serve(["--arch", "granite-8b", "--smoke", "--device", "cpu",
               "--registry-db", "x.db"])


def test_engine_prefill_and_decode_stats():
    eng = _engine(capacity=2, cache_len=16)
    eng.run(_reqs(Request, eng.cfg.vocab_size, 3, tokens=3))
    st = eng.stats
    assert st.n_prefills == 3 and st.n_prefill_tokens >= 3
    assert st.n_tokens == sum(3 + i % 3 for i in range(3))
    assert st.prefill_s > 0 and st.decode_s > 0
    assert st.prefill_tok_s > 0 and st.decode_tok_s > 0
