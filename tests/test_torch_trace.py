"""The port's spans and counters (``repro_torch.runtime.trace``) on the CPU:
off by default and then silent, nesting and parents (across threads too),
stamps on ``time.time_ns()``, counted spans, and the spans a train step
and a wall-clock sweep record.  Torch only."""
import threading
import time
from collections import Counter

import pytest
import torch

from repro_torch.configs import get_arch, get_shape
from repro_torch.core.combinator import GlobalKnobs
from repro_torch.core.plan import uniform_plan
from repro_torch.core.tuner import ComParTuner
from repro_torch.models.context import SegmentClause
from repro_torch.runtime import trace
from repro_torch.train.step import init_train_state, make_train_step


@pytest.fixture
def tracer():
    """The process's tracer, cleared and off before and after the test."""
    trace.disable()
    trace.clear()
    yield trace
    trace.disable()
    trace.clear()


@pytest.fixture
def mallocs(monkeypatch):
    """A CUDA allocator stand-in: ``memory_stats()`` counts its calls and
    reads 3 more device allocations at each."""
    calls = []

    def stats():
        calls.append(1)
        return {"num_device_alloc": 3 * len(calls)}
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_stats", stats)
    return calls


def _tiny_step(mb=1):
    cfg = get_arch("granite-8b").smoke()
    plan = uniform_plan(cfg, "fsdp", set(), SegmentClause(kernel="cuda"),
                        GlobalKnobs(microbatches=mb))
    params, opt = init_train_state(cfg, plan,
                                   torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 17),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    step = make_train_step(cfg, plan, device="cpu", warmup=0)
    return lambda: step(params, opt, batch)


def _tiny_sweep():
    cfg, shape = get_arch("granite-8b").smoke(), \
        get_shape("train_4k").smoke()
    tuner = ComParTuner(cfg, shape, device="cpu", executor="wallclock")
    tuner.executor.repeats = 1
    try:
        return tuner.sweep(["fsdp"], {"kernel": ("cuda",), "block_q": (16,)},
                           backend="sequential")[1]
    finally:
        tuner.close()


def _tree(spans):
    """Counter of (name, parent's name)."""
    names = {s["id"]: s["name"] for s in spans}
    return Counter((s["name"], names.get(s["parent"])) for s in spans)


def test_off_records_nothing_and_reads_no_allocator(tracer, mallocs):
    assert tracer.span("x") is tracer.span("y")     # the shared null context
    _tiny_step()()
    rep = _tiny_sweep()
    assert rep.n_scored == 3 and tracer.export() == [] and mallocs == []


def test_nesting_parents_and_stamps(tracer):
    tracer.enable()
    before = time.time_ns()
    with tracer.span("a", step=4):
        with tracer.span("b"):
            pass
        with tracer.span("c"):
            pass
    after = time.time_ns()
    with tracer.span("d"):
        pass
    spans = {s["name"]: s for s in tracer.export()}
    assert [s["name"] for s in tracer.export()] == ["b", "c", "a", "d"]
    a, b, c, d = (spans[k] for k in "abcd")
    assert a["parent"] is None and d["parent"] is None
    assert b["parent"] == c["parent"] == a["id"]
    assert a["attrs"] == {"step": 4} and b["attrs"] == {}
    assert before <= a["t0_ns"] <= b["t0_ns"] <= b["t1_ns"] <= c["t0_ns"] \
        <= c["t1_ns"] <= a["t1_ns"] <= after <= d["t0_ns"]
    assert a["device_ms"] is None and a["counters"] == {}
    assert len({s["id"] for s in spans.values()}) == 4
    tracer.clear()
    assert tracer.export() == []


def test_a_lent_span_parents_another_threads_spans(tracer):
    tracer.enable()

    def work():
        with tracer.span("worker"):
            with tracer.span("inner"):
                pass
    with tracer.span("plain"):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
    with tracer.span("lender", lend=True):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    spans = tracer.export()
    byname = {}
    for s in spans:
        byname.setdefault(s["name"], []).append(s)
    lender = byname["lender"][0]
    w_plain, w_lent = byname["worker"]
    assert w_plain["parent"] is None                 # nothing lent
    assert w_lent["parent"] == lender["id"]
    assert w_lent["thread"] != lender["thread"]
    assert byname["inner"][1]["parent"] == w_lent["id"]
    # lending ends with the span
    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=30)
    assert tracer.export()[-1]["parent"] is None


def test_counted_span_records_device_allocations(tracer, mallocs):
    tracer.enable()
    with tracer.span("job", counted=True):
        with tracer.span("inner"):
            pass
    spans = {s["name"]: s for s in tracer.export()}
    assert spans["job"]["counters"] == {trace.MALLOCS: 3}
    assert spans["inner"]["counters"] == {} and len(mallocs) == 2


def test_traced_decorator_and_device_timing_needs_cuda(tracer, monkeypatch):
    @trace.traced("outer")
    def f(x):
        with trace.span("in"):
            return x + 1
    assert f(1) == 2 and tracer.export() == []
    tracer.enable()
    assert f(2) == 3
    assert _tree(tracer.export()) == Counter({("in", "outer"): 1,
                                              ("outer", None): 1})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tracer.enable(device_timing=True)


@pytest.mark.parametrize("mb", [1, 2])
def test_train_step_spans(tracer, mallocs, mb):
    step = _tiny_step(mb)
    tracer.enable()
    step()
    spans = tracer.export()
    assert _tree(spans) == Counter({
        ("train.step", None): 1, ("train.grads", "train.step"): mb,
        ("train.forward", "train.grads"): mb,
        ("train.backward", "train.grads"): mb,
        ("train.optimizer", "train.step"): 1,
        # one flash-attention op per layer, its backward under the backward
        ("kernels.flash_attention.bwd", "train.backward"): 2 * mb})
    top = [s for s in spans if s["name"] == "train.step"][0]
    assert top["attrs"] == {"step": 0}
    assert top["counters"] == {trace.MALLOCS: 3} and len(mallocs) == 2


def test_sweep_spans(tracer, mallocs):
    tracer.enable()
    rep = _tiny_sweep()
    spans = tracer.export()
    jobs = rep.n_scored
    tree = _tree(spans)
    assert {k: v for k, v in tree.items()
            if not k[0].startswith("kernels.")} == {
        ("sweep", None): 1, ("score.job", "sweep"): jobs,
        ("score.build", "score.job"): jobs,
        ("score.warmup", "score.job"): jobs,
        ("score.timed", "score.job"): jobs,
        ("score.release", "score.job"): jobs,
        ("score.gc", "score.release"): jobs,
        ("score.free", "score.release"): jobs}
    # the stack program's flash-attention backward, warm-up and one timed
    # call, 2 layers each
    assert tree[("kernels.flash_attention.bwd", "score.warmup")] == 2
    assert tree[("kernels.flash_attention.bwd", "score.timed")] == 2
    job = [s for s in spans if s["name"] == "score.job"]
    assert {s["attrs"]["segment"] for s in job} == {"embed", "g0", "head"}
    assert all(s["counters"] == {trace.MALLOCS: 3} for s in job)
