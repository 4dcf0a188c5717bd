"""The program's spans seen from the benchmark (``harness/program.py``,
``program_trace.py``): tiny runs on the CPU with the tracer on, a run
where the program has no tracer, the readers on synthetic spans, and the
labeller across the harness's and the program's spans."""
import sys
from collections import Counter

import pytest

from perfbench_tiny import run, tiny_cell
from perfbench import program_trace
from perfbench.harness import program, work


def _tree(spans):
    names = {s["id"]: s["name"] for s in spans}
    return Counter((s["name"], names.get(s["parent"])) for s in spans)


def _tracer_left_off():
    from repro_torch.runtime import trace
    return not trace.TRACER.on and trace.export() == []


def test_tiny_train_run_traced():
    seen = {}
    with program_trace.installed(seen):
        res = run(tiny_cell("granite-8b.train-4k"), seconds=0.0)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    tree, steps = _tree(seen["spans"]), res["attempted"]
    assert tree == Counter({
        ("train.step", None): steps, ("train.grads", "train.step"): steps,
        ("train.forward", "train.grads"): steps,
        ("train.backward", "train.grads"): steps,
        ("train.optimizer", "train.step"): steps,
        ("kernels.flash_attention.bwd", "train.backward"): 2 * steps})
    assert res["program"]["totals"]["train.step"]["n"] == steps
    # no device on the CPU: no device ms, no allocations counted
    assert set(res["program"]["numbers"].values()) == {None}
    assert _tracer_left_off()


#: the sweep's space cut to one provider and clause (3 programs)
SMALL = {"providers": ["fsdp"],
         "clause_space": {"remat": ["none"], "kernel": ["cuda"]}}


def test_tiny_sweep_run_traced():
    seen = {}
    with program_trace.installed(seen):
        res = run(tiny_cell("granite-8b.sweep-4k", **SMALL), seconds=0.0,
                  trace=True)
    assert res["correct"], res["checks"]
    tree = _tree(seen["spans"])
    jobs = tree[("score.job", "sweep")]
    assert jobs == 3 * tree[("sweep", None)] and jobs
    for child in ("score.build", "score.warmup", "score.timed",
                  "score.release"):
        assert tree[(child, "score.job")] == jobs
    assert tree[("score.gc", "score.release")] == jobs
    assert tree[("score.free", "score.release")] == jobs
    num = res["program"]["numbers"]
    assert 0 < num["timed_share.sweep"] < res["metrics"][
        "scoring_share.sweep"]["value"]
    assert num["build_ms.sweep"] > 0 and num["release_ms.sweep"] > 0
    assert num["mallocs_per_job.sweep"] is None
    # the program's jobs lie inside the harness's wrapper around them
    harness_s = res["program"]["harness"]["host_s"]["score_segment"]
    assert 0 < res["program"]["totals"]["score.job"]["host_s"] <= harness_s
    assert _tracer_left_off()


def test_untraced_runs_leave_the_tracer_off():
    res = run(tiny_cell("granite-8b.train-4k-plain"), seconds=0.0,
              trace=True)
    assert res["correct"] and "program" not in res
    assert _tracer_left_off()


def test_a_program_without_tracer(monkeypatch):
    # as on an older src/: the run is run.py's, and nothing is read
    import repro_torch.runtime
    monkeypatch.delattr(repro_torch.runtime, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.trace", None)
    assert program.tracer() is None
    seen = {}
    with program_trace.installed(seen):
        res = run(tiny_cell("starcoder2-3b.train-8k"), seconds=0.0)
    assert res["correct"], res["checks"]
    assert res["program"] is None and seen == {}


def _span(name, i, parent, t0, t1, device_ms=None, counters=None):
    return {"name": name, "id": i, "parent": parent, "thread": 1,
            "t0_ns": t0, "t1_ns": t1, "attrs": {}, "device_ms": device_ms,
            "counters": counters or {}}


@pytest.mark.parametrize("config,batch,seq,bound_ms", [
    # twice the forward's bound (PERF.md's kernel table), by operations
    ("granite-8b-8l", 2, 4096, 4 * 0.1390),
    ("starcoder2-3b-15l", 1, 8192, 2 * 0.3127)])
def test_train_numbers_from_synthetic_spans(config, batch, seq, bound_ms):
    import json
    from perfbench.harness import cell as C
    arch = json.loads((C.ROOT / "configs" / f"{config}.json")
                      .read_text())["arch"]
    flops, nbytes = program.flash_attention_bwd(
        batch, arch["num_heads"], arch["num_kv_heads"], seq, 128,
        arch["window_size"], arch["dtype"])
    least, which = work.bound_s(nbytes, flops, arch["dtype"])
    assert which == "operations"
    assert least * 1e3 == pytest.approx(bound_ms, abs=2e-4)
    spans = []
    for k in range(2):                              # two steps
        b = 10 * k
        spans += [_span("kernels.flash_attention.bwd", b + 4, b + 3, 0, 1,
                        100 * least * 1e3 / 2)] * 3
        spans += [_span("train.forward", b + 2, b + 1, 0, 1, 300.0),
                  _span("train.backward", b + 3, b + 1, 0, 1, 600.0 + k),
                  _span("train.grads", b + 1, b, 0, 1, 905.0),
                  _span("train.optimizer", b + 5, b, 0, 1, 100.0),
                  _span("train.step", b, None, 0, 1, 1010.0,
                        {program.MALLOCS: 2 * k})]
    got = program.train_numbers(spans, arch, batch, seq)
    assert got["fwd_ms.train"] == 300.0
    assert got["bwd_ms.train"] == 600.5
    assert got["fa_bwd_ms.train"] == pytest.approx(3 * 50 * least * 1e3)
    assert got["fa_bwd_roofline.train"] == pytest.approx(2.0)
    assert got["mallocs_per_step.train"] == 1.0
    # a reader with nothing to read returns nothing, never 0
    assert set(program.train_numbers([], arch, batch, seq).values()) == \
        {None}


def test_sweep_numbers_from_synthetic_spans():
    ms = 10 ** 6
    spans = [_span("sweep", 1, None, 0, 1000 * ms)]
    for j in range(4):
        t = 200 * j * ms
        spans += [_span("score.job", 10 + j, 1, t, t + 150 * ms,
                        counters={program.MALLOCS: 40 + j}),
                  _span("score.build", 20 + j, 10 + j, t, t + 20 * ms),
                  _span("score.timed", 30 + j, 10 + j, t + 50 * ms,
                        t + 100 * ms),
                  _span("score.release", 40 + j, 10 + j, t + 100 * ms,
                        t + (130 + j) * ms)]
    got = program.sweep_numbers(spans)
    assert got["timed_share.sweep"] == pytest.approx(20.0)
    assert got["build_ms.sweep"] == pytest.approx(20.0)
    assert got["release_ms.sweep"] == pytest.approx(31.5)
    assert got["mallocs_per_job.sweep"] == pytest.approx(41.5)
    assert set(program.sweep_numbers([]).values()) == {None}


def test_labeller_picks_the_innermost_of_both_kinds():
    harness = [("sweep", 0, 100), ("score_segment", 10, 50)]
    prog = [_span("score.job", 1, None, 11, 49),
            _span("score.build", 2, 1, 11, 20),
            _span("score.release", 3, 1, 40, 49),
            _span("score.gc", 4, 3, 40, 45),
            # starts with its parent: the shorter is the inner
            _span("score.free", 5, 3, 45, 49),
            _span("whole", 6, None, 45, 60)]
    lab = program.Labeller(harness, prog)
    assert [lab.label(t) for t in (5, 10, 11, 25, 42, 46, 55, 99, 100,
                                   -1)] == [
        "sweep", "score_segment", "score.build", "score.job", "score.gc",
        "score.free", "whole", "sweep", "host", "host"]
    # idle ns of [0, 100) outside the busy intervals, each piece of a gap
    # under the innermost span open over it
    busy = [[2, 11], [20, 42], [44, 47], [52, 99]]
    idle = program.idle_by_label(busy, 0, 100, lab)
    assert idle == pytest.approx({
        "sweep": 3e-9, "score.build": 9e-9, "score.gc": 2e-9,
        "score.free": 2e-9, "whole": 3e-9})


def test_idle_split_of_a_profiler():
    """``program_trace``'s reading of a profiler's device events (as
    ``harness/trace.py`` reads them) into the idle split by label."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    def ev(t0, t1, device=DeviceType.CUDA):
        return NS(start_ns=lambda: t0, duration_ns=lambda: t1 - t0,
                  device_type=lambda: device)
    events = [ev(2, 11), ev(5, 9), ev(20, 42), ev(30, 44, DeviceType.CPU),
              ev(44, 47), ev(52, 120)]
    prof = NS(t0=0, t1=100, profiler=NS(kineto_results=NS(
        events=lambda: events)))
    labels = program_trace._Labels(program, NS(host=[("sweep", 0, 100)]),
                                   NS(export=lambda: [
                                       _span("score.gc", 1, None, 40, 45)]))
    idle = program_trace._idle(prof, labels.get(), program)
    assert idle == pytest.approx({"sweep": 16e-9, "score.gc": 2e-9})
    assert labels.label(41) == "score.gc"
