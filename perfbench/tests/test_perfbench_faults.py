"""Whole runs on the CPU at a tiny size with the timed path broken
underneath: each fault a cell can have, and the control (the reference in
float8 in the program's place), must come out not correct under the
cells' limits; the same run unbroken comes out correct."""
import contextlib
import dataclasses

import pytest
import torch

from perfbench_tiny import run, tiny_cell
import perfbench.calibrate as calibrate
import perfbench.entries.train as train_entry
from perfbench.harness import verdict


@contextlib.contextmanager
def patched(module, name, make):
    old = getattr(module, name)
    setattr(module, name, make(old))
    try:
        yield
    finally:
        setattr(module, name, old)


def state_unchanged():
    """The step leaves the parameters and the optimizer state as they
    were."""
    import repro_torch.train.step as S
    return patched(S, "adamw_update",
                   lambda f: lambda grads, state, params, **kw:
                   (params, state, {}))


def one_leaf_double():
    """One leaf's update is applied twice (an answer altered where it is
    produced)."""
    import repro_torch.train.step as S

    def make(f):
        def update(grads, state, params, **kw):
            w = params["head"]["norm"]["scale"]
            before = w.detach().clone()
            out = f(grads, state, params, **kw)
            with torch.no_grad():
                w.add_(w - before)
            return out
        return update
    return patched(S, "adamw_update", make)


def reference_in_program_place():
    """The control: the program's readings are the float8 reference's."""
    def make(Program):
        class Control(Program):
            def first_steps(self, n):
                return train_entry.reference_readings(
                    self.ctx, self.arch, self.ctx.cell.traffic, "fp8")
        return Control
    return patched(train_entry, "Program", make)


FAULTS = {"state_unchanged": state_unchanged,
          "half_batch": calibrate.half_batch,
          "one_leaf_double": one_leaf_double,
          "control_fp8": reference_in_program_place}
TRAIN_CELLS = ["granite-8b.train-4k", "starcoder2-3b.train-8k",
               "granite-8b.train-4k-plain"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_train_fault_is_not_correct(name, fault):
    cell = tiny_cell(name)
    with FAULTS[fault]():
        res = run(cell, seconds=0.05)
    assert not res["correct"], res["checks"]


def test_a_leaf_left_out_reads_one():
    sample = {k: torch.ones(3) for k in "abc"}
    prog = {"losses": [1.0], "grad_norms": {"a": 1.0, "b": 2.0, "c": 1.0},
            "change_norms": {"a": 0.0, "b": 2.0, "c": 1.0},
            "grad_samples": sample, "logits_sample": torch.ones(4)}
    ref = {"losses": [1.0], "grad_norms": {"a": 1.0, "b": 2.0, "c": 1.0},
           "change_norms": {"a": 1.0, "b": 2.0, "c": 1.0},
           "grad_samples": dict(sample, b=torch.zeros(3) + 2),
           "logits_sample": torch.tensor([1.0, 1.0, 1.0, 3.0])}
    gaps = verdict.training_gaps(prog, ref)
    assert gaps["change_gap"]["value"] == 1.0
    assert gaps["grad_sample_err"]["value"] == 0.5
    assert gaps["logits_err"]["value"] == pytest.approx(2 / 12 ** 0.5)
    # a leaf whose reference gradient is nought to rounding is not counted
    ref["grad_norms"]["a"] = 1e-6
    assert verdict.training_gaps(prog, ref)["change_gap"]["value"] == 0.0


def plan_altered():
    """The fused plan's stack clause is not the one its rows chose."""
    import repro_torch.core.tuner as T

    def make(f):
        def fuse(*a, **kw):
            plan = f(*a, **kw)
            c = plan.segments["g0"]
            other = "dots" if c.clause.remat == "none" else "none"
            plan.segments["g0"] = dataclasses.replace(
                c, clause=dataclasses.replace(c.clause, remat=other))
            return plan
        return fuse
    return patched(T, "fuse_joint", make)


def cuda_rows_fail():
    """Every program on the hand kernels fails to score: rows not done."""
    from repro_torch.core.executor import (CombinationFailed,
                                           WallClockExecutor)

    def make(f):
        def score(self, cfg, shape, seg, combo, *a, **kw):
            if combo.clause.kernel == "cuda":
                raise CombinationFailed("planted")
            return f(self, cfg, shape, seg, combo, *a, **kw)
        return score
    return patched(WallClockExecutor, "score_segment", make)


def repeats_cut():
    """The executor times each program once instead of ``repeats`` times."""
    from repro_torch.core.executor import WallClockExecutor

    def make(init):
        def once(self, *a, **kw):
            init(self, *a, **kw)
            self.repeats = 1
        return once
    return patched(WallClockExecutor, "__init__", make)


def shape_halved():
    """Programs are built at half the traffic's sequence."""
    import repro_torch.core.executor as E

    def make(build):
        def half(cfg, shape, *a, **kw):
            return build(cfg, dataclasses.replace(
                shape, seq_len=shape.seq_len // 2), *a, **kw)
        return half
    return patched(E, "segment_program", make)


def forward_only():
    """The timed programs run their segment's forward and no backward."""
    import repro_torch.core.timer as T
    return patched(T, "_with_bwd",
                   lambda f: lambda fn, argnums=(0,), scalar=False: fn)


def segments_control():
    """The control: each program's gradients are the float8 reference's."""
    from perfbench.entries.sweep import Watch
    from perfbench.reference.segments import segment_grads

    def make(_read):
        def read(self, job):
            weights = {p: self.weight(p) for p in
                       self.segment_paths(job["segment"], job["kind"])}
            return self.read(segment_grads(self.arch, job["kind"], weights,
                                           self.input_of(job["kind"]),
                                           "fp8"))
        return read
    return patched(Watch, "_read", make)


SWEEP_FAULTS = {"plan_altered": plan_altered, "cuda_rows_fail": cuda_rows_fail,
                "state_unchanged": state_unchanged,
                "half_batch": calibrate.half_batch,
                "repeats_cut": repeats_cut, "shape_halved": shape_halved,
                "forward_only": forward_only,
                "half_segment": calibrate.half_segment,
                "control_fp8": segments_control}
#: the sweep's space cut to one remat (18 rows, 4 programs) for the faults
SMALL_SPACE = {"remat": ["none"], "kernel": ["plain", "cuda"]}


@pytest.mark.parametrize("fault", sorted(SWEEP_FAULTS))
def test_sweep_fault_is_not_correct(fault):
    cell = tiny_cell("granite-8b.sweep-4k", dtype="bfloat16",
                     clause_space=SMALL_SPACE)
    with SWEEP_FAULTS[fault]():
        res = run(cell, seconds=0.0)
    assert not res["correct"], res["checks"]


def test_sweep_unbroken_is_correct():
    res = run(tiny_cell("granite-8b.sweep-4k"), seconds=0.0)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 72 and res["failed"] == 0
    for check, c in res["checks"].items():
        assert c["value"] < 1e-5, (check, c)


def test_sweep_small_space_in_bfloat16_is_correct():
    cell = tiny_cell("granite-8b.sweep-4k", dtype="bfloat16",
                     clause_space=SMALL_SPACE)
    res = run(cell, seconds=0.0)
    assert res["correct"], res["checks"]
