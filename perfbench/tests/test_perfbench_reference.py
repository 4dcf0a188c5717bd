"""The reference against the port at a tiny size on the CPU: the train
entry's whole run (set-up, window, check), in float32, where the two
agree to rounding."""
import pytest

from perfbench_tiny import run, tiny_cell
from perfbench.entries.sweep import check_sweep
from perfbench.reference.fusion import best_per_segment


@pytest.mark.parametrize("name", ["granite-8b.train-4k",
                                  "starcoder2-3b.train-8k",
                                  "granite-8b.train-4k-plain"])
def test_train_entry_agrees_with_the_reference(name):
    res = run(tiny_cell(name))
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    for check, c in res["checks"].items():
        assert c["value"] < 1e-5, (check, c)
    assert set(res["metrics"]) == {"train_tok_s", "setup_s"}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("name", ["granite-8b.train-4k",
                                  "granite-8b.sweep-4k"])
def test_traced_run_on_the_cpu_reads_no_device_metric(name):
    # the spans run, but no device trace: every reader returns nothing
    res = run(tiny_cell(name), seconds=0.0, trace=True)
    assert res["correct"] and res["metrics"].keys() <= {
        "programs_per_sweep.sweep", "scoring_share.sweep"}
    assert "busy_s" not in res["device"] and "breakdown" not in res


def test_reference_fusion_is_the_least_per_segment():
    rows = [{"segment": "g0", "status": "done", "total_s": 0.5, "cid": "a",
             "n_repeats": 5},
            {"segment": "g0", "status": "done", "total_s": 0.4, "cid": "b",
             "n_repeats": 5},
            {"segment": "g0", "status": "failed", "total_s": 0.1,
             "cid": "c", "n_repeats": 0},
            {"segment": "head", "status": "done", "total_s": 0.1,
             "cid": "d", "n_repeats": 5}]
    assert best_per_segment(rows) == {"g0": 0.4, "head": 0.1}
    traffic = {"batch": 1, "seq": 64, "repeats": 5}
    job = {"segment": "g0", "kind": "stack", "shape": [1, 64, "train"],
           "input_as_set": True, "calls": 6, "read": {"x": None}}
    sweep = {"rows": rows, "n_combinations": 4, "n_scored": 1,
             "chosen": {"g0": "b", "head": "d"}, "jobs": [job]}
    assert check_sweep(sweep, traffic) == {
        "rows_not_done": 1, "plan_not_least": 0, "jobs_not_as_set": 0}
    sweep["chosen"]["g0"] = "a"
    assert check_sweep(sweep, traffic)["plan_not_least"] == 1
    sweep["n_combinations"] = 6
    assert check_sweep(sweep, traffic)["rows_not_done"] == 3
    # a row timed once, a program called once more, one job missing
    rows[0]["n_repeats"] = 1
    assert check_sweep(sweep, traffic)["jobs_not_as_set"] == 1
    job["calls"] = 7
    assert check_sweep(sweep, traffic)["jobs_not_as_set"] == 2
    sweep["n_scored"] = 2
    assert check_sweep(sweep, traffic)["jobs_not_as_set"] == 3
