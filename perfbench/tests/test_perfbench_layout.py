"""BENCHMARK.json against the contract's shape, and every cell's files
found by name."""
import json
import re

import pytest

import perfbench_tiny  # noqa: F401  (puts the checkout on sys.path)
from perfbench.harness import cell as C

BENCH = C.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_bounds():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m["workloads"]:
            mv = e2e[m["moves"]]
            assert w in CELLS and ("workloads" not in mv
                                   or w in mv["workloads"])
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"


def test_cells_and_configs():
    for entry in BENCH["workloads"] + BENCH["configs"]:
        assert NAME.match(entry["name"])
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs) and len(set(CELLS)) == len(CELLS)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used and c["file"].startswith("perfbench/")
        data = json.loads((C.CHECKOUT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        for k in c["reduced"]:
            assert k in data["arch"] and not k.endswith(("_dim", "_rank"))
            assert data["published"][k] != data["arch"][k]
        for k, v in data["published"].items():
            if k in data["arch"] and k not in c["reduced"]:
                assert data["arch"][k] == v, k


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = C.load_cell(name)
    assert cell.end_to_end and cell.per_layer
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert C.entry(cell).run
    for metric, reader in C.readers(cell).items():
        assert callable(reader.read), metric
    assert set(cell.limits) >= {"logits_err", "grad_gap", "change_gap",
                                "grad_sample_err"}
    if cell.traffic["entry"] == "sweep":
        assert set(cell.limits) >= {"rows_not_done", "plan_not_least",
                                    "jobs_not_as_set", "seg_grad_err",
                                    "seg_grad_gap"}


def test_file_names_are_names():
    for path in C.ROOT.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(C.CHECKOUT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
