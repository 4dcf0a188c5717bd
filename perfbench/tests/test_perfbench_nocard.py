"""``run.py`` without a CUDA card, and in a directory holding only
``BENCHMARK.json`` and the benchmark: it fails and prints no result, and
never falls back to the CPU."""
import os
import shutil
import subprocess
import sys

import pytest

import perfbench_tiny

CHECKOUT = perfbench_tiny.CHECKOUT
ARGS = ["--workload", "granite-8b.train-4k", "--seed", str(2 ** 31 + 7),
        "--seconds", "1", "--trace", "0"]


def _run(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS],
                          cwd=str(cwd), env=env, capture_output=True,
                          text=True, timeout=300)


def test_no_card_no_result():
    out = _run(CHECKOUT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_bare_directory_no_result(tmp_path):
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(CHECKOUT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_unknown_cell_fails():
    with pytest.raises(KeyError):
        from perfbench.harness import cell as C
        C.load_cell("no-such.cell")
