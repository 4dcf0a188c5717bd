"""The port stands alone: importing it loads neither JAX nor the reference
package, and its entry points refuse a missing card instead of running on
the CPU behind the caller's back."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

# imports every port module, chip_smoke.py and tools/backends_timing.py in a
# fresh interpreter, records what got loaded, then runs both scripts' main
# (no card here)
PROBE = r"""
import contextlib, importlib, importlib.util, io, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
chip_smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(chip_smoke)
spec = importlib.util.spec_from_file_location("backends_timing", sys.argv[2])
timing = importlib.util.module_from_spec(spec)
spec.loader.exec_module(timing)
with contextlib.redirect_stderr(io.StringIO()):
    timing_rc = timing.main(["--part", "tile"])
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
out = io.StringIO()
with contextlib.redirect_stdout(out):
    rc = chip_smoke.main([])
print(json.dumps({"modules": len(names), "names": names, "bad": bad,
                  "rc": rc, "stdout": out.getvalue(),
                  "timing_rc": timing_rc}))
"""


@pytest.fixture(scope="module")
def probe():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", PROBE,
                        str(ROOT / "chip_smoke.py"),
                        str(ROOT / "tools" / "backends_timing.py")], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_port_and_chip_smoke_import_neither_jax_nor_repro(probe):
    assert probe["modules"] >= 20     # every module of the package loaded
    assert probe["bad"] == []


def test_probe_covers_the_backends_and_examples(probe):
    assert {f"repro_torch.core.backends.{m}" for m in
            ("process", "remote", "server", "fallback", "faults")} | \
        {f"repro_torch.examples.{m}" for m in
         ("compar_sweep_json", "train_e2e")} <= set(probe["names"])


def test_probe_covers_the_mesh_modules(probe):
    """The meshes and sharding rules import ``torch.distributed`` (allowed)
    and neither jax nor the reference package."""
    assert {"repro_torch.runtime.sharding", "repro_torch.core.meshspec",
            "repro_torch.launch.mesh"} <= set(probe["names"])
    assert probe["bad"] == []


def test_chip_smoke_fails_without_card(probe):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the test is for one without")
    assert probe["rc"] != 0
    assert '"ok": true' not in probe["stdout"]


def test_timing_tool_fails_without_card(probe):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the test is for one without")
    assert probe["timing_rc"] != 0


def _entry_points():
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.core import machine
    from repro_torch.core.tuner import ComParTuner
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.examples import (compar_sweep_json, quickstart,
                                      serve_batched, train_e2e)
    from repro_torch.launch.dryrun import default_plan
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import train
    from repro_torch.models.model import init_cache, model_specs
    from repro_torch.models.params import init_params
    from repro_torch.serve import registry
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.step import (make_decode_step, make_prefill,
                                        make_prefill_cache)
    from repro_torch.train.step import (init_train_state, make_grads,
                                        make_train_step)
    cfg = get_arch("granite-8b").smoke()
    plan = default_plan(cfg, get_shape("decode_32k").smoke())
    return {
        "ServeEngine": lambda: ServeEngine(cfg, plan),
        "make_prefill": lambda: make_prefill(cfg, plan),
        "make_prefill_cache": lambda: make_prefill_cache(cfg, plan),
        "make_decode_step": lambda: make_decode_step(cfg, plan),
        "init_params": lambda: init_params(model_specs(cfg),
                                           torch.Generator()),
        "init_cache": lambda: init_cache(cfg, 1, 8),
        "launch.serve": lambda: serve(["--arch", "granite-8b", "--smoke"]),
        "make_train_step": lambda: make_train_step(cfg, plan),
        "make_grads": lambda: make_grads(cfg, plan),
        "init_train_state": lambda: init_train_state(cfg, plan,
                                                     torch.Generator()),
        "SyntheticLM": lambda: SyntheticLM(cfg,
                                           get_shape("train_4k").smoke()),
        "launch.train": lambda: train(["--arch", "granite-8b", "--smoke"]),
        "ComParTuner": lambda: ComParTuner(cfg,
                                           get_shape("train_4k").smoke()),
        "examples.quickstart": lambda: quickstart.main(["--smoke"]),
        "examples.serve_batched": lambda: serve_batched.main([]),
        "examples.compar_sweep_json": lambda: compar_sweep_json.main([]),
        "examples.compar_sweep_json --backend process":
            lambda: compar_sweep_json.main(["--backend", "process"]),
        "examples.train_e2e": lambda: train_e2e.main(["--steps", "2"]),
        "core.machine": lambda: machine.main(["--tiny"]),
        "serve.registry": lambda: registry.main(["--db", ":memory:",
                                                 "--smoke"]),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_cuda_and_raise_without_it(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the test is for one without")
    with pytest.raises(RuntimeError, match="cuda"):
        _entry_points()[name]()
