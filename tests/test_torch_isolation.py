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

# imports every port module and chip_smoke.py in a fresh interpreter,
# records what got loaded, then runs chip_smoke's main (no card here)
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
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
out = io.StringIO()
with contextlib.redirect_stdout(out):
    rc = chip_smoke.main([])
print(json.dumps({"modules": len(names), "bad": bad, "rc": rc,
                  "stdout": out.getvalue()}))
"""


@pytest.fixture(scope="module")
def probe():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", PROBE,
                        str(ROOT / "chip_smoke.py")], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_port_and_chip_smoke_import_neither_jax_nor_repro(probe):
    assert probe["modules"] >= 20     # every module of the package loaded
    assert probe["bad"] == []


def test_chip_smoke_fails_without_card(probe):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the test is for one without")
    assert probe["rc"] != 0
    assert '"ok": true' not in probe["stdout"]


def _entry_points():
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.core import machine
    from repro_torch.core.tuner import ComParTuner
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.examples import quickstart, serve_batched
    from repro_torch.launch.serve import default_plan, serve
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
    plan = default_plan(cfg)
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
