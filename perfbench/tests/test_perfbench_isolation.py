"""No module of the benchmark loads JAX or the JAX package, and the
reference loads nothing of the port: checked in fresh interpreters, by
the top-level name of every loaded module, compared whole (the port's
name, ``repro_torch``, begins with the JAX package's)."""
import ast
import json
import os
import subprocess
import sys

import perfbench_tiny
from perfbench.harness.guard import FORBIDDEN, forbidden_loaded

ROOT = perfbench_tiny.CHECKOUT / "perfbench"


def _modules(sub=""):
    """Every module file under perfbench/<sub> but the tests."""
    return sorted(p for p in (ROOT / sub).rglob("*.py")
                  if "tests" not in p.relative_to(ROOT).parts)


def _loaded_after(code: str) -> set:
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(perfbench_tiny.CHECKOUT / "src"),
                                           str(perfbench_tiny.CHECKOUT)]))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport json, sys\nprint(json.dumps(sorted({m.split('.', 1)[0] "
        "for m in sys.modules})))")], env=env, capture_output=True,
        text=True, timeout=300, cwd=str(perfbench_tiny.CHECKOUT))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _import_all(files) -> str:
    lines = ["import importlib.util, sys"]
    for i, p in enumerate(files):
        lines.append(f"s = importlib.util.spec_from_file_location('m{i}', "
                     f"{str(p)!r}); m = importlib.util.module_from_spec(s); "
                     f"sys.modules['m{i}'] = m; s.loader.exec_module(m)")
    return "\n".join(lines)


def test_every_module_and_the_program_it_drives_load_no_jax():
    # the benchmark's modules, and the port's modules its entries import
    code = _import_all(_modules()) + (
        "\nimport repro_torch.train.step, repro_torch.core.tuner, "
        "repro_torch.core.db, repro_torch.core.executor, "
        "repro_torch.core.plan, repro_torch.kernels")
    top = _loaded_after(code)
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)
    assert "repro_torch" in top and "perfbench" in top


def test_a_tiny_run_loads_no_jax():
    code = ("import sys, time\nsys.path.insert(0, 'perfbench/tests')\n"
            "import perfbench_tiny as t\n"
            "t.run(t.tiny_cell('granite-8b.train-4k'), seconds=0.05)")
    top = _loaded_after(code)
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)


def test_the_reference_imports_nothing_of_the_port():
    for p in _modules("reference"):
        for node in ast.walk(ast.parse(p.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("repro_torch",) + FORBIDDEN, \
                    (p, n)
    top = _loaded_after(_import_all(_modules("reference")))
    assert "repro_torch" not in top and not top & set(FORBIDDEN)


def test_guard_compares_whole_names():
    assert forbidden_loaded(["repro_torch.train", "jaxtyping", "os"]) == []
    assert forbidden_loaded(["repro.models", "jax.numpy", "flax"]) == \
        ["flax", "jax", "repro"]
