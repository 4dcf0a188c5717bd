import os

# Smoke tests and benches must see ONE device; only launch/dryrun.py forces
# 512 placeholder devices (and only in its own process).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where there is none")
