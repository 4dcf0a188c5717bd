"""Modules that may not be loaded in a run: JAX and the JAX package."""
from __future__ import annotations

import sys

#: top-level module names, compared whole (``repro_torch`` is the port)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded(modules=None) -> list:
    """Loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))
