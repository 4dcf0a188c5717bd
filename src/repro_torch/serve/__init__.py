"""Serving: prefill/decode step factories and the continuous-batching
engine, under a ComParX plan."""
from repro_torch.serve.engine import (  # noqa: F401
    Completion, Request, ServeEngine, ServeStats,
)
from repro_torch.serve.step import (  # noqa: F401
    make_decode_step, make_prefill, make_prefill_cache,
)
