"""One AdamW update: CUDA events around ``adamw_update``, mean over the
traced steps, ms."""


def read(r):
    ms = r.get("spans_ms", {}).get("adamw")
    return sum(ms) / len(ms) if ms else None
