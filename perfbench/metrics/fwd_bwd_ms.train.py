"""Forward and backward of a train step: CUDA events around the gradient
call (``make_grads``'s ``grads_of``), mean over the traced steps, ms."""


def read(r):
    ms = r.get("spans_ms", {}).get("fwd_bwd")
    return sum(ms) / len(ms) if ms else None
