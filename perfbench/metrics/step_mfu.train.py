"""The whole step's share of the card's bf16 dense peak: model FLOPs of
a step (``work.train_step_flops``: no recomputation) over the mean
CUDA-event time of a traced step, %."""
from perfbench.harness import work


def read(r):
    ms = r.get("spans_ms", {}).get("step")
    if not ms:
        return None
    step_s = sum(ms) / len(ms) / 1e3
    flops = work.train_step_flops(r["arch"], r["batch"], r["seq"])
    return 100.0 * flops / step_s / work.PEAK_OPS_S[r["arch"]["dtype"]]
