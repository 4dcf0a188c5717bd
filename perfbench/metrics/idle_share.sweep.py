"""Share of the traced sweep window in which no device operation ran
(torch.profiler's device events), %."""


def read(r):
    t = r.get("trace")
    return 100.0 * (1 - t["busy_s"] / t["window_s"]) if t else None
