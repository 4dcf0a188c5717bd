"""Kernels launched per training step: kernel events in the device trace
(no copies or sets) over the traced steps."""


def read(r):
    t = r.get("trace")
    if not t or not r.get("steps"):
        return None
    return sum(c for c, _ in t["kernels"].values()) / r["steps"]
