"""Unique programs each sweep built and timed (the report's
``n_scored``), mean over the window's sweeps."""


def read(r):
    sweeps = r.get("sweeps")
    return sum(s["n_scored"] for s in sweeps) / len(sweeps) if sweeps else None
