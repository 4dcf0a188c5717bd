"""Share of the sweeps' wall time spent inside the executor's
``score_segment`` (building, warming and timing each program), %."""


def read(r):
    s = r.get("spans_host_s", {})
    if not s.get("sweep"):
        return None
    return 100.0 * s.get("score_segment", 0.0) / s["sweep"]
