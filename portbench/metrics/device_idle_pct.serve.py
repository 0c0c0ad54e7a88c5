"""Device: share of the profiled stretch in which no kernel, copy or set
ran on the card (the union of the profiler's device intervals)."""


def read(r):
    if not r.trace_out or r.trace_out["busy_s"] <= 0:
        return None
    return 100.0 * (1 - r.trace_out["busy_s"] / r.trace_out["window_s"])
