"""Every token the engine generated in the window (by the device completion
of the step that produced it), over the window's seconds."""


def read(r):
    n = sum(1 for rec in r.recs for t in r.token_times(rec)
            if t is not None and 0 <= t <= r.seconds)
    return n / r.seconds
