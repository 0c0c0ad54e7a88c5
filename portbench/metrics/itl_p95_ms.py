"""95th percentile over every gap between consecutive output tokens of
every request, where both tokens completed inside the window."""
from portbench.stats import percentile


def read(r):
    gaps = []
    for rec in r.recs:
        t = [x for x in r.token_times(rec)
             if x is not None and 0 <= x <= r.seconds]
        gaps += [b - a for a, b in zip(t, t[1:])]
    return percentile(gaps, 95) * 1e3 if gaps else None
