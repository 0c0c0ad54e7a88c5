"""95th percentile of time to first token over every request due in the
window: from its due time to the device completion of its first token.  A
request with no first token by the window's end counts the time it has
waited so far; a request that failed counts as waiting the whole rest of
the window."""
from portbench.stats import percentile


def read(r):
    ttft = []
    for rec in r.window_recs():
        due = rec.req.due if rec.req.due is not None else rec.submit_t
        times = r.token_times(rec)
        first = times[0] if times and times[0] is not None else None
        if first is None or first > r.seconds:
            first = r.seconds
        ttft.append(first - due)
    return percentile(ttft, 95) * 1e3 if ttft else None
