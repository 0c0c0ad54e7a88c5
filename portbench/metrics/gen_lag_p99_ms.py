"""Load generator: 99th percentile of how late the harness submitted each
request due in the window, against its due time (host clock)."""
from portbench.stats import percentile


def read(r):
    lags = [rec.submit_t - rec.req.due for rec in r.window_recs()
            if rec.req.due is not None]
    return percentile(lags, 99) * 1e3 if lags else None
