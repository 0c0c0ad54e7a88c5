"""Compiled step: device time of the fresh and suffix prefills in the
window (outside the profiled stretch), per 1,000 real prompt tokens they
computed (padding not counted)."""


def read(r):
    spans = r.unprofiled(r.prefill_spans)
    tok = sum(s["n"] for s in spans)
    return 1e3 * sum(r.ms(s) for s in spans) / tok if tok else None
