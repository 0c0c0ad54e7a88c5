"""Engine and scheduler: mean share of the slots live in a decode tick over
the window (the scheduler's decode_tokens over decode_ticks)."""


def read(r):
    ticks = r.stats_close["decode_ticks"] - r.stats_open["decode_ticks"]
    toks = r.stats_close["decode_tokens"] - r.stats_open["decode_tokens"]
    return 100.0 * toks / ticks / r.n_slots if ticks else None
