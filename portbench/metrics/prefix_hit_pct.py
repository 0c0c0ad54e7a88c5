"""Engine and scheduler: prompt tokens served from the prefix cache, over
the prompt tokens admitted in the window (the scheduler's shared_tokens
and prefill_tokens)."""


def read(r):
    shared = r.stats_close["shared_tokens"] - r.stats_open["shared_tokens"]
    fresh = r.stats_close["prefill_tokens"] - r.stats_open["prefill_tokens"]
    return 100.0 * shared / (shared + fresh) if shared + fresh else None
