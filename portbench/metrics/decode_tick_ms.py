"""Compiled step: mean device time of the engine's decode tick (the
replayed graph), between CUDA events around each call in the window,
outside the profiled stretch."""


def read(r):
    ms = [r.ms(s) for s in r.unprofiled(r.decode_spans)]
    return sum(ms) / len(ms) if ms else None
