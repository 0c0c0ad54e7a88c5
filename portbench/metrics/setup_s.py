"""Process start to the window's opening: CUDA's start, weights, engine,
warm-up of the cell's buckets, the tenants' system prompts and the
traffic's lead-in.  The kernels' build, which a checkout's first run pays,
is left out and reported apart (``run.phases["kernels"]``)."""


def read(r):
    return r.setup_s
