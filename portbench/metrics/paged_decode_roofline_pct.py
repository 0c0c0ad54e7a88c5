"""Kernels: the least time the profiled stretch's ``paged_decode_step``
launches need (one a layer a decode tick; live K/V read once, the append,
q and out: ``portbench.flops.paged_decode_cost``) over the device time of
the kernels named ``paged_decode_step_kernel``."""
from portbench.flops import bound_s, paged_decode_cost
from portbench.trace import kernel_s


def read(r):
    spans = [s for s in r.decode_spans if s["prof"]]
    t = kernel_s(r, "paged_decode_step_kernel")
    if not r.peaks or not spans or t is None:
        return None
    need = sum(bound_s(paged_decode_cost(r.cfg, s["ctx"], r.page_size),
                       r.peaks) for s in spans) * r.cfg.n_layers
    return 100.0 * need / t
