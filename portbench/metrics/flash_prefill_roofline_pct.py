"""Kernels: the least time the profiled stretch's fresh prefills need in
``flash_attention`` (one launch a layer, causal over the prompt's real
length: ``portbench.flops.flash_cost``) over the device time of the kernels
named ``flash_wgmma_kernel``."""
from portbench.flops import bound_s, flash_cost
from portbench.trace import kernel_s


def read(r):
    spans = [s for s in r.prefill_spans if s["prof"] and s["kind"] == "fresh"]
    t = kernel_s(r, "flash_wgmma_kernel")
    if not r.peaks or not spans or t is None:
        return None
    need = sum(bound_s(flash_cost(r.cfg, s["n"]), r.peaks)
               for s in spans) * r.cfg.n_layers
    return 100.0 * need / t
