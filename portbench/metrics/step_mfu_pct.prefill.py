"""Model: model FLOPs of the window's fresh and suffix prefills at their
real lengths (``portbench.flops.prefill_flops``) over their device time at
the card's bf16 peak; prefills outside the profiled stretch."""
from portbench.flops import prefill_flops


def read(r):
    spans = r.unprofiled(r.prefill_spans)
    if not r.peaks or not spans:
        return None
    f = sum(prefill_flops(r.cfg, s["n"], s["start"]) for s in spans)
    t = sum(r.ms(s) for s in spans) / 1e3
    return 100.0 * f / (t * r.peaks["bf16_flops"])
