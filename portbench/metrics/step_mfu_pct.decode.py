"""Model: model FLOPs of the window's decode ticks (every weight a live
slot's token multiplies, the logits, attention over each live context:
``portbench.flops.decode_flops``) over their device time at the card's
bf16 peak; ticks outside the profiled stretch."""
from portbench.flops import decode_flops


def read(r):
    spans = r.unprofiled(r.decode_spans)
    if not r.peaks or not spans:
        return None
    f = sum(decode_flops(r.cfg, s["ctx"]) for s in spans)
    t = sum(r.ms(s) for s in spans) / 1e3
    return 100.0 * f / (t * r.peaks["bf16_flops"])
