"""Hand-written Hopper kernels of the port, each beside its plain version.

Public wrappers: a CPU tensor runs the plain PyTorch version, a CUDA
tensor launches the kernel or raises.  Each wrapper counts its launches
in a plain integer attribute (``paged_decode_step.launches``).
"""
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mlstm_chunk import mlstm_chunkwise
from repro_torch.kernels.paged_attention import (paged_decode_attention,
                                                 paged_decode_step)
from repro_torch.kernels.rglru_scan import rglru_scan

KERNELS = (paged_decode_step, flash_attention, paged_decode_attention,
           decode_attention, rglru_scan, mlstm_chunkwise)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


__all__ = ["flash_attention", "paged_decode_step", "paged_decode_attention",
           "decode_attention", "rglru_scan", "mlstm_chunkwise", "KERNELS",
           "reset_launch_counts"]
