"""RG-LRU linear recurrence h_t = a_t ⊙ h_{t-1} + b_t (CUDA C++ kernel
``csrc/rglru_scan.cu``): the prefill scan of every recurrent layer.

The port of the TPU kernel ``repro.kernels.rglru_scan.rglru_scan``, with
the same layouts: a, b (B,S,d) in fp32 or bf16 (one type for both); h0
(B,d), carried in fp32; h (B,S,d) returned in a's dtype.  Unlike the TPU
kernel, any S is taken.

A CPU tensor runs the plain version (``ref.rglru_scan_ref``); a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rglru_scan_ref

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
             + [ctypes.c_void_p])


def rglru_scan(a, b, h0):
    """a, b: (B,S,d); h0: (B,d) -> h: (B,S,d).  ``rglru_scan.launches``
    counts the kernel launches (CPU calls are not counted)."""
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on cpu or cuda, not {a.device}")
    B, S, d = a.shape
    if b.shape != a.shape or h0.shape != (B, d):
        raise ValueError(f"rglru_scan shapes: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, h0 {tuple(h0.shape)}")
    if b.dtype != a.dtype:
        raise TypeError("a and b must share one dtype")
    if b.device != a.device or h0.device != a.device:
        raise ValueError("rglru_scan operands must share one device")
    code = _build.dtype_code(a.dtype)
    a, b = a.contiguous(), b.contiguous()
    h0 = h0.to(torch.float32).contiguous()
    h = torch.empty_like(a)
    fn = _build.function("rglru_scan", "rglru_scan_launch", _ARGTYPES)
    err = fn(a.data_ptr(), b.data_ptr(), h0.data_ptr(), h.data_ptr(), B, S,
             d, code, _build.stream_of(a))
    _build.check(err, "rglru_scan")
    rglru_scan.launches += 1
    return h


rglru_scan.launches = 0
