"""Causal / sliding-window GQA flash attention (CUDA C++ kernel
``csrc/flash_attention.cu``): the prefill attention.

The port of the TPU kernel ``repro.kernels.flash_attention.
flash_attention``, with the same layouts: q (B,H,S,dh); k/v (B,KVH,S,dh);
out (B,H,S,dh).  Unlike the TPU kernel, any S is taken (the kernel masks
the ragged tail); dh is a multiple of 8 up to 256.

A CPU tensor runs the plain version (``ref.flash_attention_ref``); a CUDA
tensor launches the kernel or raises.  On CUDA the storage type picks the
kernel: bf16 runs on the tensor cores (``mma.sync``), fp32 on the CUDA
cores (a tensor-core product in fp32 would be TF32, short of the fp32
tolerance).  No call falls back from one to the other.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

MAX_HEAD_DIM = 256
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """q: (B,H,S,dh), k/v: (B,KVH,S,dh) -> (B,H,S,dh).
    ``flash_attention.launches`` counts the kernel launches of both
    variants (CPU calls are not counted)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    B, H, S, dh = q.shape
    KVH = k.shape[1]
    if (k.shape != (B, KVH, S, dh) or v.shape != k.shape or H % KVH
            or dh % 8 or dh > MAX_HEAD_DIM):
        raise ValueError(f"flash_attention shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} (dh a "
                         f"multiple of 8 up to {MAX_HEAD_DIM})")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention operands must share one device")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    code = _build.dtype_code(q.dtype)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    fn = _build.function("flash_attention", "flash_attention_launch",
                         _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
             KVH, S, dh, int(causal), window or 0, 1.0 / math.sqrt(dh), code,
             _build.stream_of(q))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
