"""Single-token decode attention against a striped ring KV cache (CUDA C++
kernel ``csrc/decode_attention.cu``): every attention layer of the
striped decode step.

The port of the TPU kernel ``repro.kernels.decode_attention.
decode_attention``, with the same layouts: q (B,H,dh); k/v (B,W,KVH,dh);
spos (B,W) int32 stored positions (-1 = empty); pos (B,) int32 current
positions.  Unlike the TPU kernel, any W is taken; dh is a multiple of 8
up to 256.  Appending the new token into the ring is the caller's work
(``models.layers.decode_attention``), as in the JAX package.

A CPU tensor runs the plain version (``ref.decode_attention_ref``); a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import decode_arrivals
from repro_torch.kernels.ref import decode_attention_ref

MAX_HEAD_DIM = 256
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def decode_attention(q, k, v, spos, pos, *, window=None):
    """q: (B,H,dh), k/v: (B,W,KVH,dh), spos: (B,W), pos: (B,) -> (B,H,dh).
    One launch: the ring is split over CTAs that merge in the same launch
    through the decode kernels' shared arrival counters
    (``paged_attention.decode_arrivals``; calls on one device must be
    serialised, as they are on its current stream).
    ``decode_attention.launches`` counts the kernel launches (CPU calls
    are not counted)."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, spos, pos, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu or cuda, not "
                         f"{q.device}")
    B, H, dh = q.shape
    _, W, KVH, _ = k.shape
    if (k.shape != (B, W, KVH, dh) or v.shape != k.shape or H % KVH
            or spos.shape != (B, W) or pos.shape != (B,)):
        raise ValueError(
            f"decode_attention shapes: q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, spos "
            f"{tuple(spos.shape)}, pos {tuple(pos.shape)}")
    if dh % 8 or dh > MAX_HEAD_DIM:
        raise ValueError(f"the decode kernel takes dh a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}, not {dh}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if any(t.device != q.device for t in (k, v, spos, pos)):
        raise ValueError("decode_attention operands must share one device")
    code = _build.dtype_code(q.dtype)
    q, k, v = map(_build.aligned, (q, k, v))
    spos = spos.to(torch.int32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    g = H // KVH
    splits = _build.n_split("decode_attention", B * KVH, W, g, dh, code,
                            q.device)
    part = torch.empty((B * KVH * splits * g * (dh + 2),),
                       dtype=torch.float32, device=q.device)
    arrived = decode_arrivals(q.device, B, KVH, g)
    fn = _build.function("decode_attention", "decode_attention_launch",
                         _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), spos.data_ptr(),
             pos.data_ptr(), out.data_ptr(), part.data_ptr(),
             arrived.data_ptr(), B, H, KVH, dh, W, window or 0, splits,
             1.0 / math.sqrt(dh), code, _build.stream_of(q))
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
