"""Paged decode attention (CUDA C++ kernels ``csrc/paged_decode_step.cu``):
the fused decode step, which appends the new token's K/V and attends over
the slot's pages in one launch, and its read-only form.

The ports of the TPU kernels ``repro.kernels.paged_attention.
paged_decode_step`` and ``paged_decode_attention``, with the same layouts:
q (B,H,dh); k_new/v_new (B,KVH,dh); k/v pools (P,ps,KVH,dh) whose last
page P-1 is the trash page; page_table (B,MP) int32 (-1 = unallocated);
lens (B,) int32, for the step token counts INCLUDING the new token, for
the read-only form live token counts.  The step updates the pools in
place.

A CPU tensor runs the plain version (``ref.paged_decode_step_ref``,
``ref.paged_decode_attention_ref``); a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (paged_decode_attention_ref,
                                     paged_decode_step_ref)

MAX_HEAD_DIM = 256
_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_ATTN_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
# query heads of one row tile of the decode walks (kRows in
# csrc/decode_attend.cuh)
_ROWS = 16

# The decode kernels' int32 arrival counters, per device, shared by all
# three entry points (this module's two and ``decode_attention``): one per
# (slot, KV head, row tile), zeroed once when allocated (or grown), and
# left zero by every launch.  Calls on one device must therefore be
# serialised, as they are on its current stream.  A grown buffer replaces
# the old one for later launches, and the old one is kept alive
# (``_build.grow_scratch``): engines of different sizes on one device each
# capture their decode graph on the buffer current at that time.
_ARRIVALS = {}


def decode_arrivals(device, B: int, KVH: int, g: int):
    """The counters for a launch over B slots of KVH KV heads with g query
    heads each."""
    pairs = B * KVH * -(-g // _ROWS)
    arrived = _ARRIVALS.get(device)
    if arrived is None or arrived.numel() < pairs:
        arrived = _build.grow_scratch(
            arrived, lambda: torch.zeros((pairs,), dtype=torch.int32,
                                         device=device),
            "decode arrival counters")
        _ARRIVALS[device] = arrived
    return arrived


def _splits_and_scratch(B, KVH, g, dh, n_tokens, code, device, extra=0):
    """(n_split, fp32 partials) of one paged launch: n_split + ``extra``
    entries a (slot, KV head) (the step's new token is one more)."""
    splits = _build.n_split("paged_decode_step", B * KVH, n_tokens, g, dh,
                            code, device)
    part = torch.empty((B * KVH * (splits + extra) * g * (dh + 2),),
                       dtype=torch.float32, device=device)
    return splits, part


def paged_decode_step(q, k_new, v_new, k_pages, v_pages, page_table, lens,
                      *, window=None):
    """Returns (out (B,H,dh), k_pages, v_pages); the pools are the caller's
    tensors, written in place.  ``paged_decode_step.launches`` counts the
    kernel launches (CPU calls are not counted).

    On CUDA each (slot, KV head) walk is split over n_split CTAs that merge
    in the same launch through a per-device buffer of arrival counters.
    Per call the wrapper adds no library call and no zeroing launch: the
    split count is cached per shape and device (``_build.n_split``), the
    counters are allocated and zeroed once per device (``_ARRIVALS``,
    grown when needed) and every launch leaves them zero, and the fp32
    partials come from the caching allocator.  Calls on one device must
    therefore be serialised, as they are on its current stream."""
    if q.device.type == "cpu":
        return paged_decode_step_ref(q, k_new, v_new, k_pages, v_pages,
                                     page_table, lens, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_step runs on cpu or cuda, not "
                         f"{q.device}")
    _build.refuse_grad("paged_decode_step", q, k_new, v_new, k_pages,
                       v_pages)
    B, H, dh = q.shape
    P, ps, KVH, dh_p = k_pages.shape
    MP = page_table.shape[-1]
    if (dh_p != dh or H % KVH or k_new.shape != (B, KVH, dh)
            or v_new.shape != k_new.shape or v_pages.shape != k_pages.shape
            or page_table.shape != (B, MP) or lens.shape != (B,)):
        raise ValueError(
            f"paged_decode_step shapes: q {tuple(q.shape)}, k_new "
            f"{tuple(k_new.shape)}, pools {tuple(k_pages.shape)}, table "
            f"{tuple(page_table.shape)}, lens {tuple(lens.shape)}")
    if dh % 8 or dh > MAX_HEAD_DIM:
        raise ValueError(f"the decode-step kernel takes dh a multiple of 8 "
                         f"up to {MAX_HEAD_DIM}, not {dh}")
    if q.dtype != k_pages.dtype or v_pages.dtype != k_pages.dtype:
        raise TypeError("q and both pools must share one dtype")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("the pools are written in place and must be "
                         "contiguous")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    tensors = (q, k_new, v_new, k_pages, v_pages, page_table, lens)
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_decode_step operands must share one device")
    code = _build.dtype_code(q.dtype)
    q = _build.aligned(q)
    k_new = _build.aligned(k_new.to(k_pages.dtype))
    v_new = _build.aligned(v_new.to(k_pages.dtype))
    table = page_table.to(torch.int32).contiguous()
    lens = lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    splits, part = _splits_and_scratch(B, KVH, H // KVH, dh, MP * ps, code,
                                       q.device, extra=1)
    arrived = decode_arrivals(q.device, B, KVH, H // KVH)
    fn = _build.function("paged_decode_step", "paged_decode_step_launch",
                         _ARGTYPES)
    err = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
             k_pages.data_ptr(), v_pages.data_ptr(), table.data_ptr(),
             lens.data_ptr(), out.data_ptr(), part.data_ptr(),
             arrived.data_ptr(), B, H, KVH, dh, P, ps, MP, window or 0,
             splits, 1.0 / math.sqrt(dh), code, _build.stream_of(q))
    _build.check(err, "paged_decode_step")
    paged_decode_step.launches += 1
    return out, k_pages, v_pages


paged_decode_step.launches = 0


def paged_decode_attention(q, k_pages, v_pages, page_table, lens, *,
                           window=None):
    """Read-only paged attention over each slot's ``lens`` live tokens ->
    (B,H,dh); the window is measured from position lens-1.  A row with
    lens == 0 is the uniform mean of V over all MP·ps table entries, as
    the TPU kernel and the plain version give.  One launch, split and
    merged as the step's (the same counters).
    ``paged_decode_attention.launches`` counts the kernel launches (CPU
    calls are not counted)."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, page_table,
                                          lens, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cpu or cuda, not "
                         f"{q.device}")
    _build.refuse_grad("paged_decode_attention", q, k_pages, v_pages)
    B, H, dh = q.shape
    P, ps, KVH, dh_p = k_pages.shape
    MP = page_table.shape[-1]
    if (dh_p != dh or H % KVH or v_pages.shape != k_pages.shape
            or page_table.shape != (B, MP) or lens.shape != (B,)):
        raise ValueError(
            f"paged_decode_attention shapes: q {tuple(q.shape)}, pools "
            f"{tuple(k_pages.shape)}, table {tuple(page_table.shape)}, "
            f"lens {tuple(lens.shape)}")
    if dh % 8 or dh > MAX_HEAD_DIM:
        raise ValueError(f"the paged kernel takes dh a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}, not {dh}")
    if q.dtype != k_pages.dtype or v_pages.dtype != k_pages.dtype:
        raise TypeError("q and both pools must share one dtype")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if any(t.device != q.device for t in (k_pages, v_pages, page_table,
                                          lens)):
        raise ValueError("paged_decode_attention operands must share one "
                         "device")
    code = _build.dtype_code(q.dtype)
    q = _build.aligned(q)
    k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    table = page_table.to(torch.int32).contiguous()
    lens = lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    splits, part = _splits_and_scratch(B, KVH, H // KVH, dh, MP * ps, code,
                                       q.device)
    arrived = decode_arrivals(q.device, B, KVH, H // KVH)
    fn = _build.function("paged_decode_step", "paged_decode_attention_launch",
                         _ATTN_ARGTYPES)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             table.data_ptr(), lens.data_ptr(), out.data_ptr(),
             part.data_ptr(), arrived.data_ptr(), B, H, KVH, dh, P, ps, MP,
             window or 0, splits,
             1.0 / math.sqrt(dh), code, _build.stream_of(q))
    _build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
