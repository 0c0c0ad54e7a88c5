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
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rglru_scan_ref

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
             + [ctypes.c_void_p])
TILE = 128                     # channels of one chain (kTile in the source)

# The kernel's status scratch, per device: int32 tickets, arrival counters
# and chunk flags, zeroed once when allocated (or grown) and left zero by
# every launch; fp32 published carries, always written before they are
# read.  Calls on one device must therefore be serialised, as they are on
# its current stream.
_STATUS = {}


def scan_status(device, chains: int, n: int):
    """(ints, vals) for a launch of ``chains`` chains of n chunks."""
    ints, vals = _STATUS.get(device, (None, None))
    if ints is None or ints.numel() < chains * (n + 2):
        ints = _build.grow_scratch(
            ints, lambda: torch.zeros((chains * (n + 2),),
                                      dtype=torch.int32, device=device),
            "rglru_scan status flags")
    if vals is None or vals.numel() < chains * n * 3 * TILE:
        vals = _build.grow_scratch(
            vals, lambda: torch.empty((chains * n * 3 * TILE,),
                                      dtype=torch.float32, device=device),
            "rglru_scan carries")
    _STATUS[device] = (ints, vals)
    return ints, vals


def effective_chunks(S: int, n: int) -> int:
    """The chunk count the kernel runs for a requested n: ceil(S / L) with
    L = ceil(S / n), between 1 and S."""
    n = min(max(n, 1), S)
    L = -(-S // n)
    return -(-S // L)


@functools.lru_cache(maxsize=None)
def chunk_count(B: int, S: int, d: int, dtype: int, device) -> int:
    """How many chunks split each (row, 128-channel tile)'s S steps:
    chosen on the C side (``rglru_chunk_count``) from B·ceil(d/128) and
    ``device``'s SM count.  Cached: one library call per argument set."""
    fn = _build.function("rglru_scan", "rglru_chunk_count",
                         [ctypes.c_int] * 5)
    n = fn(B, S, d, dtype, device.index)
    _build.check(max(-n, 0), "rglru_scan chunk count")
    return n


def rglru_scan(a, b, h0):
    """a, b: (B,S,d); h0: (B,d) -> h: (B,S,d).  ``rglru_scan.launches``
    counts the kernel launches (CPU calls are not counted).

    On CUDA one launch scans all chunks of every (row, channel tile) with
    a decoupled look-back through the per-device status scratch; per call
    the wrapper adds no library call and no zeroing launch.
    ``rglru_scan.force_chunks`` (None: the cached count) sets the chunk
    count, for tests."""
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on cpu or cuda, not {a.device}")
    _build.refuse_grad("rglru_scan", a, b, h0)
    B, S, d = a.shape
    if b.shape != a.shape or h0.shape != (B, d):
        raise ValueError(f"rglru_scan shapes: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, h0 {tuple(h0.shape)}")
    if b.dtype != a.dtype:
        raise TypeError("a and b must share one dtype")
    if b.device != a.device or h0.device != a.device:
        raise ValueError("rglru_scan operands must share one device")
    code = _build.dtype_code(a.dtype)
    a, b = _build.aligned(a), _build.aligned(b)
    h0 = h0.to(torch.float32).contiguous()
    h = torch.empty_like(a)
    n = effective_chunks(S, rglru_scan.force_chunks
                         or chunk_count(B, S, d, code, a.device)) if S else 1
    ints, vals = scan_status(a.device, B * -(-d // TILE), n)
    fn = _build.function("rglru_scan", "rglru_scan_launch", _ARGTYPES)
    err = fn(a.data_ptr(), b.data_ptr(), h0.data_ptr(), h.data_ptr(),
             ints.data_ptr(), vals.data_ptr(), B, S, d, n, code,
             _build.stream_of(a))
    _build.check(err, "rglru_scan")
    rglru_scan.launches += 1
    return h


rglru_scan.launches = 0
rglru_scan.force_chunks = None
