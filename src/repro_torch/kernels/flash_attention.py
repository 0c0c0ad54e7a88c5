"""Causal / sliding-window GQA flash attention (CUDA C++ kernels
``csrc/flash_attention.cu``): the prefill attention.

The port of the TPU kernel ``repro.kernels.flash_attention.
flash_attention``, with the same layouts: q (B,H,S,dh); k/v (B,KVH,S,dh);
out (B,H,S,dh).  Unlike the TPU kernel, any S is taken (the kernel masks
the ragged tail); dh is a multiple of 8 up to 256.

A CPU tensor runs the plain version (``ref.flash_attention_ref``); a CUDA
tensor launches a kernel or raises.  On CUDA the storage type picks the
kernel.  bf16 runs Hopper's warpgroup products (``wgmma``) on tiles that
the Tensor Memory Accelerator loads through tensor maps; those maps carry
the operands' strides, so q, k and v are read where they lie (the
transposed views of a (B,S,heads,dh) projection included) and out is an
``empty_like`` of q's view.  fp32 runs ``mma.sync`` as 3xTF32 (each
operand split into a TF32 big and small part, each product taken as
small·big + big·small + big·big, which keeps fp32 accuracy where one TF32
product would not) over contiguous copies.  No call falls back from one
to the other.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

MAX_HEAD_DIM = 256
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_BF16_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3
                  + [ctypes.c_int] * 7 + [ctypes.c_float] + [ctypes.c_int] * 3
                  + [ctypes.c_void_p] * 3)
# per-device int32 counters of the split pairs' pieces, zeroed once and left
# zero by every launch (grown outside a CUDA graph capture)
_COUNTERS = {}
# the bf16 kernel's tiles: query rows of a tile, columns of a TMA box (128
# bytes: the swizzle's width), keys of a K/V block per head-dim bucket
QUERY_TILE = 64
BOX_COLS = 64
KEY_TILE = {64: 128, 128: 128, 256: 64}


def head_dim_bucket(dh: int) -> int:
    """The kernels' compile-time head dim at or above ``dh`` (64, 128 or
    256); the columns past dh are zeros."""
    return 64 if dh <= 64 else 128 if dh <= 128 else 256


# The bf16 kernel's CTA schedule, as ``csrc/flash_attention.cu`` computes
# it on the card (``tile_pair``, ``make_walk``): the wrapper reads it to
# choose how many pairs to split (``split_plan``), the CPU tests hold it
# to cover every admitted (query, key) pair once.
def tile_blocks(t: int, S: int, BK: int, causal: bool, window: int):
    """The KV blocks (first, last) the mask of query tile t reaches."""
    q0 = t * QUERY_TILE
    q_last = min(q0 + QUERY_TILE - 1, S - 1)
    last = q_last // BK if causal else (S - 1) // BK
    first = ((q0 - window + 1) // BK if window > 0 and q0 - window + 1 > 0
             else 0)
    return first, last


def tile_pair(p: int, nq: int, S: int, BK: int, causal: bool, window: int,
              piece: int = 0, pieces: int = 1,
              head_pairs: bool = False) -> dict:
    """Pair p's two query tiles (slot 0 may be -1; with head_pairs, tile p
    of two query heads), the blocks each reaches, the streamed blocks
    s0..s1, bo0 (the first block only slot 1 reaches), `moved` (how many
    of those warpgroup 0 takes, every other one from bo0); for piece
    `piece` of `pieces`, all clipped to that share of the stream."""
    if head_pairs:
        t = [p, p]
    elif causal and (window <= 0 or window >= S):
        t = [p, nq - 1 - p]
        if t[0] == t[1]:
            t[0] = -1
    else:
        t = [2 * p, 2 * p + 1]
        if t[1] >= nq:
            t = [-1, t[0]]
    first, last = [0, 0], [0, 0]
    first[1], last[1] = tile_blocks(t[1], S, BK, causal, window)
    if t[0] >= 0:
        first[0], last[0] = tile_blocks(t[0], S, BK, causal, window)
    else:
        first[0], last[0] = first[1], first[1] - 1
    s0, s1 = min(first), last[1]
    if pieces > 1:
        n = s1 - s0 + 1
        s0, s1 = s0 + piece * n // pieces, s0 + (piece + 1) * n // pieces - 1
        first = [max(f, s0) for f in first]
        last = [min(x, s1) for x in last]
    n0 = max(0, last[0] - first[0] + 1) if t[0] >= 0 else 0
    n1 = max(0, last[1] - first[1] + 1)
    return dict(t=t, first=first, last=last, s0=s0, s1=s1,
                bo0=max(first[1], last[0] + 1) if n0 else first[1],
                moved=(n1 - n0) // 2 if n1 > n0 else 0, n=[n0, n1])


def walk_steps(r: dict, wg: int) -> int:
    """Blocks warpgroup wg attends over in pair (or piece) r."""
    if wg == 0:
        return r["n"][0] + r["moved"]
    return r["n"][1] - r["moved"]


# a CTA's cost beyond its blocks (Q load, first K/V, epilogue), and a
# split pair's cost per piece (its partial written, read back and merged),
# in blocks: the split plan's model of a launch
CTA_BLOCKS, PIECE_BLOCKS = 1.0, 0.5


def use_head_pairs(bucket: int, g: int) -> bool:
    """Whether a CTA's two tiles are one tile of two query heads (of the
    g that share a KV head): at dh 256, where the 2-stage rings could not
    feed two warpgroups on different blocks (the other pairings' longer
    walk alternates its blocks between them) and every block streamed
    then serves both.  The 3-stage rings of the smaller buckets can, and
    the other pairings balance better there."""
    return bucket == 256 and g % 2 == 0


def pair_count(S: int, head_pairs: bool) -> int:
    """Pairs of one head (or head pair): the grid's second dimension,
    before splits."""
    nq = -(-S // QUERY_TILE)
    return nq if head_pairs else -(-nq // 2)


@functools.lru_cache(maxsize=None)
def split_plan(ctas: int, S: int, BK: int, causal: bool, window: int,
               head_pairs: bool, n_sm: int):
    """(split, pieces): the `split` longest pairs of each of the `ctas`
    heads (or head pairs) go to `pieces` CTAs each, issued first, that walk
    shares of the pair's stream and merge through device memory; the
    other pairs to one CTA each, longest first.  Chosen by a
    list-scheduling model of the launch (one CTA an SM, CTAs issued
    head-fastest in grid order onto the first free SM) for the least
    makespan: a launch whose longest CTAs outlast the rest, or with more
    pairs than SMs, otherwise ends on a partial wave.  (0, 1) when nothing
    is gained."""
    import heapq
    nq = -(-S // QUERY_TILE)
    pairs = pair_count(S, head_pairs)

    def cost(p, piece=0, pieces=1):
        r = tile_pair(p, nq, S, BK, causal, window, piece, pieces, head_pairs)
        extra = PIECE_BLOCKS * pieces if pieces > 1 else 0.0
        return max(walk_steps(r, 0), walk_steps(r, 1)) + CTA_BLOCKS + extra

    def makespan(split, pieces):
        longest = range(pairs - 1, pairs - split - 1, -1)
        order = [cost(p, k, pieces) for p in longest for k in range(pieces)]
        order += [cost(p) for p in range(pairs - split - 1, -1, -1)]
        free = [0.0] * min(n_sm, len(order) * ctas)
        for c in order:
            for _ in range(ctas):
                heapq.heappush(free, heapq.heappop(free) + c)
        return max(free)

    best = (makespan(0, 1), 0, 1)
    for pieces in (2, 3, 4):
        for split in range(1, pairs + 1):
            if (split * (pieces - 1) + pairs) * ctas > 4 * n_sm:
                break
            best = min(best, (makespan(split, pieces), split, pieces))
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _counters(device, n: int):
    """At least n zeroed int32 counters on device (see ``_COUNTERS``)."""
    counters = _COUNTERS.get(device)
    if counters is None or counters.numel() < n:
        counters = _build.grow_scratch(
            counters, lambda: torch.zeros((n,), dtype=torch.int32,
                                          device=device),
            "flash_attention split counters")
        _COUNTERS[device] = counters
    return counters


def tma_geometry(t, rows: int):
    """The tensor map through which the bf16 kernel loads the (B, N, S,
    dh) view ``t`` in boxes of ``rows`` rows × 64 columns: (dims innermost
    first, (dh, S, N, B); the byte strides of S, N and B; the box, (64,
    rows, 1, 1)).  A dimension of size 1 takes the packed stride (it is
    never stepped).  Raises ValueError unless dh is contiguous and the
    other strides and the data address are multiples of 16 bytes, as the
    Tensor Memory Accelerator requires: such a view is not copied."""
    B, N, S, dh = t.shape
    esz = t.element_size()
    if dh > 1 and t.stride(3) != 1:
        raise ValueError(f"flash_attention: the head dim of a "
                         f"{tuple(t.shape)} view with strides {t.stride()} "
                         f"is not contiguous")
    packed = (dh * esz, S * dh * esz, N * S * dh * esz)
    strides = []
    for name, size, stride, pk in zip(("S", "heads", "B"), (S, N, B),
                                      (t.stride(2), t.stride(1),
                                       t.stride(0)), packed):
        nbytes = stride * esz if size > 1 else pk
        if nbytes % 16:
            raise ValueError(
                f"flash_attention: the {name} stride of a {tuple(t.shape)} "
                f"view is {nbytes} bytes, not a multiple of 16 (strides "
                f"{t.stride()})")
        strides.append(nbytes)
    if t.data_ptr() % 16:
        raise ValueError(f"flash_attention: a {tuple(t.shape)} view starts "
                         f"at an address that is not 16-byte aligned")
    return (dh, S, N, B), tuple(strides), (BOX_COLS, rows, 1, 1)


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """q: (B,H,S,dh), k/v: (B,KVH,S,dh) -> (B,H,S,dh), bf16 on CUDA with
    q's strides.  ``flash_attention.launches`` counts the kernel launches
    of both storage types (CPU calls are not counted)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    _build.refuse_grad("flash_attention", q, k, v)
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
    scale = 1.0 / math.sqrt(dh)
    if code == 1:
        bucket = head_dim_bucket(dh)
        rows = KEY_TILE[bucket]
        geo = [x for t, r in ((q, QUERY_TILE), (k, rows), (v, rows))
               for part in tma_geometry(t, r) for x in part]
        out = torch.empty_like(q)
        head_pairs = use_head_pairs(bucket, H // KVH)
        ctas = B * H // 2 if head_pairs else B * H
        split, pieces = split_plan(ctas, S, rows, bool(causal), window or 0,
                                   head_pairs, _sm_count(q.device))
        ws = counters = None
        if split:
            ws = torch.empty((ctas * split * pieces * 2 * (bucket // 2 + 4)
                              * 128,), dtype=torch.float32, device=q.device)
            counters = _counters(q.device, ctas * split)
        fn = _build.function("flash_attention", "flash_attention_bf16_launch",
                             _BF16_ARGTYPES)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 (ctypes.c_ulonglong * len(geo))(*geo), out.stride(0),
                 out.stride(1), out.stride(2), B, H, KVH, S, dh, int(causal),
                 window or 0, scale, int(head_pairs), split, pieces,
                 ws.data_ptr() if split else None,
                 counters.data_ptr() if split else None,
                 _build.stream_of(q))
    else:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out = torch.empty_like(q)
        fn = _build.function("flash_attention", "flash_attention_launch",
                             _ARGTYPES)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                 H, KVH, S, dh, int(causal), window or 0, scale, code,
                 _build.stream_of(q))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
