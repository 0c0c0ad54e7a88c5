"""Paged-decode autotuner: sweep the page size per model config, cache
the winner on disk.

The port of ``repro.kernels.autotune``.  The paged fast path has a free
geometry knob the model itself does not fix: the allocator's page size
(granularity of KV residency AND of the fused step's page walk).  The
best choice depends on head counts, head dim, slot count and device — so
it is *measured*, not guessed: for each candidate the tuner times the
port's decode-step primitive (``kernels.paged_decode_step``: the CUDA
kernel on a CUDA device, its plain version on the CPU) on a synthetic
half-full pool of the requested geometry and activation dtype, and
keeps the fastest.  The JAX package also sweeps the Pallas kernel's
sub-page block edge ``block_k``; the port's kernel has none (it walks
fixed 32-token tiles), so the port sweeps page sizes only and stores
``block_k`` as None, keeping JAX's table format.  Unlike the single
Pallas body, fp32 and bf16 run different kernels on the card (3xTF32 and
bf16 products on ``mma.sync``), so the sweep times the engine's own dtype.

Results persist as a JSON table so only the FIRST engine built for a
given (config geometry, pool, impl, device kind) pays the sweep:

    location   $REPRO_AUTOTUNE_CACHE, else the shared cache layout of
               ``kernels.compile_cache``: $REPRO_CACHE_DIR (default
               ~/.cache/repro/) / autotune_<backend>.json — the device
               kind is part of the FILENAME, so tables measured on
               different device kinds never share a file
    key        schema-versioned string of every input that can change
               the winner (head/dim geometry, slots, max_len, impl,
               device kind, dtype when it is not fp32) — bumping ``_SCHEMA`` or changing any key
               component invalidates the entry, and ``force=True``
               re-measures in place.

``measure`` is injectable so tests drive the sweep deterministically
without timing anything.
"""
from __future__ import annotations

import functools
import os
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.compile_cache import (backend_kind, cache_file,
                                               load_table, store_table)

_SCHEMA = 1
DEFAULT_PAGE_SIZES = (8, 16, 32)


def cache_path(device=None) -> str:
    """Autotune table location: $REPRO_AUTOTUNE_CACHE override, else the
    device-kind-suffixed shared layout (``compile_cache.cache_file``)."""
    env = os.environ.get("REPRO_AUTOTUNE_CACHE")
    if env:
        return env
    return cache_file("autotune", device)


def autotune_key(cfg, n_slots: int, max_len: int, attn_impl: str,
                 shared: bool = False, device=None,
                 dtype: torch.dtype = torch.float32) -> str:
    """Everything that can change the sweep winner, schema-versioned.
    ``shared`` marks prefix-sharing pools: CoW sharing shifts the live
    page distribution the sweep measures (many slots walking the same
    pages), so tuned page sizes must not leak across sharing modes.  A
    dtype other than fp32 ends the key (fp32 keys stay JAX's strings)."""
    return (f"v{_SCHEMA}|{cfg.n_heads}h|{cfg.n_kv_heads}kv|"
            f"{cfg.d_head}dh|{n_slots}slots|{max_len}len|"
            f"{attn_impl}|{backend_kind(device)}"
            + ("|shared" if shared else "")
            + ("" if dtype == torch.float32
               else "|" + str(dtype).removeprefix("torch.")))


@dataclass
class TuneResult:
    page_size: int
    block_k: Optional[int]
    # full sweep: (page_size, block_k, seconds) per candidate
    table: List[Tuple[int, Optional[int], float]] = field(
        default_factory=list)


def _default_measure(cfg, n_slots: int, max_len: int, page_size: int,
                     attn_impl: str, iters: int = 3, device=None,
                     dtype: torch.dtype = torch.float32) -> float:
    """Seconds per decode-step primitive at this geometry and dtype, the
    minimum over ``iters`` timed calls after a warm-up call (the kernel's
    build and its cached split count are outside the clock).  On a CUDA
    device each timed call is one replay of a CUDA graph of the step
    between two CUDA events; on the CPU the plain version under
    ``time.perf_counter``."""
    from repro_torch.kernels import graph, paged_decode_step
    from repro_torch.models.cache_ops import pages_for

    dev = resolve_device(device)
    H, KVH, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    MP = pages_for(max_len, page_size)
    P = n_slots * MP + 1                     # + trash page
    rng = np.random.default_rng(0)
    put = lambda a: torch.from_numpy(a).to(dev, dtype)  # noqa: E731
    q = put(rng.standard_normal((n_slots, H, dh)))
    kn = put(rng.standard_normal((n_slots, KVH, dh)))
    vn = put(rng.standard_normal((n_slots, KVH, dh)))
    k = torch.zeros((P, page_size, KVH, dh), dtype=dtype, device=dev)
    v = torch.zeros_like(k)
    # staggered half-full slots, disjoint page lists
    lens_np = np.minimum(max_len // 2 + np.arange(n_slots), max_len)
    table_np = np.full((n_slots, MP), -1, np.int32)
    for s in range(n_slots):
        npg = pages_for(int(lens_np[s]), page_size)
        table_np[s, :npg] = np.arange(s * MP, s * MP + npg)
    table = torch.from_numpy(table_np).to(dev)
    lens = torch.from_numpy(lens_np.astype(np.int32)).to(dev)

    def run():
        return paged_decode_step(q, kn, vn, k, v, table, lens)[0]

    run()                                    # build + warm-up
    if dev.type != "cuda":
        best = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
        return best
    inputs = [q, kn, vn, k, v, table, lens]
    step = graph.capture(run, inputs, dev)
    best = float("inf")
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step.replay(inputs)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def autotune_paged_decode(cfg, *, n_slots: int, max_len: int,
                          attn_impl: str = "kernel",
                          page_sizes: Sequence[int] = DEFAULT_PAGE_SIZES,
                          measure: Optional[Callable] = None,
                          cache_file: Optional[str] = None,
                          force: bool = False,
                          shared: bool = False,
                          device=None,
                          dtype: torch.dtype = torch.float32) -> TuneResult:
    """Best page size for this engine geometry and activation ``dtype`` on
    ``device`` (None: the port's default device), from the disk cache
    when present (unless ``force``), measured otherwise.  ``measure(cfg,
    n_slots, max_len, page_size, attn_impl)`` returns seconds.  Without
    ``measure`` the device is resolved first (``resolve_device``): no
    device and no GPU raises before anything is keyed or timed."""
    if measure is None:
        device = resolve_device(device)
    path = cache_file or cache_path(device)
    key = autotune_key(cfg, n_slots, max_len, attn_impl, shared, device,
                       dtype)
    data = load_table(path, _SCHEMA)
    hit = data["entries"].get(key)
    if hit is not None and not force:
        return TuneResult(int(hit["page_size"]),
                          hit["block_k"],
                          [tuple(r) for r in hit.get("table", [])])
    measure = measure or functools.partial(_default_measure, device=device,
                                           dtype=dtype)
    table: List[Tuple[int, Optional[int], float]] = []
    for ps in page_sizes:
        if max_len % ps:
            continue          # keep prefill on the page-granular path
        secs = measure(cfg, n_slots, max_len, ps, attn_impl)
        table.append((ps, None, float(secs)))
    if not table:
        raise ValueError(f"no candidate page size divides max_len="
                         f"{max_len} (candidates: {tuple(page_sizes)})")
    best = min(table, key=lambda r: r[2])
    data["entries"][key] = {"page_size": best[0], "block_k": best[1],
                            "table": [list(r) for r in table]}
    store_table(path, data)
    return TuneResult(best[0], best[1], table)
