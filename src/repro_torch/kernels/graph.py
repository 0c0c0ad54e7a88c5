"""CUDA-graph capture of a step, with the kernels' launch counts kept true.

What stands in for ``jax.jit`` in the port: a function whose every
tensor keeps its address from one call to the next (a decode tick that
updates its cache in place) is captured once as a ``torch.cuda.CUDAGraph``
and then replayed, one launch of the whole step from the host.

Two things a plain ``CUDAGraph`` does not do, done here:
- the kernel wrappers count their launches in Python (``.launches``),
  which runs once while capturing (when nothing is launched) and never
  on a replay.  ``capture`` records how far each counter moved during the
  capture, puts the counters back, and ``CapturedStep.replay`` adds that
  delta on every replay, so a count read after a run equals the eager
  path's;
- a graph reads the addresses it was captured with.  ``replay`` takes the
  step's current input tensors and raises unless each still has its
  captured address: a stale graph never replays.  ``CapturedStep`` also
  holds a reference to every input, so none of that memory can be
  reused under it.

``StepGraphs`` holds a family of such steps keyed by shape (one per
length bucket, as ``jax.jit`` keeps one executable per static shape):
each key is captured lazily at its first use, after an eager run of the
step on a side stream (the real work of that call, and the capture's
warm-up), and every key's graph shares one memory pool.

A capture that fails raises; nothing here falls back to eager dispatch.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Any, Callable, Dict, Hashable, Iterator, List, Sequence

import torch


@contextlib.contextmanager
def launches_moved() -> Iterator[Dict[Callable, int]]:
    """Yields a dict that, on exit, maps each kernel wrapper whose launch
    counter moved inside the block to how far it moved; every counter is
    put back to its value at entry (a capture launches nothing)."""
    from repro_torch.kernels import KERNELS
    before = {fn: fn.launches for fn in KERNELS}
    moved: Dict[Callable, int] = {}
    try:
        yield moved
    finally:
        for fn, n in before.items():
            if fn.launches != n:
                moved[fn] = fn.launches - n
            fn.launches = n


class CapturedStep:
    """A captured step: ``graph`` (anything with ``replay()``), the kernel
    launches one replay makes (``launches``: wrapper -> count), the input
    tensors whose addresses the graph holds, and ``out`` (what the step
    returned while capturing: static tensors each replay rewrites).
    ``capture_s`` and ``pool_bytes`` are the capture's host time and the
    device memory its private pool reserved."""

    def __init__(self, graph, launches: Dict[Callable, int],
                 inputs: Sequence[torch.Tensor], out=None,
                 capture_s: float = 0.0, pool_bytes: int = 0):
        self.graph = graph
        self.launches = dict(launches)
        self._inputs: List[torch.Tensor] = list(inputs)
        self._ptrs = [t.data_ptr() for t in self._inputs]
        self.out = out
        self.capture_s = capture_s
        self.pool_bytes = pool_bytes
        self.replays = 0

    def check(self, inputs: Sequence[torch.Tensor]) -> None:
        """Raise unless ``inputs`` are at the captured addresses."""
        ptrs = [t.data_ptr() for t in inputs]
        if ptrs != self._ptrs:
            bad = next((i for i, (a, b) in enumerate(zip(ptrs, self._ptrs))
                        if a != b), min(len(ptrs), len(self._ptrs)))
            raise RuntimeError(
                f"stale CUDA graph: input {bad} of {len(self._ptrs)} is no "
                f"longer the tensor the graph was captured with (a cache "
                f"leaf was replaced instead of updated in place)")

    def replay(self, inputs: Sequence[torch.Tensor]) -> None:
        self.check(inputs)
        self.graph.replay()
        self.replays += 1
        for fn, n in self.launches.items():
            fn.launches += n


def warm_up(fn: Callable, device):
    """``fn()`` run eagerly on a side stream of CUDA ``device`` (the
    warm-up a capture needs: kernel builds, cached split and chunk counts,
    cuBLAS handles, per-device scratch grown to this step's size); the
    streams are joined both ways, so every launch on the device stays
    serialised (the decode kernels and the scan share per-device
    counters).  Returns what ``fn`` returned."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        out = fn()
    torch.cuda.current_stream(device).wait_stream(side)
    return out


# below this much free device memory a capture first empties the
# allocator's cache
LOW_FREE_BYTES = 8 << 30

# one capture stream a device: ``torch.cuda.graph``'s default is one
# stream for every device, and a capture for another card than the first
# then records nothing; captures of one device share theirs, so a shared
# pool can reuse the blocks an earlier capture freed (blocks keep their
# stream)
_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _capture_stream(device):
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device)
    return _STREAMS[device]


def capture(fn: Callable, inputs: Sequence[torch.Tensor],
            device, pool=None) -> CapturedStep:
    """Capture ``fn()`` on ``device`` as a CUDA graph.  Capture runs
    nothing on the device: ``fn`` must have run eagerly before (its
    warm-up: kernel builds, cached split counts, cuBLAS handles,
    per-device scratch sized for this step), and its results are the
    graph's static outputs.  ``inputs`` are the tensors the step reads
    and writes from outside (its cache and staged inputs).  ``pool`` (a
    ``torch.cuda.graph_pool_handle()``) shares a memory pool with other
    graphs that never replay concurrently; None gives the graph its own."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"a CUDA graph needs a CUDA device, not {device}")
    t0 = time.perf_counter()
    torch.cuda.synchronize(device)
    # the allocator keeps its cached blocks (``torch.cuda.graph`` empties
    # them, and the caller then pays a cudaFree of each now and a
    # cudaMalloc again later: most of a capture's cost inside a serving
    # tick) unless the card is short of free memory for the graph's pool
    if torch.cuda.mem_get_info(device)[0] < LOW_FREE_BYTES:
        torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    g = torch.cuda.CUDAGraph()
    # no garbage collection inside the capture: collecting an old graph
    # (or the last tensor of its pool) there frees device memory, an
    # unsafe call that invalidates the capture
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.device(device), launches_moved() as moved, \
                torch.cuda.stream(_capture_stream(device)):
            g.capture_begin(*(() if pool is None else (pool,)))
            try:
                out = fn()
            finally:
                g.capture_end()
    finally:
        if collecting:
            gc.enable()
    torch.cuda.synchronize(device)
    return CapturedStep(g, moved, inputs, out,
                        capture_s=time.perf_counter() - t0,
                        pool_bytes=torch.cuda.memory_reserved(device)
                        - reserved)


class StepGraphs:
    """Steps captured lazily on ``device``, one CUDA graph per key, all in
    one memory pool (``pool``, made at the first capture).

    ``run(key, body, inputs)`` runs ``body()``, a step that reads and
    writes only ``inputs`` (static buffers the caller stages in place
    before the call) and tensors that live as long as the graphs (the
    weights): a replay of ``key``'s graph when it has one; else, on a
    CUDA device, ``body`` eagerly on a side stream and then its capture
    (the first call of each key costs an eager pass plus a capture); on
    any other device, or with ``capturing=False``, ``body()`` eagerly.
    Returns what ``body`` returned: the eager result on a first call, the
    graph's static outputs on a replay.  Keys share one pool because the
    steps never replay concurrently; but a key captured later may hold
    its outputs where an earlier key's temporaries lie, so a caller reads
    (or copies) a replay's outputs before it replays another key."""

    def __init__(self, device, *, capturing: bool = True):
        self.device = torch.device(device)
        self.capturing = capturing and self.device.type == "cuda"
        self.steps: Dict[Hashable, CapturedStep] = {}
        self.pool = None

    def run(self, key: Hashable, body: Callable,
            inputs: Sequence[torch.Tensor]) -> Any:
        step = self.steps.get(key)
        if step is not None:
            step.replay(inputs)
            return step.out
        if not self.capturing:
            return body()
        out = warm_up(body, self.device)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        self.steps[key] = capture(body, inputs, self.device, pool=self.pool)
        return out

    def drop(self, key: Hashable) -> None:
        """Forget ``key``'s graph (its blocks go back to the pool)."""
        self.steps.pop(key, None)

    def __len__(self) -> int:
        return len(self.steps)
