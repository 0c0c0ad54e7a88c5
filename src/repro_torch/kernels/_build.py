"""Builds the hand-written CUDA kernels and binds them through ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``<repo>/build/repro_torch_kernels/`` — a path resolved from this file's
location, not the working directory.  The library's file name carries a
hash of its source, the shared headers (``csrc/*.cuh``) and the flags, so
an edited source or header rebuilds at its next use and an unchanged one
loads as built.  Beside each library lies nvcc's output for it
(``<library>.ptxas.txt``: ptxas's registers and spills per kernel), so a
library that was built earlier still reports them.  Nothing is built at
import time: the first CUDA call of a kernel builds it, and ``build_all``
builds every source at once (one ``nvcc`` process each, started together).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def _log_path(name: str) -> Path:
    return _lib_path(name).with_suffix(".ptxas.txt")


def ptxas_output(name: str) -> str:
    """nvcc's output (``ptxas -v``: registers, shared memory and spills of
    each kernel) for the library of ``csrc/<name>.cu`` on disk, whether it
    was built by this process or an earlier one; "" if there is none."""
    path = _log_path(name)
    return path.read_text() if path.exists() else ""


def _start(name: str):
    """Start nvcc for ``name`` into a temporary file; returns (proc, tmp)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, proc, tmp: str) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    log_tmp = tmp + ".ptxas.txt"
    Path(log_tmp).write_text(out)
    os.replace(log_tmp, _log_path(name))
    os.replace(tmp, _lib_path(name))


def build_all(names: Sequence[str] = ()) -> None:
    """Build every listed source (all of ``csrc/`` by default) that is not
    built yet or has no nvcc output beside it, one nvcc process per
    source, all running together."""
    todo = [n for n in (names or sources())
            if not (_lib_path(n).exists() and _log_path(n).exists())]
    started = [(n, *_start(n)) for n in todo]
    for n, proc, tmp in started:
        _finish(n, proc, tmp)


def library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            _finish(name, *_start(name))
        lib = _libs[name] = ctypes.CDLL(str(path))
    return lib


def function(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of ``csrc/<name>.cu``; pointers and the
    stream must be declared ``c_void_p`` in ``argtypes``.  Every entry point
    returns the launch's ``cudaError_t`` as an int."""
    fn = getattr(library(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")


def refuse_grad(what: str, *tensors) -> None:
    """Raise when autograd would record through a CUDA kernel: the
    kernels have no backward, so their output would be silently detached
    from every input that requires a grad.  Gradients go through the
    plain path (``kernel_impl="plain"``, as ``models.train_forward``
    runs it); serving calls the kernels under ``torch.no_grad()``."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward and an input requires "
            f"a grad; call it under torch.no_grad() or take the plain path "
            f"(kernel_impl='plain') for gradients")


def dtype_code(dtype) -> int:
    """The kernels' storage-type argument: 0 = float32, 1 = bfloat16."""
    import torch
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, "
                        f"not {dtype}")
    return codes[dtype]


def aligned(t):
    """``t`` contiguous and at a 16-byte aligned address (the kernels read
    it in 16-byte vectors): a copy when it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


# per-device scratch that a larger buffer replaced: a captured CUDA graph
# may still hold its address, so it is kept for the life of the process
_retired: List = []


def grow_scratch(old, make, what: str):
    """A new per-device scratch buffer from ``make()`` in place of ``old``
    (None or too small).  ``old`` is kept alive, never freed: a graph
    captured while it was current launches on it at every replay.  Raises
    while a CUDA graph is being captured: the buffer would be allocated
    in the graph's private pool and zeroed only when the graph replays,
    so the step must have run eagerly at this size before its capture."""
    import torch
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"{what}: the per-device scratch would grow inside a CUDA graph "
            f"capture; run the step eagerly at this size before capturing")
    if old is not None:
        _retired.append(old)
    return make()


def stream_of(t) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as an address."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def n_split(name: str, pairs: int, n_tokens: int, g: int, dh: int,
            dtype: int, device) -> int:
    """How many CTAs share one (slot, KV head)'s walk in the decode kernels
    of ``csrc/<name>.cu``: chosen on the C side (``split_count`` in
    ``decode_attend.cuh``) from the tile size, how many CTAs of the kernel
    instance for (g query heads per KV head, dh, dtype code) fit on an SM,
    and ``device``'s SM count, for ``pairs`` walks of at most ``n_tokens``.
    Cached: one library call per argument set."""
    fn = function(name, "decode_split_count", [ctypes.c_int] * 6)
    n = fn(pairs, n_tokens, g, dh, dtype, device.index)
    check(max(-n, 0), f"{name} split count")
    return n

