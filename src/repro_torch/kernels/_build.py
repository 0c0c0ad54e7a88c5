"""Builds the hand-written CUDA kernels and binds them through ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``<repo>/build/repro_torch_kernels/`` — a path resolved from this file's
location, not the working directory.  The library's file name carries a
hash of its source, the shared headers (``csrc/*.cuh``) and the flags, so
an edited source or header rebuilds at its next use and an unchanged one
loads as built.  Nothing is built at import
time: the first CUDA call of a kernel builds it, and ``build_all`` builds
every source at once (one ``nvcc`` process each, started together).
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
# ptxas resource lines (registers, shared memory, spills) per source
ptxas_log: Dict[str, str] = {}


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
    ptxas_log[name] = out
    os.replace(tmp, _lib_path(name))


def build_all(names: Sequence[str] = ()) -> None:
    """Build every listed source (all of ``csrc/`` by default) that is not
    built yet, one nvcc process per source, all running together."""
    todo = [n for n in (names or sources()) if not _lib_path(n).exists()]
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

