"""Chunkwise stabilised mLSTM (CUDA C++ kernel ``csrc/mlstm_chunkwise.cu``):
the prefill of every mLSTM layer.

The port of the TPU kernel ``repro.kernels.mlstm_chunk.mlstm_chunkwise``,
with the same layouts: q, k, v (B,H,S,dh) in fp32 or bf16 (one type), k
already scaled by 1/sqrt(dh); i_pre, f_pre (B,H,S) raw gate
pre-activations, fp32.  Unlike the TPU kernel it takes any S and returns
the final state beside h, which the prefill hands to the decode cache:
(h (B,H,S,dh) in q's dtype, (C (B,H,dh,dh), n (B,H,dh), m (B,H)) fp32).
The kernel takes dh a multiple of 64 up to 1024 and works in chunks of
``ref.MLSTM_CHUNK`` tokens.

A CPU tensor runs the plain version (``ref.mlstm_chunkwise_ref``); a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import MLSTM_CHUNK, mlstm_chunkwise_ref

_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_F32 = torch.float32


def mlstm_chunkwise(q, k, v, i_pre, f_pre, state=None):
    """q, k, v: (B,H,S,dh); i_pre, f_pre: (B,H,S); ``state`` (C, n, m) to
    start from, or None for a fresh one.  Returns (h, (C, n, m)).
    ``mlstm_chunkwise.launches`` counts the kernel launches (CPU calls are
    not counted)."""
    if q.device.type == "cpu":
        return mlstm_chunkwise_ref(q, k, v, i_pre, f_pre, state)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_chunkwise runs on cpu or cuda, not "
                         f"{q.device}")
    B, H, S, dh = q.shape
    if k.shape != q.shape or v.shape != q.shape or \
            i_pre.shape != (B, H, S) or f_pre.shape != (B, H, S):
        raise ValueError(f"mlstm_chunkwise shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, i_pre "
                         f"{tuple(i_pre.shape)}, f_pre {tuple(f_pre.shape)}")
    if S < 1 or dh % 64 or dh > 1024:
        raise ValueError(f"the mlstm_chunkwise kernel takes S >= 1 and dh a "
                         f"multiple of 64 up to 1024, not S={S} dh={dh}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if any(t.device != q.device for t in (k, v, i_pre, f_pre)):
        raise ValueError("mlstm_chunkwise operands must share one device")
    code = _build.dtype_code(q.dtype)
    q, k, v = map(_build.aligned, (q, k, v))
    i_pre = i_pre.to(_F32).contiguous()
    f_pre = f_pre.to(_F32).contiguous()
    BH = B * H
    nc = -(-S // MLSTM_CHUNK)
    scores = torch.empty((BH, nc, MLSTM_CHUNK, MLSTM_CHUNK), dtype=_F32,
                         device=q.device)
    h = torch.empty_like(q)
    C = torch.empty((B, H, dh, dh), dtype=_F32, device=q.device)
    n = torch.empty((B, H, dh), dtype=_F32, device=q.device)
    m = torch.empty((B, H), dtype=_F32, device=q.device)
    if state is None:
        init = (None, None, None)
    else:
        shapes = ((B, H, dh, dh), (B, H, dh), (B, H))
        if tuple(tuple(t.shape) for t in state) != shapes:
            raise ValueError(f"mlstm_chunkwise state shapes "
                             f"{[tuple(t.shape) for t in state]}, want "
                             f"{list(shapes)}")
        init = tuple(t.to(device=q.device, dtype=_F32).contiguous()
                     for t in state)
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    fn = _build.function("mlstm_chunkwise", "mlstm_chunkwise_launch",
                         _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), i_pre.data_ptr(),
             f_pre.data_ptr(), scores.data_ptr(), *map(ptr, init),
             h.data_ptr(), C.data_ptr(), n.data_ptr(), m.data_ptr(), BH, S,
             dh, MLSTM_CHUNK, code, _build.stream_of(q))
    _build.check(err, "mlstm_chunkwise")
    mlstm_chunkwise.launches += 1
    return h, (C, n, m)


mlstm_chunkwise.launches = 0
