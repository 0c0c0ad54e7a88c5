"""RG-LRU recurrent block (Griffin / RecurrentGemma), in PyTorch.

The counterpart of ``repro.models.recurrent``:
h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ u_t),
a_t = exp(-c · softplus(Λ) · r_t), r/i = input-dependent sigmoid gates,
u = causal depthwise conv(x W_x).  Full-sequence mode (prefill) runs the
recurrence through ``kernels.rglru_scan`` (the CUDA kernel on the GPU, its
plain loop on the CPU); decode is a single-step update in plain tensor
ops, as in the JAX package (no TPU kernel covers it).

State: {"h": (B, d) fp32, "conv": (B, cw-1, d) in the model dtype}.  The
gates run in fp32 and ``lam`` stays fp32 in a bf16 model, as in JAX.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import rglru_scan
from repro_torch.kernels.ref import acc_dtype, rglru_scan_ref, upcast
from repro_torch.models.layers import dense_init

_C = 8.0


def init_rec(cfg, gen, dtype, device):
    d = cfg.d_model
    p = {"w_y": dense_init(gen, d, d, dtype, device),
         "w_x": dense_init(gen, d, d, dtype, device),
         "conv": (torch.randn((cfg.conv_width, d), generator=gen,
                              dtype=torch.float32, device=device)
                  * 0.1).to(dtype),
         "w_i": dense_init(gen, d, d, dtype, device),
         "w_a": dense_init(gen, d, d, dtype, device),
         # Λ init so that a = exp(-c·softplus(Λ)) ∈ ~[0.9, 0.999] at r=1
         "lam": torch.linspace(-4.0, -1.0, d, dtype=torch.float32,
                               device=device),
         "w_out": dense_init(gen, d, d, dtype, device)}
    return p


def init_rec_state(cfg, batch, dtype, device):
    d = cfg.d_model
    return {"h": torch.zeros((batch, d), dtype=acc_dtype(dtype),
                             device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, d), dtype=dtype,
                                device=device)}


def _causal_conv(w, u, conv_state, length=None):
    """Depthwise causal conv. u: (B,S,d); returns (out, new_state), the
    state being the last cw-1 inputs, or with ``length`` (a (1,) int64
    tensor: the real rows of a right-padded u) the cw-1 inputs before
    row ``length``, read by a device index."""
    cw = w.shape[0]
    hist = torch.cat([conv_state.to(u.dtype), u], dim=1)   # (B, S+cw-1, d)
    S = u.shape[1]
    out = sum(hist[:, j:j + S] * w[j] for j in range(cw))
    if length is None:
        return out, hist[:, hist.shape[1] - (cw - 1):]
    return out, hist.index_select(
        1, length + torch.arange(cw - 1, device=u.device))


def at_length(seq, length):
    """Row ``length - 1`` of ``seq`` (B,S,...) along axis 1, by a device
    index ((1,) int64 tensor), or the last row when ``length`` is None."""
    if length is None:
        return seq[:, -1]
    return seq.index_select(1, length - 1)[:, 0]


def _gates(p, u_conv):
    i = torch.sigmoid(upcast(u_conv @ p["w_i"]))
    r = torch.sigmoid(upcast(u_conv @ p["w_a"]))
    log_a = -_C * F.softplus(upcast(p["lam"])) * r         # (…, d), ≤ 0
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * i * upcast(u_conv)


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def apply_rec(p, x, cfg, state: Optional[dict] = None, *,
              kernel_impl: str = "kernel",
              length=None) -> Tuple[torch.Tensor, dict]:
    """Full-sequence mode. x: (B,S,d) -> (out, final_state).
    ``kernel_impl``: see ``models.layers``.  ``length`` ((1,) int64
    tensor): x is right-padded past that many rows, and the state is the
    one at ``length`` (h read at row length-1, the conv window from the
    last real inputs)."""
    B, S, d = x.shape
    if state is None:
        state = init_rec_state(cfg, B, x.dtype, x.device)
    u = x @ p["w_x"]
    u_conv, conv_state = _causal_conv(p["conv"], u, state["conv"], length)
    a, b = _gates(p, u_conv)                             # (B,S,d) fp32 each
    scan = rglru_scan if kernel_impl == "kernel" else rglru_scan_ref
    h = scan(a, b, upcast(state["h"]))                   # (B,S,d) fp32
    y = _gelu(upcast(x @ p["w_y"]))
    out = (y * h).to(x.dtype) @ p["w_out"]
    return out, {"h": at_length(h, length), "conv": conv_state}


def write_state(state: dict, new: dict) -> dict:
    """Copy ``new``'s tensors into ``state``'s own, in place (every leaf
    keeps its address, as a captured decode step needs); returns
    ``state``."""
    for name, t in new.items():
        if t is not state[name]:
            state[name].copy_(t)
    return state


def apply_rec_step(p, x, cfg, state, *,
                   inplace: bool = False) -> Tuple[torch.Tensor, dict]:
    """Decode mode. x: (B,1,d).  Returns (out, new state); with
    ``inplace`` the new state is written into ``state``'s tensors."""
    u = x @ p["w_x"]                                     # (B,1,d)
    cw = p["conv"].shape[0]
    hist = torch.cat([state["conv"].to(u.dtype), u], dim=1)   # (B,cw,d)
    u_conv = sum(hist[:, j] * p["conv"][j] for j in range(cw))[:, None]
    a, b = _gates(p, u_conv)                             # (B,1,d)
    h = a[:, 0] * state["h"] + b[:, 0]
    y = _gelu((x @ p["w_y"]).float())
    out = (y[:, 0] * h)[:, None].to(x.dtype) @ p["w_out"]
    new = {"h": h, "conv": hist[:, 1:]}
    return out, write_state(state, new) if inplace else new
