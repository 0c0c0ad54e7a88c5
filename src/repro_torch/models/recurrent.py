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
from repro_torch.kernels.ref import rglru_scan_ref
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
    return {"h": torch.zeros((batch, d), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, d), dtype=dtype,
                                device=device)}


def _causal_conv(w, u, conv_state):
    """Depthwise causal conv. u: (B,S,d); returns (out, new_state)."""
    cw = w.shape[0]
    hist = torch.cat([conv_state.to(u.dtype), u], dim=1)   # (B, S+cw-1, d)
    S = u.shape[1]
    out = sum(hist[:, j:j + S] * w[j] for j in range(cw))
    return out, hist[:, hist.shape[1] - (cw - 1):]


def _gates(p, u_conv):
    i = torch.sigmoid((u_conv @ p["w_i"]).float())
    r = torch.sigmoid((u_conv @ p["w_a"]).float())
    log_a = -_C * F.softplus(p["lam"].float()) * r             # (…, d), ≤ 0
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * i * u_conv.float()


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def apply_rec(p, x, cfg, state: Optional[dict] = None, *,
              kernel_impl: str = "kernel") -> Tuple[torch.Tensor, dict]:
    """Full-sequence mode. x: (B,S,d) -> (out, final_state).
    ``kernel_impl``: see ``models.layers``."""
    B, S, d = x.shape
    if state is None:
        state = init_rec_state(cfg, B, x.dtype, x.device)
    u = x @ p["w_x"]
    u_conv, conv_state = _causal_conv(p["conv"], u, state["conv"])
    a, b = _gates(p, u_conv)                             # (B,S,d) fp32 each
    scan = rglru_scan if kernel_impl == "kernel" else rglru_scan_ref
    h = scan(a, b, state["h"].float())                   # (B,S,d) fp32
    y = _gelu((x @ p["w_y"]).float())
    out = (y * h).to(x.dtype) @ p["w_out"]
    return out, {"h": h[:, -1], "conv": conv_state}


def apply_rec_step(p, x, cfg, state) -> Tuple[torch.Tensor, dict]:
    """Decode mode. x: (B,1,d)."""
    u = x @ p["w_x"]                                     # (B,1,d)
    cw = p["conv"].shape[0]
    hist = torch.cat([state["conv"].to(u.dtype), u], dim=1)   # (B,cw,d)
    u_conv = sum(hist[:, j] * p["conv"][j] for j in range(cw))[:, None]
    a, b = _gates(p, u_conv)                             # (B,1,d)
    h = a[:, 0] * state["h"] + b[:, 0]
    y = _gelu((x @ p["w_y"]).float())
    out = (y[:, 0] * h)[:, None].to(x.dtype) @ p["w_out"]
    return out, {"h": h, "conv": hist[:, 1:]}
