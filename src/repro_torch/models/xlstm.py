"""xLSTM blocks, mLSTM (matrix memory) and sLSTM (scalar memory)
[arXiv:2405.04517], in PyTorch.

The counterpart of ``repro.models.xlstm``.  mLSTM prefill runs the
chunkwise stabilised form through ``kernels.mlstm_chunkwise`` (the CUDA
kernel on the GPU, its plain chunk loop on the CPU), which also returns
the final (C, n, m) for the decode cache; decode is the same chunk math
at L = 1 in plain tensor ops (no TPU kernel covers it).  QKV projections
are head-wise block-diagonal with head dim d_inner / n_heads.  sLSTM is
strictly sequential: a plain loop over S (no TPU kernel covers it either).

States:
  mlstm: {"C": (B,H,dh,dh) f32, "n": (B,H,dh) f32, "m": (B,H) f32,
          "conv": (B,cw-1,di) in the model dtype}
  slstm: {"c","n","h","m": (B,d) f32}
As in JAX, the mLSTM gate weights (``w_i``, ``w_f``, ``b_i``, ``b_f``) and
the sLSTM recurrence (``r``, ``b``) stay fp32 in a bf16 model, and ``m``
starts at the finite sentinel -1e30, so exp(g + m - m_new) gives 0, not
NaN.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import mlstm_chunkwise
from repro_torch.kernels.ref import NEG_INF as NEG
from repro_torch.kernels.ref import acc_dtype, mlstm_chunkwise_ref, upcast
from repro_torch.models.layers import const, dense_init
from repro_torch.models.recurrent import (_causal_conv, _gelu, at_length,
                                           write_state)

_F32 = torch.float32


# =============================================================== mLSTM block
def init_mlstm(cfg, gen, dtype, device):
    d, di, H = cfg.d_model, cfg.d_inner, cfg.n_heads
    dh = di // H

    def headwise():
        w = torch.randn((H, dh, dh), generator=gen, dtype=_F32,
                        device=device) / math.sqrt(dh)
        return w.to(dtype)

    return {
        "w_up": dense_init(gen, d, 2 * di, dtype, device),
        "conv": (torch.randn((cfg.conv_width, di), generator=gen, dtype=_F32,
                             device=device) * 0.1).to(dtype),
        "wq": headwise(), "wk": headwise(), "wv": headwise(),
        "w_i": dense_init(gen, di, H, _F32, device),
        "w_f": dense_init(gen, di, H, _F32, device),
        "b_i": torch.zeros((H,), dtype=_F32, device=device),
        # forget bias > 0: remember by default
        "b_f": torch.linspace(3.0, 6.0, H, dtype=_F32, device=device),
        "hnorm": torch.ones((di,), dtype=dtype, device=device),
        "w_down": dense_init(gen, di, d, dtype, device),
    }


def init_mlstm_state(cfg, batch, dtype, device):
    di, H = cfg.d_inner, cfg.n_heads
    dh = di // H
    return {"C": torch.zeros((batch, H, dh, dh), dtype=_F32, device=device),
            "n": torch.zeros((batch, H, dh), dtype=_F32, device=device),
            "m": torch.full((batch, H), NEG, dtype=_F32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, di), dtype=dtype,
                                device=device)}


def _mlstm_chunk(q, k, v, i_pre, f_pre, state, inplace: bool = False):
    """One chunk of stabilised mLSTM, vectorised over (B, H): the port of
    ``repro.models.xlstm._mlstm_chunk``, the decode step at L = 1.

    q, k, v: (B,H,L,dh), k already scaled by 1/sqrt(dh); i_pre, f_pre:
    (B,H,L) raw gate pre-activations; state (C (B,H,dh,dh), n (B,H,dh),
    m (B,H)) in fp32.  Returns (h (B,H,L,dh) in q's dtype, new state);
    with ``inplace`` the state tensors themselves take the update, in the
    same arithmetic order (bitwise equal): a copy back would re-read and
    re-write all of C, 5.25 GiB a tick for xlstm-1.3b at 8 slots.
    ``ref.mlstm_chunk_step`` is the plain version's own copy."""
    C, n, m = state
    L = q.shape[2]
    logf = F.logsigmoid(f_pre.float())
    b = torch.cumsum(logf, dim=-1)                          # inclusive
    g = b[..., -1]
    i_pre = i_pre.float()
    D = b[..., :, None] - b[..., None, :] + i_pre[..., None, :]
    causal = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    D = torch.where(causal, D, torch.full_like(D, NEG))
    m_intra = D.amax(dim=-1)
    m_inter = b + m[..., None]
    m_j = torch.maximum(m_intra, m_inter)
    qf, kf, vf = q.float(), k.float(), v.float()
    scores = qf @ kf.transpose(-1, -2)
    w_att = scores * torch.exp(D - m_j[..., None])
    inter_scale = torch.exp(m_inter - m_j)
    numer = inter_scale[..., None] * (qf @ C) + w_att @ vf
    qn = (qf @ n[..., None])[..., 0]
    denom = inter_scale * qn + w_att.sum(-1)
    h = numer / torch.maximum(denom.abs(), torch.exp(-m_j))[..., None]
    s_gate = g[..., None] - b + i_pre
    m_new = torch.maximum(g + m, s_gate.amax(dim=-1))
    carry = torch.exp(g + m - m_new)
    kw = torch.exp(s_gate - m_new[..., None])[..., None] * kf
    if inplace:
        C.mul_(carry[..., None, None]).add_(kw.transpose(-1, -2) @ vf)
        n.mul_(carry[..., None]).add_(kw.sum(dim=-2))
        m.copy_(m_new)
        return h.to(q.dtype), (C, n, m)
    C_new = carry[..., None, None] * C + kw.transpose(-1, -2) @ vf
    n_new = carry[..., None] * n + kw.sum(dim=-2)
    return h.to(q.dtype), (C_new, n_new, m_new)


def _mlstm_qkvif(p, x, cfg, conv_state, length=None):
    """Shared front end. x: (B,S,d).  Returns q, k, v (B,H,S,dh), i, f
    (B,H,S) fp32, z (B,S,di) and the new conv state.  With ``length``
    ((1,) int64 tensor; x right-padded past it) every padded step is the
    identity of the stabilised recurrence: input gate log -1e30 and
    forget gate log 0 (pre-activation +1e30) leave m, C and n as they
    were, bit for bit, and the conv state is the one at ``length``."""
    B, S, _ = x.shape
    di, H = cfg.d_inner, cfg.n_heads
    dh = di // H
    uz = x @ p["w_up"]
    u, z = uz[..., :di], uz[..., di:]
    c, conv_state = _causal_conv(p["conv"], u, conv_state, length)
    c = F.silu(c)
    ch = c.reshape(B, S, H, dh)
    uh = u.reshape(B, S, H, dh)
    q = torch.einsum("bshd,hde->bhse", ch, p["wq"])
    # JAX divides by the Python float in the activation dtype
    k = torch.einsum("bshd,hde->bhse", ch, p["wk"]) / const(
        math.sqrt(dh), ch.dtype, ch.device)
    v = torch.einsum("bshd,hde->bhse", uh, p["wv"])
    cf = upcast(c)
    i_pre = (cf @ p["w_i"] + p["b_i"]).transpose(1, 2)
    f_pre = (cf @ p["w_f"] + p["b_f"]).transpose(1, 2)
    if length is not None:
        pad = torch.arange(S, device=x.device) >= length
        i_pre = i_pre.masked_fill(pad, NEG)
        f_pre = f_pre.masked_fill(pad, -NEG)
    return q, k, v, i_pre, f_pre, z, conv_state


def _headnorm(h, scale, H):
    """Per-head RMS norm over dh (eps 1e-6). h: (B,S,di)."""
    B, S, di = h.shape
    hh = upcast(h.reshape(B, S, H, di // H))
    hh = hh * torch.rsqrt((hh * hh).mean(-1, keepdim=True) + 1e-6)
    return (hh.reshape(B, S, di) * upcast(scale)).to(h.dtype)


def _mlstm_out(p, h, z, cfg):
    """h: (B,H,S,dh) -> block output (B,S,d)."""
    B, H, S, dh = h.shape
    h = h.transpose(1, 2).reshape(B, S, H * dh)
    return (_headnorm(h, p["hnorm"], H) * F.silu(z)) @ p["w_down"]


def apply_mlstm(p, x, cfg, state: Optional[dict] = None, *,
                kernel_impl: str = "kernel",
                length=None) -> Tuple[torch.Tensor, dict]:
    """Full-sequence (chunkwise) mode. x: (B,S,d) -> (out, final state).
    ``kernel_impl``: see ``models.layers``.  ``length``: x is
    right-padded past that many rows and the state is the one at
    ``length`` (``_mlstm_qkvif``)."""
    if state is None:       # fresh: no conv history, the scan's zero carry
        conv = torch.zeros((x.shape[0], cfg.conv_width - 1, cfg.d_inner),
                           dtype=x.dtype, device=x.device)
        carry = None
    else:
        conv, carry = state["conv"], (state["C"], state["n"], state["m"])
    q, k, v, i_pre, f_pre, z, conv_state = _mlstm_qkvif(p, x, cfg, conv,
                                                        length)
    scan = mlstm_chunkwise if kernel_impl == "kernel" else mlstm_chunkwise_ref
    h, (C, n, m) = scan(q, k, v, i_pre, f_pre, carry)
    return _mlstm_out(p, h, z, cfg), {"C": C, "n": n, "m": m,
                                      "conv": conv_state}


def apply_mlstm_step(p, x, cfg, state, *,
                     inplace: bool = False) -> Tuple[torch.Tensor, dict]:
    """Decode mode. x: (B,1,d).  Returns (out, new state); with
    ``inplace`` the new state is written into ``state``'s tensors (C, n
    and m updated in place, no copy of C)."""
    q, k, v, i_pre, f_pre, z, conv_state = _mlstm_qkvif(
        p, x, cfg, state["conv"])
    h, (C, n, m) = _mlstm_chunk(q, k, v, i_pre, f_pre,
                                (state["C"], state["n"], state["m"]),
                                inplace=inplace)
    new = {"C": C, "n": n, "m": m, "conv": conv_state}
    return _mlstm_out(p, h, z, cfg), \
        write_state(state, new) if inplace else new


# =============================================================== sLSTM block
def init_slstm(cfg, gen, dtype, device):
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    w = torch.randn((4, d, d), generator=gen, dtype=_F32,
                    device=device) / math.sqrt(d)
    r = torch.randn((4, H, dh, dh), generator=gen, dtype=_F32,
                    device=device) / math.sqrt(dh)
    ff = int(d * 4 / 3)
    b = torch.zeros((4, d), dtype=_F32, device=device)
    b[2] = 3.0                     # forget-gate bias
    return {"w": w.to(dtype), "r": r, "b": b,
            "w_up": dense_init(gen, d, ff, dtype, device),
            "w_down": dense_init(gen, ff, d, dtype, device)}


def init_slstm_state(cfg, batch, dtype, device):
    d, acc = cfg.d_model, acc_dtype(dtype)
    z = lambda: torch.zeros((batch, d), dtype=acc, device=device)  # noqa
    return {"c": z(), "n": z() + 1e-6, "h": z(),
            "m": torch.full((batch, d), NEG, dtype=acc, device=device)}


def _slstm_step(p, pre_t, st, H):
    """pre_t: (4,B,d) input pre-activations at one step."""
    B, d = st["h"].shape
    dh = d // H
    hh = st["h"].reshape(B, H, dh)
    rec = torch.einsum("bhe,ghef->gbhf", hh, p["r"]).reshape(4, B, d)
    az, ai, af, ao = pre_t + rec + p["b"][:, None, :]
    z = torch.tanh(az)
    m_new = torch.maximum(af + st["m"], ai)
    i = torch.exp(ai - m_new)
    f = torch.exp(af + st["m"] - m_new)
    c = f * st["c"] + i * z
    n = f * st["n"] + i
    h = torch.sigmoid(ao) * c / torch.clamp(n, min=1e-6)
    return {"c": c, "n": n, "h": h, "m": m_new}


def _slstm_pre(p, x):
    """Input pre-activations (4,B,S,d): a product in the activation dtype,
    cast to fp32 afterwards, as in JAX."""
    return upcast(torch.einsum("bsd,gde->gbse", x, p["w"]))


def _slstm_out(p, h, x):
    return _gelu(h.to(x.dtype) @ p["w_up"]) @ p["w_down"]


def apply_slstm(p, x, cfg, state: Optional[dict] = None, *,
                length=None) -> Tuple[torch.Tensor, dict]:
    """Full-sequence mode: a loop over S. x: (B,S,d).  ``length`` ((1,)
    int64 tensor; x right-padded past it): the state is the one after
    row length-1, read from the stacked per-step states by a device
    index (a padded step moves h, so it cannot be made the identity)."""
    B, S, _ = x.shape
    if state is None:
        state = init_slstm_state(cfg, B, x.dtype, x.device)
    pre = _slstm_pre(p, x)
    steps = []
    for t in range(S):
        state = _slstm_step(p, pre[:, :, t], state, cfg.n_heads)
        steps.append(state)
    hs = torch.stack([st["h"] for st in steps], dim=1)
    if length is not None:
        state = {name: hs if name == "h" else
                 torch.stack([st[name] for st in steps], dim=1)
                 for name in state}
        state = {name: at_length(seq, length) for name, seq in state.items()}
    return _slstm_out(p, hs, x), state


def apply_slstm_step(p, x, cfg, state, *,
                     inplace: bool = False) -> Tuple[torch.Tensor, dict]:
    """Decode mode. x: (B,1,d).  Returns (out, new state); with
    ``inplace`` the new state is written into ``state``'s tensors."""
    new = _slstm_step(p, _slstm_pre(p, x)[:, :, 0], state, cfg.n_heads)
    out = _slstm_out(p, new["h"][:, None], x)
    return out, write_state(state, new) if inplace else new
