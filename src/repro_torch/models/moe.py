"""Mixture-of-Experts FFN with sorted (drop-capacity) dispatch, in PyTorch.

The counterpart of ``repro.models.moe``.  The router product runs in the
activation dtype and is cast to fp32; softmax, ``top_k`` and the
renormalisation (floored at 1e-9) pick each token's k experts and gates;
the switch-style load-balance ``aux`` is returned beside the output.
Token-expert pairs are stably argsorted by expert id, every expert takes
at most C of them (``capacity``: drops when a capacity factor is given,
none with ``capacity_factor=None``), the experts run on their rows and
each token sums its gated contributions in ascending expert id: the
order in which the JAX package's sorted scatter-add accumulates them.
An optional shared expert (a gated MLP every token takes) is added.

No TPU kernel covers this layer (the JAX package runs it as XLA einsums),
so it stays in plain tensor ops, in two forms of one function:
- static (``grouped=False``): the JAX layout, an (E, C, d) buffer and
  three batched products.  Every shape is fixed by (T, k, E, C) and
  nothing reads a value back to the host, so the decode step that holds
  it can be captured as a CUDA graph.  At ``capacity_factor=None`` C is
  T·k, so the buffer has E·T·k rows, almost all zero, and every expert's
  weights are read: right for a decode tick's few tokens, and the plain
  reference of the layer at any size;
- grouped (``grouped=True``, ``capacity_factor=None`` only): the pairs
  sorted by expert, the per-expert counts read to the host once, and
  each expert that has rows run on its contiguous rows alone.  The
  prefill form: its work is the routed work, not E·T·k rows.
Both compute each (token, expert) pair once and combine alike.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import upcast
from repro_torch.models.layers import dense_init


def init_moe(cfg, gen, dtype, device):
    """Router, expert banks (E, d_in, d_out) and the shared expert, with
    the JAX package's distributions.  Each expert's matrix is drawn in
    fp32 and cast on its own, so no whole fp32 bank is ever held (one
    llama4 bank is 21.5 GB in fp32)."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.expert_d_ff

    def expert_bank(d_in, d_out):
        bank = torch.empty((E, d_in, d_out), dtype=dtype, device=device)
        for e in range(E):
            bank[e] = dense_init(gen, d_in, d_out, dtype, device)
        return bank

    p = {"router": dense_init(gen, d, E, dtype, device),
         "w_gate": expert_bank(d, f),
         "w_in": expert_bank(d, f),
         "w_out": expert_bank(f, d)}
    if cfg.n_shared_experts:
        sf = cfg.shared_expert_d_ff or cfg.n_shared_experts * f
        p["shared"] = {"w_gate": dense_init(gen, d, sf, dtype, device),
                       "w_in": dense_init(gen, d, sf, dtype, device),
                       "w_out": dense_init(gen, sf, d, dtype, device)}
    return p


def capacity(tk: int, E: int, cf) -> int:
    """Rows per expert: T·k with no capacity factor (no drops), else
    min(T·k, max(4, ceil(cf·T·k/E)))."""
    if cf is None:
        return tk
    return min(tk, max(4, int(math.ceil(cf * tk / E))))


def route(p, xt, cfg):
    """(probs (T,E) fp32, gate (T,k) fp32 renormalised, eid (T,k) int64)."""
    logits = upcast(xt @ p["router"])
    probs = torch.softmax(logits, dim=-1)
    gate, eid = torch.topk(probs, cfg.top_k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, eid


def _sort(eid, E: int):
    """The stable sort of the flat (T·k,) expert ids, the expert counts
    (a scatter-add, no host read) and each sorted entry's slot within its
    expert."""
    flat = eid.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sorted_eid = flat[order]
    counts = torch.zeros((E,), dtype=torch.int64, device=eid.device)
    counts.scatter_add_(0, sorted_eid, torch.ones_like(sorted_eid))
    starts = counts.cumsum(0) - counts
    slot = torch.arange(flat.shape[0], device=eid.device) - starts[sorted_eid]
    return order, sorted_eid, counts, slot


def _combine(back, w, eid, dtype):
    """Sum each token's k gated contributions (back (T·k, d) in flat
    token-major order, w (T·k,) fp32) in ascending expert id, in
    ``dtype``: the JAX package's sorted scatter-add order, without
    atomics."""
    T, k = eid.shape
    contrib = (back * w[:, None].to(dtype)).reshape(T, k, -1)
    if k > 1:
        by_id = torch.argsort(eid, dim=1)
        contrib = torch.gather(
            contrib, 1, by_id[..., None].expand(-1, -1, contrib.shape[2]))
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    return out


def _expert(rows, w_gate, w_in, w_out):
    return (F.silu(rows @ w_gate) * (rows @ w_in)) @ w_out


def _bank_products(buf, p):
    """The static form's expert products: buf (E, C, d) -> (E, C, d)."""
    return torch.bmm(F.silu(torch.bmm(buf, p["w_gate"]))
                     * torch.bmm(buf, p["w_in"]), p["w_out"])


def apply_moe(p, x, cfg, *, capacity_factor: Optional[float] = 1.25,
              grouped: bool = False, need_aux: bool = True
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (B,S,d) -> (out (B,S,d), aux scalar fp32, or None without
    ``need_aux``).  ``capacity_factor=None`` disables drops (serving).
    ``grouped`` selects the grouped form (see the module docstring)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T, Tk = B * S, B * S * k
    xt = x.reshape(T, d)
    probs, gate, eid = route(p, xt, cfg)
    aux = None
    if need_aux:
        frac = torch.zeros((E,), dtype=torch.float32, device=x.device)
        frac.index_add_(0, eid.reshape(-1),
                        torch.ones((Tk,), dtype=torch.float32,
                                   device=x.device))
        frac = frac / Tk
        aux = cfg.router_aux_coef * E * torch.sum(frac * probs.mean(0))
    order, sorted_eid, counts, slot = _sort(eid, E)
    tok_of = order // k
    w = gate.reshape(Tk)
    if grouped:
        if capacity_factor is not None:
            raise ValueError("the grouped form drops nothing: it needs "
                             "capacity_factor=None")
        rows = xt[tok_of]
        outs = torch.empty_like(rows)
        off = 0
        for e, n in enumerate(counts.tolist()):     # one host read a layer
            if n:
                outs[off:off + n] = _expert(rows[off:off + n],
                                            p["w_gate"][e], p["w_in"][e],
                                            p["w_out"][e])
                off += n
        back = torch.empty_like(outs)
        back[order] = outs
    else:
        C = capacity(Tk, E, capacity_factor)
        keep = slot < C
        # dropped pairs land in a spare row C, cut off before the products
        slot_c = torch.where(keep, slot, C)
        buf = torch.zeros((E, C + 1, d), dtype=x.dtype, device=x.device)
        buf[sorted_eid, slot_c] = xt[tok_of]
        buf = buf[:, :C]
        out_e = _bank_products(buf, p)
        back = torch.empty((Tk, d), dtype=x.dtype, device=x.device)
        back[order] = out_e[sorted_eid, torch.clamp(slot, max=C - 1)]
        kept = torch.empty_like(keep)
        kept[order] = keep
        w = torch.where(kept, w, torch.zeros_like(w))
    out = _combine(back, w, eid, x.dtype)
    if "shared" in p:
        sp = p["shared"]
        out = out + _expert(xt, sp["w_gate"], sp["w_in"], sp["w_out"])
    return out.reshape(B, S, d), aux
