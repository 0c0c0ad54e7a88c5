"""Plain PyTorch versions of the hand-written kernels in this package.

Counterparts of ``repro.kernels.ref`` with the same signatures and
layouts.  The kernel wrappers use them for CPU tensors, and the card's
smoke run holds each kernel against them on the same inputs.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None):
    """q: (B,H,S,dh), k/v: (B,KVH,S,dh) -> (B,H,S,dh)."""
    B, H, S, dh = q.shape
    KVH = k.shape[1]
    g = H // KVH
    qg = q.reshape(B, KVH, g, S, dh).float() / math.sqrt(dh)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float())
    pos = torch.arange(S, device=q.device)
    qpos, kpos = pos[:, None], pos[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", w, v.float())
    return o.reshape(B, H, S, dh).to(q.dtype)


def paged_decode_step_ref(q, k_new, v_new, k_pages, v_pages, page_table,
                          lens, *, window=None):
    """Plain fused decode step: append k_new/v_new at position lens-1 of
    each slot's tail page, then attend.

    q: (B,H,dh); k_new/v_new: (B,KVH,dh); k/v_pages: (P,ps,KVH,dh), page
    P-1 is the trash page; page_table: (B,MP) int32 (-1 = unallocated);
    lens: (B,) token counts INCLUDING the new token.  Only lens-1 tokens
    are read from storage; the new token's contribution comes from the
    operand, so a FREE slot (row all -1, append lands on the trash page)
    gets softmax over the new token alone.  The pools are updated IN PLACE
    (the JAX version returns new arrays); returns (out (B,H,dh), k_pages,
    v_pages)."""
    B, H, dh = q.shape
    P, ps, KVH, _ = k_pages.shape
    g = H // KVH
    MP = page_table.shape[1]
    page_table = page_table.long()
    n1 = (lens.long() - 1).clamp(min=0)
    bidx = torch.arange(B, device=q.device)
    pg = page_table[bidx, (n1 // ps).clamp(max=MP - 1)]
    pg = torch.where(pg >= 0, pg, P - 1)                 # FREE -> trash
    k_pages[pg, n1 % ps] = k_new.to(k_pages.dtype)
    v_pages[pg, n1 % ps] = v_new.to(v_pages.dtype)
    pt = torch.where(page_table >= 0, page_table, P - 1)
    k = k_pages[pt].reshape(B, MP * ps, KVH, dh)
    v = v_pages[pt].reshape(B, MP * ps, KVH, dh)
    # stored tokens + the new token concatenated as one extra kv position
    k = torch.cat([k, k_new[:, None].to(k.dtype)], dim=1)
    v = torch.cat([v, v_new[:, None].to(v.dtype)], dim=1)
    t = torch.arange(MP * ps, device=q.device)[None]
    valid = (t < n1[:, None]) & (
        torch.repeat_interleave(page_table, ps, dim=1) >= 0)
    if window is not None:
        valid &= n1[:, None] - t < window
    valid = torch.cat([valid, torch.ones((B, 1), dtype=torch.bool,
                                         device=q.device)], dim=1)
    qg = q.reshape(B, KVH, g, dh).float() / math.sqrt(dh)
    s = torch.einsum("bkgd,bwkd->bkgw", qg, k.float())
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgw,bwkd->bkgd", w, v.float())
    return o.reshape(B, H, dh).to(q.dtype), k_pages, v_pages


def decode_attention_ref(q, k, v, spos, pos, *, window=None):
    """Single-token decode against a (ring) KV cache.

    q: (B,H,dh); k/v: (B,W,KVH,dh); spos: (B,W) stored positions (-1
    empty); pos: (B,) current positions.  Returns (B,H,dh).  A row with no
    valid slot softmaxes over all-masked scores: the uniform mean of V."""
    B, H, dh = q.shape
    KVH = k.shape[2]
    g = H // KVH
    qg = q.reshape(B, KVH, g, dh).float() / math.sqrt(dh)
    s = torch.einsum("bkgd,bwkd->bkgw", qg, k.float())
    pos2 = pos.long()[:, None]
    spos = spos.long()
    valid = (spos >= 0) & (spos <= pos2)
    if window is not None:
        valid &= pos2 - spos < window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgw,bwkd->bkgd", w, v.float())
    return o.reshape(B, H, dh).to(q.dtype)


def paged_decode_attention_ref(q, k_pages, v_pages, page_table, lens, *,
                               window=None):
    """Single-token decode against a paged KV pool, read-only.

    q: (B,H,dh); k/v_pages: (P,ps,KVH,dh) with the last page reserved as
    trash; page_table: (B,MP) int32 page ids (-1 = unallocated); lens:
    (B,) live token counts.  Returns (B,H,dh).  A row with no valid token
    (lens == 0) is the uniform mean of V over all MP·ps table entries,
    unallocated ones read from the trash page."""
    B, H, dh = q.shape
    P, ps, KVH, _ = k_pages.shape
    g = H // KVH
    MP = page_table.shape[1]
    table = page_table.long()
    pt = torch.where(table >= 0, table, P - 1)
    k = k_pages[pt].reshape(B, MP * ps, KVH, dh)
    v = v_pages[pt].reshape(B, MP * ps, KVH, dh)
    t = torch.arange(MP * ps, device=q.device)[None]
    n = lens.long()[:, None]
    valid = (t < n) & (torch.repeat_interleave(table, ps, dim=1) >= 0)
    if window is not None:
        valid &= (n - 1) - t < window
    qg = q.reshape(B, KVH, g, dh).float() / math.sqrt(dh)
    s = torch.einsum("bkgd,bwkd->bkgw", qg, k.float())
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgw,bwkd->bkgd", w, v.float())
    return o.reshape(B, H, dh).to(q.dtype)


def rglru_scan_ref(a, b, h0):
    """Linear recurrence h_t = a_t * h_{t-1} + b_t: a, b (B,S,d), h0 (B,d)
    -> h (B,S,d) in a's dtype.  A sequential loop over t with an fp32
    carry, as the kernel computes it (the JAX oracle uses a log-depth
    associative scan; the two agree to fp32 rounding)."""
    B, S, d = a.shape
    h = torch.empty((B, S, d), dtype=a.dtype, device=a.device)
    carry = h0.float()
    af, bf = a.float(), b.float()
    for t in range(S):
        carry = af[:, t] * carry + bf[:, t]
        h[:, t] = carry.to(a.dtype)
    return h
