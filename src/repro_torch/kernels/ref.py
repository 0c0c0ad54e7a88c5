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
