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


MLSTM_CHUNK = 64               # the CUDA kernel's chunk length


def mlstm_chunk_step(q, k, v, i_pre, f_pre, state):
    """One chunk of stabilised mLSTM, vectorised over (B, H): the plain
    version's own copy of ``repro.models.xlstm._mlstm_chunk`` (the model's
    decode step is ``models.xlstm._mlstm_chunk``; this one serves only as
    the reference).

    q, k, v: (B,H,L,dh), k already scaled by 1/sqrt(dh); i_pre, f_pre:
    (B,H,L) raw gate pre-activations; state (C (B,H,dh,dh), n (B,H,dh),
    m (B,H)) in fp32.  Returns (h (B,H,L,dh) in q's dtype, new state)."""
    C, n, m = state
    L = q.shape[2]
    logf = torch.nn.functional.logsigmoid(f_pre.float())
    b = torch.cumsum(logf, dim=-1)                          # inclusive
    g = b[..., -1]
    i_pre = i_pre.float()
    D = b[..., :, None] - b[..., None, :] + i_pre[..., None, :]
    causal = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    D = torch.where(causal, D, torch.full_like(D, NEG_INF))
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
    C_new = carry[..., None, None] * C + kw.transpose(-1, -2) @ vf
    n_new = carry[..., None] * n + kw.sum(dim=-2)
    return h.to(q.dtype), (C_new, n_new, m_new)


def mlstm_chunkwise_ref(q, k, v, i_pre, f_pre, state=None, *,
                        chunk: int = MLSTM_CHUNK):
    """Chunkwise mLSTM over any S: ``mlstm_chunk_step`` on chunks of
    ``chunk`` tokens, the last one short when ``chunk`` does not divide S
    (the JAX oracle drops such a tail).  q, k, v: (B,H,S,dh); i_pre, f_pre:
    (B,H,S); ``state`` (C, n, m) to start from, fresh (zeros, m = -1e30)
    when None.  Returns (h (B,H,S,dh) in q's dtype, final (C, n, m))."""
    B, H, S, dh = q.shape
    if state is None:
        state = (torch.zeros((B, H, dh, dh), device=q.device),
                 torch.zeros((B, H, dh), device=q.device),
                 torch.full((B, H), NEG_INF, device=q.device))
    hs = []
    for t0 in range(0, S, chunk):
        sl = slice(t0, t0 + chunk)
        h, state = mlstm_chunk_step(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                    i_pre[:, :, sl], f_pre[:, :, sl], state)
        hs.append(h)
    return torch.cat(hs, dim=2), state


def mlstm_parallel_f64(q, k, v, i_pre, f_pre):
    """The mLSTM from a fresh state in its parallel (quadratic) form, in
    fp64: an oracle independent of any chunking, and the conditioning of
    each output.  Same inputs as ``mlstm_chunkwise_ref``.

    With b = cumsum(logsigmoid(f)), a_s = i_s - b_s and M_j = max_{s<=j}
    a_s, the stabiliser is m_j = b_j + M_j at any chunk length, and
      h_j = sum_{s<=j} (q_j.k_s) E_js v_s / max(|den_j|, e^{-m_j}),
      den_j = sum_{s<=j} (q_j.k_s) E_js,   E_js = e^{a_s - M_j} <= 1.
    Where den_j cancels far below its terms, any two summation orders
    disagree: a result computed with relative rounding u per term is off
    by at most about u * scale, with
      scale_je = (N_je + |h_je| T_j) / max(|den_j|, e^{-m_j}),
      T_j = sum_s |q_j|.|k_s| E_js,   N_je = sum_s |q_j|.|k_s| E_js |v_se|.
    Returns (h, scale, (C, n, m)), all fp64."""
    f64 = torch.float64
    q, k, v = q.to(f64), k.to(f64), v.to(f64)
    b = torch.cumsum(torch.nn.functional.logsigmoid(f_pre.to(f64)), -1)
    a = i_pre.to(f64) - b
    M = torch.cummax(a, dim=-1).values
    S = q.shape[2]
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    E = torch.where(causal, torch.exp(a[..., None, :] - M[..., :, None]),
                    torch.zeros((), dtype=f64, device=q.device))
    W = (q @ k.transpose(-1, -2)) * E
    A = (q.abs() @ k.abs().transpose(-1, -2)) * E
    floor = torch.maximum((W.sum(-1)).abs(), torch.exp(-(b + M)))
    h = (W @ v) / floor[..., None]
    scale = (A @ v.abs() + h.abs() * A.sum(-1)[..., None]) / floor[..., None]
    last = torch.exp(a - M[..., -1:])[..., None] * k        # (B,H,S,dh)
    state = (last.transpose(-1, -2) @ v, last.sum(-2), b[..., -1] + M[..., -1])
    return h, scale, state
