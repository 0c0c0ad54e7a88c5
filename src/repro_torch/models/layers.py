"""Shared layers of the decoder: norms, RoPE, attention (flash prefill,
striped ring decode, fused paged decode, paged suffix prefill), the
striped KV caches and the FFNs.

The PyTorch counterpart of ``repro.models.layers``.  Parameters are plain
dicts of tensors; functions take and return tensors in the JAX package's
layouts.  Plain matrix products stay ``torch.matmul``.

``kernel_impl`` is the port's one switch between every hand-written
kernel and its plain version, taken by the functions here, by
``recurrent.apply_rec``, by ``model.forward``/``decode_step`` and by the
engines.  ``"kernel"`` (the default) sends causal prefill attention to the
flash kernel, the striped decode to the ring decode kernel, the paged
decode to the fused paged kernel and the RG-LRU prefill to the scan
kernel (each of which takes its plain version on a CPU tensor);
``"plain"`` computes the same with plain tensor ops whatever the device
(masked softmax over the ring or the gathered pages, the sequential
scan), used as an independent check of the kernel path.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention, paged_decode_step
from repro_torch.kernels import decode_attention as decode_attention_kernel

Params = Dict[str, Any]

NEG_INF = -1e30
KERNEL_IMPLS = ("kernel", "plain")


def _check_impl(impl: str) -> None:
    if impl not in KERNEL_IMPLS:
        raise ValueError(f"kernel_impl must be one of {KERNEL_IMPLS}, not "
                         f"{impl!r}")


# ---------------------------------------------------------------- init utils
def dense_init(gen, d_in, d_out, dtype, device):
    scale = 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


def embed_init(gen, vocab, d, dtype, device):
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


# --------------------------------------------------------------------- norms
def init_norm(cfg, dtype, device):
    p = {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    if cfg.norm == "ln":
        p["bias"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return p


def apply_norm(p, x, cfg):
    xf = x.float()
    if cfg.norm == "rms":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + cfg.norm_eps)
        return (y * p["scale"].float()).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------- RoPE
def rope_dim(cfg) -> int:
    d = int(cfg.d_head * cfg.rope_pct)
    return d - d % 2


def apply_rope(x, positions, cfg):
    """x: (B, S, H, dh); positions: (B, S) int.  The frequencies are built
    in fp32, as the JAX package builds them."""
    rd = rope_dim(cfg)
    if rd == 0:
        return x
    half = rd // 2
    theta = torch.tensor(cfg.rope_theta, dtype=torch.float32, device=x.device)
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[..., None] * freqs                  # (B,S,half)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    xr, xp = x[..., :rd], x[..., rd:]
    x1, x2 = xr[..., :half], xr[..., half:]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return torch.cat([rot.to(x.dtype), xp], -1)


# ----------------------------------------------------------------- attention
def init_attention(cfg, gen, dtype, device) -> Params:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {"wq": dense_init(gen, d, h * dh, dtype, device),
         "wk": dense_init(gen, d, kv * dh, dtype, device),
         "wv": dense_init(gen, d, kv * dh, dtype, device),
         "wo": dense_init(gen, h * dh, d, dtype, device)}
    zeros = lambda n: torch.zeros((n,), dtype=dtype, device=device)
    if cfg.qkv_bias:
        p["bq"], p["bk"], p["bv"] = zeros(h * dh), zeros(kv * dh), \
            zeros(kv * dh)
    if cfg.out_bias:
        p["bo"] = zeros(d)
    return p


def _qkv(p, x, cfg, positions, rope: bool):
    B, S, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, h, dh)
    k = k.reshape(B, S, kv, dh)
    v = v.reshape(B, S, kv, dh)
    if rope:
        q = apply_rope(q, positions, cfg)
        k = apply_rope(k, positions, cfg)
    return q, k, v


def _out_proj(p, o, cfg):
    B, S = o.shape[:2]
    out = o.reshape(B, S, cfg.n_heads * cfg.d_head) @ p["wo"]
    if cfg.out_bias:
        out = out + p["bo"]
    return out


def _sdpa(q, k, v, mask, cfg):
    """Masked softmax attention. q:(B,Sq,H,dh) k/v:(B,Sk,kv,dh),
    mask:(B,Sq,Sk) bool (True = attend). Returns (B,Sq,H,dh)."""
    B, Sq, H, dh = q.shape
    kv = k.shape[2]
    g = H // kv
    qg = q.reshape(B, Sq, kv, g, dh) / math.sqrt(dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    s = torch.where(mask[:, None, None, :, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", w.to(v.dtype), v)
    return o.reshape(B, Sq, H, dh)


def full_attention(p, x, cfg, positions, *, rope=True,
                   window: Optional[int] = None,
                   kernel_impl: str = "kernel"):
    """Causal self-attention over a whole sequence whose positions are
    0..S-1 (prompt prefill), through the flash kernel.  Returns
    (out, (k, v)) with k/v (B,S,kv,dh) for the cache.
    The JAX package's non-causal and ``kv_override`` paths serve the
    encoder-decoder family only and are not ported."""
    _check_impl(kernel_impl)
    q, k, v = _qkv(p, x, cfg, positions, rope)
    if kernel_impl == "kernel":
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True, window=window)
        o = o.transpose(1, 2)
    else:
        mask = positions[:, :, None] >= positions[:, None, :]
        if window is not None:
            mask &= positions[:, :, None] - positions[:, None, :] < window
        o = _sdpa(q, k, v, mask, cfg)
    return _out_proj(p, o, cfg), (k, v)


# ---------------------------------------------------------- striped caches
def init_kv_cache(cfg, batch, max_len, dtype, device, *, window=None):
    """Ring-buffer (windowed) or linear KV cache for ONE attention layer:
    {"k","v": (batch, W, kv, dh), "pos": (batch, W) int32 stored position
    per ring slot, -1 = empty}; W = ``window`` or else ``max_len``.  The
    slot (batch row) is axis 0 of every leaf."""
    W = window if window is not None else max_len
    kv, dh = cfg.n_kv_heads, cfg.d_head
    return {"k": torch.zeros((batch, W, kv, dh), dtype=dtype, device=device),
            "v": torch.zeros((batch, W, kv, dh), dtype=dtype, device=device),
            "pos": torch.full((batch, W), -1, dtype=torch.int32,
                              device=device)}


def kv_cache_from_prefill(cfg, k, v, positions, max_len, *, window=None):
    """Prefill K/V (B,S,kv,dh) at ``positions`` (B,S) as a decode cache of
    ring width W = min(window, max_len) (``max_len`` without a window).
    When S > W only the last W entries are kept, each at its ring slot
    ``pos % W``.  (The JAX package sizes this ring at ``window`` even when
    ``max_len`` is shorter; such a ring never wraps, so the outputs are
    the same, and the width then equals ``init_cache``'s.)"""
    B, S = k.shape[0], k.shape[1]
    W = min(window, max_len) if window is not None else max_len
    cache = init_kv_cache(cfg, B, max_len, k.dtype, k.device, window=W)
    if S <= W:
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
        cache["pos"][:, :S] = positions.to(torch.int32)
    else:
        kt, vt, pt = k[:, -W:], v[:, -W:], positions[:, -W:].long()
        bidx = torch.arange(B, device=k.device)[:, None]
        slot = pt % W
        cache["k"][bidx, slot] = kt
        cache["v"][bidx, slot] = vt
        cache["pos"][bidx, slot] = pt.to(torch.int32)
    return cache


def decode_attention(p, x, cache, cfg, positions, *, rope=True,
                     window: Optional[int] = None,
                     kernel_impl: str = "kernel"):
    """Single-token decode against the striped ring cache of one layer.

    x: (B,1,d); positions: (B,) current positions; cache: {"k","v","pos"}
    of ring width W.  The new token's K/V and position are written at ring
    slot ``positions % W`` first (plain indexing, in place), then the
    token attends over every slot whose stored position is valid,
    through the ring decode kernel.  The JAX package's ``cross_kv`` path
    serves the encoder-decoder family only and is not ported.  Returns
    (out (B,1,d), cache)."""
    _check_impl(kernel_impl)
    B = x.shape[0]
    q, k_new, v_new = _qkv(p, x, cfg, positions[:, None], rope)
    W = cache["k"].shape[1]
    pos = positions.long()
    bidx = torch.arange(B, device=x.device)
    slot = pos % W
    cache["k"][bidx, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, slot] = v_new[:, 0].to(cache["v"].dtype)
    cache["pos"][bidx, slot] = pos.to(torch.int32)
    if kernel_impl == "kernel":
        o = decode_attention_kernel(q[:, 0], cache["k"], cache["v"],
                                    cache["pos"], positions, window=window)
        o = o[:, None]
    else:
        spos = cache["pos"].long()
        valid = (spos >= 0) & (spos <= pos[:, None])
        if window is not None:
            valid &= pos[:, None] - spos < window
        o = _sdpa(q, cache["k"], cache["v"], valid[:, None, :], cfg)
    return _out_proj(p, o, cfg), cache


def paged_decode_attention(p, x, pool, cfg, positions, page_table, *,
                           rope=True, window: Optional[int] = None,
                           kernel_impl: str = "kernel"):
    """Single-token decode against the shared page pool.

    x: (B,1,d) with B == n_slots; positions: (B,) int; pool: {"k","v"} of
    shape (P, page_size, kv, dh) whose LAST page is the trash page;
    page_table: (B, MP) int32 page ids, -1 empty.  The new token's K/V land
    in the page covering ``positions`` (FREE rows: the trash page), then
    attention runs over the slot's own pages, in the fused decode-step
    kernel.  The pools are updated in place.
    Returns (out (B,1,d), pool)."""
    _check_impl(kernel_impl)
    B = x.shape[0]
    kv, dh = cfg.n_kv_heads, cfg.d_head
    q, k_new, v_new = _qkv(p, x, cfg, positions[:, None], rope)
    if kernel_impl == "kernel":
        o, _, _ = paged_decode_step(q[:, 0], k_new[:, 0], v_new[:, 0],
                                    pool["k"], pool["v"], page_table,
                                    positions + 1, window=window)
        o = o[:, None]
    else:
        P, ps = pool["k"].shape[0], pool["k"].shape[1]
        MP = page_table.shape[1]
        table = page_table.long()
        pos = positions.long()
        bidx = torch.arange(B, device=x.device)
        pg = table[bidx, (pos // ps).clamp(0, MP - 1)]
        pg = torch.where(pg >= 0, pg, P - 1)              # FREE -> trash
        pool["k"][pg, pos % ps] = k_new[:, 0].to(pool["k"].dtype)
        pool["v"][pg, pos % ps] = v_new[:, 0].to(pool["v"].dtype)
        pt = torch.where(table >= 0, table, P - 1)
        kg = pool["k"][pt].reshape(B, MP * ps, kv, dh)
        vg = pool["v"][pt].reshape(B, MP * ps, kv, dh)
        t = torch.arange(MP * ps, device=x.device)[None]
        valid = (t <= pos[:, None]) & (
            torch.repeat_interleave(table, ps, dim=1) >= 0)
        if window is not None:
            valid &= pos[:, None] - t < window
        o = _sdpa(q, kg, vg, valid[:, None, :], cfg)
    return _out_proj(p, o, cfg), pool


def paged_suffix_attention(p, x, pool, cfg, positions, pt_row, *,
                           rope=True, window: Optional[int] = None):
    """Suffix-only prefill against the shared page pool (prefix sharing).

    x: (1,S,d), the un-cached suffix of one prompt whose shared prefix K/V
    already sit in the slot's leading pages; positions: (1,S) absolute
    positions; pt_row: (MP,) the slot's page-table row.  The suffix K/V are
    written into the slot's pages (in place), then every suffix query
    attends over the slot's whole table expansion, masked to its causal
    position.  No TPU kernel covers this path: plain tensor ops, as in the
    JAX package.  Returns (out (1,S,d), pool)."""
    kv, dh = cfg.n_kv_heads, cfg.d_head
    q, k_new, v_new = _qkv(p, x, cfg, positions, rope)       # (1,S,.,dh)
    P, ps = pool["k"].shape[0], pool["k"].shape[1]
    MP = pt_row.shape[0]
    row = pt_row.long()
    tpos = positions[0].long()                               # (S,)
    pg = row[(tpos // ps).clamp(0, MP - 1)]
    pg = torch.where(pg >= 0, pg, P - 1)                     # FREE -> trash
    pool["k"][pg, tpos % ps] = k_new[0].to(pool["k"].dtype)
    pool["v"][pg, tpos % ps] = v_new[0].to(pool["v"].dtype)
    pt = torch.where(row >= 0, row, P - 1)
    kg = pool["k"][pt].reshape(1, MP * ps, kv, dh)
    vg = pool["v"][pt].reshape(1, MP * ps, kv, dh)
    t = torch.arange(MP * ps, device=x.device)[None, None, :]
    qpos = positions.long()[:, :, None]                      # (1,S,1)
    valid = (t <= qpos) & (torch.repeat_interleave(row, ps) >= 0)[None, None]
    if window is not None:
        valid &= qpos - t < window
    o = _sdpa(q, kg, vg, valid, cfg)
    return _out_proj(p, o, cfg), pool


# ----------------------------------------------------------------------- FFN
def gated_mlp(cfg) -> bool:
    return cfg.act == "silu" or cfg.family == "hybrid"


def init_ffn(cfg, gen, dtype, device, d_ff=None) -> Params:
    d_ff = d_ff or cfg.d_ff
    p = {"w_in": dense_init(gen, cfg.d_model, d_ff, dtype, device),
         "w_out": dense_init(gen, d_ff, cfg.d_model, dtype, device)}
    if gated_mlp(cfg):
        p["w_gate"] = dense_init(gen, cfg.d_model, d_ff, dtype, device)
    if cfg.mlp_bias:
        p["b_in"] = torch.zeros((d_ff,), dtype=dtype, device=device)
        p["b_out"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return p


def _act(cfg, x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if cfg.act == "silu" else F.gelu(x, approximate="tanh")


def apply_ffn(p, x, cfg):
    h = x @ p["w_in"]
    if cfg.mlp_bias:
        h = h + p["b_in"]
    if "w_gate" in p:
        h = _act(cfg, x @ p["w_gate"]) * h
    else:
        h = _act(cfg, h)
    out = h @ p["w_out"]
    if cfg.mlp_bias:
        out = out + p["b_out"]
    return out

