"""Dense decoder model: init / forward / paged decode, in PyTorch.

The counterpart of ``repro.models.model`` for ``family="dense"`` (other
families raise ``NotImplementedError``).  Parameters are a plain dict:
``{"embed", "layers": [per-layer dict, ...], "final_norm"}`` plus
``"head"`` when embeddings are not tied.  The JAX package stacks the trunk
for ``lax.scan``; here a Python loop runs over ``layers`` in order
(``repro_torch.bridge`` unstacks JAX parameters into this layout).

The paged cache is ``{"layers": [{"k","v"}, ...], "pos", "pages"}``: one
K and V page pool per attention layer, each (n_pages + 1, page_size, kv,
dh) with the trash page at index n_pages, the per-slot positions and the
shared (n_slots, max_pages) int32 page table.  Pools are updated in place.

API:
  init_params(cfg, seed, dtype, device)             -> params
  forward(cfg, params, batch, build_cache=...)      -> {"logits", "kv"?}
  decode_step(cfg, params, cache, tokens, positions) -> (logits, cache)
  init_paged_cache(cfg, n_slots, ...)                -> zeroed paged cache
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.cache_ops import (DEFAULT_PAGE_SIZE, paged_geometry,
                                          pages_for)

Params = Dict[str, Any]


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the PyTorch port covers family='dense' so far, not "
            f"{cfg.family!r} ({cfg.arch_id})")
    for entry in cfg.layer_pattern:
        mixer, ffn = entry.split(":")
        if mixer not in ("attn", "attn_full") or ffn != "dense":
            raise NotImplementedError(f"layer entry {entry!r} is not ported")


def _mixer_window(cfg: ModelConfig, mixer: str) -> Optional[int]:
    """Effective attention window for masking: ``attn_full`` layers are
    global, ``attn`` layers use the config's window (None = global).  The
    JAX package's long-context fallback (windowing ``attn_full`` past
    100k-token caches) is not ported."""
    return None if mixer == "attn_full" else cfg.window


def _entries(cfg: ModelConfig) -> List[str]:
    return [cfg.layer_pattern[i % cfg.pattern_len]
            for i in range(cfg.n_layers)]


# ===================================================================== init
def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device=None) -> Params:
    """Random weights with the JAX package's distributions (normal
    embeddings ×0.02, normal projections ×1/sqrt(d_in), unit norms, zero
    biases), drawn from a ``torch.Generator`` seeded with ``seed`` on the
    target device (default: the GPU; pass ``device="cpu"`` for the CPU)."""
    _check_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p: Params = {"embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                       dtype, dev)}
    p["layers"] = [{"norm1": L.init_norm(cfg, dtype, dev),
                    "attn": L.init_attention(cfg, gen, dtype, dev),
                    "norm2": L.init_norm(cfg, dtype, dev),
                    "ffn": L.init_ffn(cfg, gen, dtype, dev)}
                   for _ in range(cfg.n_layers)]
    p["final_norm"] = L.init_norm(cfg, dtype, dev)
    if not cfg.tie_embeddings:
        p["head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size, dtype, dev)
    return p


# ================================================================== embed
def _embed_tokens(cfg: ModelConfig, params: Params, tokens):
    return params["embed"][tokens]


def _unembed(cfg: ModelConfig, params: Params, x):
    x = L.apply_norm(params["final_norm"], x, cfg)
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["head"]


def _ffn_block(p: Params, x, cfg: ModelConfig):
    return x + L.apply_ffn(p["ffn"], L.apply_norm(p["norm2"], x, cfg), cfg)


# ================================================================= forward
@torch.no_grad()
def forward(cfg: ModelConfig, params: Params, batch: Dict[str, Any], *,
            build_cache: bool = False, attn_impl: str = "kernel"
            ) -> Dict[str, Any]:
    """Prefill forward.  batch: {"tokens": (B, S)}; positions are 0..S-1.
    Returns {"logits": (B,S,V)} plus, with ``build_cache``, "kv": one
    (k, v) pair of shape (B,S,kv,dh) per layer, ready for
    ``paged_prefill_scatter``."""
    _check_dense(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    rope = cfg.rope_pct > 0.0
    x = _embed_tokens(cfg, params, tokens)
    kv: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for lp, entry in zip(params["layers"], _entries(cfg)):
        h = L.apply_norm(lp["norm1"], x, cfg)
        a, (k, v) = L.full_attention(
            lp["attn"], h, cfg, positions, rope=rope,
            window=_mixer_window(cfg, entry.split(":")[0]),
            attn_impl=attn_impl)
        x = _ffn_block(lp, x + a, cfg)
        if build_cache:
            kv.append((k, v))
    out: Dict[str, Any] = {"logits": _unembed(cfg, params, x)}
    if build_cache:
        out["kv"] = kv
    return out


# ============================================================== decode step
@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Params, cache, tokens, positions,
                *, attn_impl: str = "kernel"):
    """tokens: (B,) last generated token; positions: (B,).  Every layer
    appends the token's K/V to the paged pools (in place) and attends over
    the slot's pages.  Returns (logits (B, V), cache) with ``cache["pos"]``
    advanced to positions + 1."""
    _check_dense(cfg)
    rope = cfg.rope_pct > 0.0
    x = _embed_tokens(cfg, params, tokens[:, None])
    for lp, pool, entry in zip(params["layers"], cache["layers"],
                               _entries(cfg)):
        h = L.apply_norm(lp["norm1"], x, cfg)
        a, _ = L.paged_decode_attention(
            lp["attn"], h, pool, cfg, positions, cache["pages"], rope=rope,
            window=_mixer_window(cfg, entry.split(":")[0]),
            attn_impl=attn_impl)
        x = _ffn_block(lp, x + a, cfg)
    logits = _unembed(cfg, params, x)[:, 0]
    cache["pos"] = (positions + 1).to(torch.int32)
    return logits, cache


# ============================================================ paged caches
def init_paged_cache(cfg: ModelConfig, n_slots: int, *, page_size=None,
                     n_pages: Optional[int] = None,
                     max_pages: Optional[int] = None,
                     max_len: Optional[int] = None, dtype=torch.float32,
                     device=None):
    """Zeroed paged decode cache: per-layer page pools carry ONE extra
    trash page (index n_pages) that absorbs writes from FREE slots, and
    the top level holds the shared page table (all -1).
    ``n_pages``/``max_pages`` default from ``max_len``."""
    _check_dense(cfg)
    dev = resolve_device(device)
    if page_size is None:
        page_size = DEFAULT_PAGE_SIZE
    if page_size == "auto" or max_pages is None or n_pages is None:
        if max_len is None:
            raise ValueError("page_size='auto' or defaulted n_pages/"
                             "max_pages need max_len")
        page_size, _ = paged_geometry(cfg, n_slots, max_len,
                                      page_size=page_size)
        if max_pages is None:
            max_pages = pages_for(max_len, page_size)
        if n_pages is None:
            n_pages = n_slots * max_pages
    shape = (n_pages + 1, page_size, cfg.n_kv_heads, cfg.d_head)
    pools = [{"k": torch.zeros(shape, dtype=dtype, device=dev),
              "v": torch.zeros(shape, dtype=dtype, device=dev)}
             for _ in range(cfg.n_layers)]
    return {"layers": pools,
            "pos": torch.zeros((n_slots,), dtype=torch.int32, device=dev),
            "pages": torch.full((n_slots, max_pages), -1, dtype=torch.int32,
                                device=dev)}


def paged_prefill_scatter(cfg: ModelConfig, cache, kv, slot: int, pt_row):
    """Write a batch-1 prefill's K/V (``forward(build_cache=True)["kv"]``)
    straight into ``slot``'s pages, in place.  Whole pages are written:
    the tail of the prompt's last page gets zeros, as the JAX package's
    page-granular scatter of its zero-padded ring cache gives, so the pools
    match it byte for byte outside the trash page.  Unallocated table
    entries land on the trash page."""
    S = kv[0][0].shape[1]
    MP = pt_row.shape[0]
    P, ps = cache["layers"][0]["k"].shape[:2]
    npg = max(min(-(-S // ps), MP), 1)
    row = pt_row[:npg].long()
    pg = torch.where(row >= 0, row, P - 1)
    n = min(S, npg * ps)
    for pool, (k, v) in zip(cache["layers"], kv):
        for name, src in (("k", k), ("v", v)):
            dst = pool[name]
            pages = torch.zeros((npg * ps,) + tuple(dst.shape[2:]),
                                dtype=dst.dtype, device=dst.device)
            pages[:n] = src[0, :n].to(dst.dtype)
            dst[pg] = pages.reshape((npg, ps) + tuple(dst.shape[2:]))
    cache["pos"][slot] = S
    return cache


def supports_prefix_sharing(cfg: ModelConfig) -> bool:
    """CoW prefix sharing covers configs whose every layer keeps paged
    attention state (every dense config)."""
    return cfg.family != "encdec" and all(
        e.split(":")[0] in ("attn", "attn_full") for e in _entries(cfg))


@torch.no_grad()
def paged_suffix_prefill(cfg: ModelConfig, params: Params, cache, tokens,
                         slot: int, start: int):
    """Prefill ONLY the un-cached suffix of a prompt whose shared prefix
    already sits in ``slot``'s leading pages (prefix sharing).

    tokens: (1, S_suffix); ``start`` is the shared token count, so
    positions run start..start+S-1.  Each layer writes the suffix K/V into
    the slot's pages and attends suffix queries over the slot's table.
    Returns (last-position logits (1, V), cache)."""
    _check_dense(cfg)
    S = tokens.shape[1]
    pt_row = cache["pages"][slot]
    positions = (start + torch.arange(S, device=tokens.device))[None]
    rope = cfg.rope_pct > 0.0
    x = _embed_tokens(cfg, params, tokens)
    for lp, pool, entry in zip(params["layers"], cache["layers"],
                               _entries(cfg)):
        h = L.apply_norm(lp["norm1"], x, cfg)
        a, _ = L.paged_suffix_attention(
            lp["attn"], h, pool, cfg, positions, pt_row, rope=rope,
            window=_mixer_window(cfg, entry.split(":")[0]))
        x = _ffn_block(lp, x + a, cfg)
    logits = _unembed(cfg, params, x)[:, -1]
    cache["pos"][slot] = start + S
    return logits, cache


def paged_copy_page(cfg: ModelConfig, cache, src: int, dst: int):
    """Fork-on-write device copy: duplicate pool page ``src`` into ``dst``
    in every layer's pools, in place."""
    for pool in cache["layers"]:
        pool["k"][dst] = pool["k"][src]
        pool["v"][dst] = pool["v"][src]
    return cache
