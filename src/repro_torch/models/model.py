"""Decoder model (dense, hybrid, ssm): init / forward / decode, in PyTorch.

The counterpart of ``repro.models.model`` for ``family="dense"``,
``family="hybrid"`` (RG-LRU + local attention, RecurrentGemma) and
``family="ssm"`` (mLSTM + sLSTM blocks, xLSTM); other families raise
``NotImplementedError``.  Parameters are a plain dict:
``{"embed", "layers": [per-layer dict, ...], "final_norm"}`` plus
``"head"`` when embeddings are not tied; a layer holds ``"attn"``,
``"rec"``, ``"mlstm"`` or ``"slstm"`` by its pattern entry, and
``"norm2"``/``"ffn"`` when its ffn is ``dense`` (xLSTM blocks own their
projections: ffn ``none``).  The JAX package stacks the trunk for
``lax.scan``; here a Python loop runs over ``layers`` in order
(``repro_torch.bridge`` unstacks JAX parameters into this layout).

Two decode-cache layouts, both ``{"layers": [per-layer entry, ...],
"pos": (n_slots,) int32, ...}``; recurrent layers keep their state
(``{"h","conv"}`` RG-LRU, ``{"C","n","m","conv"}`` mLSTM,
``{"c","n","h","m"}`` sLSTM) slot-indexed in either:
- striped (``init_cache``): each attention layer holds a ring
  ``{"k","v": (n_slots, W, kv, dh), "pos": (n_slots, W)}`` of width
  W = min(window, max_len) (``max_len`` for global layers);
- paged (``init_paged_cache``): each attention layer holds one K and V
  page pool (n_pages + 1, page_size, kv, dh) with the trash page at
  n_pages, and the top level the shared (n_slots, max_pages) int32 page
  table ``"pages"``.
Every leaf keeps the slot on axis 0 (the pools have no slot axis).
Caches are updated in place.

API:
  init_params(cfg, seed, dtype, device)             -> params
  forward(cfg, params, batch, build_cache=...)      -> {"logits", "kv"?}
  decode_step(cfg, params, cache, tokens, positions) -> (logits, cache)
  init_cache(cfg, n_slots, max_len, ...)            -> zeroed striped cache
  cache_from_prefill(cfg, kv, max_len, n_tokens)    -> striped cache
  init_paged_cache(cfg, n_slots, ...)               -> zeroed paged cache
  paged_pack / paged_adopt_scatter / pack_single_cache -> the PackedKV wire
  make_batch(cfg, batch, seq_len, seed, device)     -> {"tokens"}
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R
from repro_torch.models import xlstm as X
from repro_torch.models.cache_ops import (DEFAULT_PAGE_SIZE, PackedKV,
                                          paged_geometry, pages_for)

Params = Dict[str, Any]
FAMILIES = ("dense", "hybrid", "ssm")
ATTN_MIXERS = ("attn", "attn_full")
STATE_MIXERS = ("rec", "mlstm", "slstm")       # slot-indexed state, no K/V
_INIT = {"rec": R.init_rec, "mlstm": X.init_mlstm, "slstm": X.init_slstm}
_INIT_STATE = {"rec": R.init_rec_state, "mlstm": X.init_mlstm_state,
               "slstm": X.init_slstm_state}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the PyTorch port covers families {FAMILIES} so far, not "
            f"{cfg.family!r} ({cfg.arch_id})")
    for entry in cfg.layer_pattern:
        mixer, ffn = entry.split(":")
        if mixer not in ATTN_MIXERS + STATE_MIXERS or \
                ffn not in ("dense", "none"):
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


def _mixers(cfg: ModelConfig) -> List[str]:
    return [e.split(":")[0] for e in _entries(cfg)]


# ===================================================================== init
def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device=None) -> Params:
    """Random weights with the JAX package's distributions (normal
    embeddings ×0.02, normal projections ×1/sqrt(d_in), unit norms, zero
    biases, RG-LRU ``lam`` and the xLSTM gates and recurrence in fp32),
    drawn from a ``torch.Generator`` seeded with ``seed`` on the target
    device (default: the GPU; pass ``device="cpu"`` for the CPU)."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p: Params = {"embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                       dtype, dev)}
    layers = []
    for entry in _entries(cfg):
        mixer, ffn = entry.split(":")
        lp = {"norm1": L.init_norm(cfg, dtype, dev)}
        if mixer in STATE_MIXERS:
            lp[mixer] = _INIT[mixer](cfg, gen, dtype, dev)
        else:
            lp["attn"] = L.init_attention(cfg, gen, dtype, dev)
        if ffn == "dense":
            lp["norm2"] = L.init_norm(cfg, dtype, dev)
            lp["ffn"] = L.init_ffn(cfg, gen, dtype, dev)
        layers.append(lp)
    p["layers"] = layers
    p["final_norm"] = L.init_norm(cfg, dtype, dev)
    if not cfg.tie_embeddings:
        p["head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size, dtype, dev)
    return p


# ================================================================== embed
def _embed_tokens(cfg: ModelConfig, params: Params, tokens):
    x = params["embed"][tokens]
    if cfg.family == "hybrid":          # gemma-style embedding scale
        # JAX multiplies by the Python float cast to the activation dtype
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def _unembed(cfg: ModelConfig, params: Params, x):
    x = L.apply_norm(params["final_norm"], x, cfg)
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["head"]


def _ffn_block(p: Params, x, cfg: ModelConfig):
    if "ffn" not in p:                  # ffn "none": the block owns its MLP
        return x
    return x + L.apply_ffn(p["ffn"], L.apply_norm(p["norm2"], x, cfg), cfg)


# ============================================================ layer (full)
def _apply_layer_full(lp: Params, x, cfg: ModelConfig, mixer: str,
                      positions, kernel_impl: str):
    """One layer over a whole sequence whose positions are 0..S-1: the
    mixer, its residual and the ffn block.  Returns (x, state): the
    attention (k, v) (B,S,kv,dh) or the recurrent layer's final state."""
    h = L.apply_norm(lp["norm1"], x, cfg)
    if mixer == "rec":
        a, state = R.apply_rec(lp["rec"], h, cfg, kernel_impl=kernel_impl)
    elif mixer == "mlstm":
        a, state = X.apply_mlstm(lp["mlstm"], h, cfg,
                                 kernel_impl=kernel_impl)
    elif mixer == "slstm":
        a, state = X.apply_slstm(lp["slstm"], h, cfg)
    else:
        a, state = L.full_attention(
            lp["attn"], h, cfg, positions, rope=cfg.rope_pct > 0.0,
            window=_mixer_window(cfg, mixer), kernel_impl=kernel_impl)
    return _ffn_block(lp, x + a, cfg), state


# ================================================================= forward
@torch.no_grad()
def forward(cfg: ModelConfig, params: Params, batch: Dict[str, Any], *,
            build_cache: bool = False, kernel_impl: str = "kernel",
            last_only: bool = False) -> Dict[str, Any]:
    """Prefill forward.  batch: {"tokens": (B, S)}; positions are 0..S-1.
    Returns {"logits": (B,S,V)} ((B,1,V) for the last position alone with
    ``last_only``: the engines read no other row, and at a 256k vocabulary
    the full tensor is gigabytes) plus, with ``build_cache``, "kv": per
    layer either the attention (k, v) of shape (B,S,kv,dh) or the
    recurrent layer's final state dict.  ``kernel_impl``: see
    ``models.layers``."""
    _check_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = _embed_tokens(cfg, params, tokens)
    kv: List[Any] = []
    for lp, mixer in zip(params["layers"], _mixers(cfg)):
        x, state = _apply_layer_full(lp, x, cfg, mixer, positions,
                                     kernel_impl)
        if build_cache:
            kv.append(state)
    if last_only:
        x = x[:, -1:]
    out: Dict[str, Any] = {"logits": _unembed(cfg, params, x)}
    if build_cache:
        out["kv"] = kv
    return out


# ============================================================== decode step
@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Params, cache, tokens, positions,
                *, kernel_impl: str = "kernel"):
    """tokens: (B,) last generated token; positions: (B,).  A cache with a
    ``"pages"`` table decodes attention layers against the paged pools
    (the fused step kernel appends and attends); otherwise each attention
    layer writes its ring slot and attends over the ring (the ring decode
    kernel).  Recurrent layers take the single-step update either way.
    Caches are updated in place.  Returns (logits (B, V), cache) with
    ``cache["pos"]`` advanced to positions + 1."""
    _check_family(cfg)
    rope = cfg.rope_pct > 0.0
    paged = "pages" in cache
    x = _embed_tokens(cfg, params, tokens[:, None])
    for i, (lp, mixer) in enumerate(zip(params["layers"], _mixers(cfg))):
        h = L.apply_norm(lp["norm1"], x, cfg)
        entry = cache["layers"][i]
        if mixer == "rec":
            a, cache["layers"][i] = R.apply_rec_step(lp["rec"], h, cfg, entry)
        elif mixer == "mlstm":
            a, cache["layers"][i] = X.apply_mlstm_step(lp["mlstm"], h, cfg,
                                                       entry)
        elif mixer == "slstm":
            a, cache["layers"][i] = X.apply_slstm_step(lp["slstm"], h, cfg,
                                                       entry)
        elif paged:
            a, _ = L.paged_decode_attention(
                lp["attn"], h, entry, cfg, positions, cache["pages"],
                rope=rope, window=_mixer_window(cfg, mixer),
                kernel_impl=kernel_impl)
        else:
            a, _ = L.decode_attention(
                lp["attn"], h, entry, cfg, positions, rope=rope,
                window=_mixer_window(cfg, mixer), kernel_impl=kernel_impl)
        x = _ffn_block(lp, x + a, cfg)
    logits = _unembed(cfg, params, x)[:, 0]
    cache["pos"] = (positions + 1).to(torch.int32)
    return logits, cache


# ========================================================== striped caches
def _ring_width(cfg: ModelConfig, mixer: str, max_len: int) -> int:
    win = _mixer_window(cfg, mixer)
    return min(win, max_len) if win is not None else max_len


def init_cache(cfg: ModelConfig, n_slots: int, max_len: int, *,
               dtype=torch.float32, device=None):
    """Zeroed striped decode cache: a ring per attention layer of width
    W = min(window, max_len) (``max_len`` for global layers), the state
    per recurrent layer, and the per-slot positions."""
    _check_family(cfg)
    dev = resolve_device(device)
    layers = []
    for mixer in _mixers(cfg):
        if mixer in STATE_MIXERS:
            layers.append(_INIT_STATE[mixer](cfg, n_slots, dtype, dev))
        else:
            layers.append(L.init_kv_cache(
                cfg, n_slots, max_len, dtype, dev,
                window=_ring_width(cfg, mixer, max_len)))
    return {"layers": layers,
            "pos": torch.zeros((n_slots,), dtype=torch.int32, device=dev)}


def _batch_rows(entry):
    """(batch size, device) of one layer's prefill output."""
    t = next(iter(entry.values())) if isinstance(entry, dict) else entry[0]
    return t.shape[0], t.device


def cache_from_prefill(cfg: ModelConfig, kv, max_len: int, n_tokens: int):
    """The striped decode cache of a prefill batch of ``n_tokens``-token
    prompts, from ``forward(build_cache=True)["kv"]``: each attention
    layer's K/V become its ring (the last W tokens at their ring slots
    when the prompt is longer than the ring), each recurrent layer's final
    state is kept, and every row's position is the prompt length."""
    layers = []
    for mixer, entry in zip(_mixers(cfg), kv):
        if mixer in STATE_MIXERS:
            layers.append(entry)
            continue
        k, v = entry
        B, S = k.shape[0], k.shape[1]
        positions = torch.arange(S, device=k.device).expand(B, S)
        layers.append(L.kv_cache_from_prefill(
            cfg, k, v, positions, max_len,
            window=_ring_width(cfg, mixer, max_len)))
    B, dev = _batch_rows(kv[0])
    return {"layers": layers,
            "pos": torch.full((B,), n_tokens, dtype=torch.int32,
                              device=dev)}


# ============================================================== batch maker
def make_batch(cfg: ModelConfig, batch: int, seq_len: int, seed: int = 0,
               device=None) -> Dict[str, torch.Tensor]:
    """Random token batch {"tokens": (batch, seq_len) int64} drawn with
    numpy from ``seed`` (the ported families carry tokens only)."""
    _check_family(cfg)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq_len))
    return {"tokens": torch.from_numpy(toks).to(resolve_device(device))}


# ============================================================ paged caches
def init_paged_cache(cfg: ModelConfig, n_slots: int, *, page_size=None,
                     n_pages: Optional[int] = None,
                     max_pages: Optional[int] = None,
                     max_len: Optional[int] = None, dtype=torch.float32,
                     device=None):
    """Zeroed paged decode cache: per-attention-layer page pools carry ONE
    extra trash page (index n_pages) that absorbs writes from FREE slots,
    recurrent layers hold their state per slot, and the top level holds
    the shared page table (all -1), also when no layer has pools (xLSTM:
    the engine still allocates pages, as the JAX one does).
    ``n_pages``/``max_pages`` default from ``max_len``."""
    _check_family(cfg)
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
    layers = [_INIT_STATE[mixer](cfg, n_slots, dtype, dev)
              if mixer in STATE_MIXERS
              else {"k": torch.zeros(shape, dtype=dtype, device=dev),
                    "v": torch.zeros(shape, dtype=dtype, device=dev)}
              for mixer in _mixers(cfg)]
    return {"layers": layers,
            "pos": torch.zeros((n_slots,), dtype=torch.int32, device=dev),
            "pages": torch.full((n_slots, max_pages), -1, dtype=torch.int32,
                                device=dev)}


def paged_prefill_scatter(cfg: ModelConfig, cache, kv, slot: int, pt_row,
                          n_tokens: int):
    """Write a batch-1 prefill of an ``n_tokens``-token prompt
    (``forward(build_cache=True)["kv"]``) into ``slot``, in place:
    attention K/V straight into the slot's pages, recurrent state into the
    slot's row, and the slot's position.  Whole pages are written: the
    tail of the prompt's last page gets zeros, as the JAX package's
    page-granular scatter of its zero-padded ring cache gives, so the pools
    match it byte for byte outside the trash page.  Every prompt token is
    written, also those a window has left behind (the JAX package writes
    only its ring's last W): decode masks them, so the outputs are the
    same.  Unallocated table entries land on the trash page."""
    attn = [(pool, e) for pool, e, mixer in zip(cache["layers"], kv,
                                                 _mixers(cfg))
            if mixer in ATTN_MIXERS]
    for state, e, mixer in zip(cache["layers"], kv, _mixers(cfg)):
        if mixer in STATE_MIXERS:
            for name, dst in state.items():
                dst[slot] = e[name][0].to(dst.dtype)
    cache["pos"][slot] = n_tokens
    if not attn:
        return cache
    MP = pt_row.shape[0]
    P, ps = attn[0][0]["k"].shape[:2]
    npg = max(min(-(-n_tokens // ps), MP), 1)
    row = pt_row[:npg].long()
    pg = torch.where(row >= 0, row, P - 1)
    n = min(n_tokens, npg * ps)
    for pool, (k, v) in attn:
        for name, src in (("k", k), ("v", v)):
            dst = pool[name]
            pages = torch.zeros((npg * ps,) + tuple(dst.shape[2:]),
                                dtype=dst.dtype, device=dst.device)
            pages[:n] = src[0, :n].to(dst.dtype)
            dst[pg] = pages.reshape((npg, ps) + tuple(dst.shape[2:]))
    return cache


def supports_prefix_sharing(cfg: ModelConfig) -> bool:
    """CoW prefix sharing covers configs whose every layer keeps paged
    attention state (every dense config): recurrent layers fold the whole
    prefix into one state vector, which cannot be shared by pages, so the
    hybrid and ssm families are excluded."""
    return cfg.family != "encdec" and all(
        mixer in ATTN_MIXERS for mixer in _mixers(cfg))


@torch.no_grad()
def paged_suffix_prefill(cfg: ModelConfig, params: Params, cache, tokens,
                         slot: int, start: int):
    """Prefill ONLY the un-cached suffix of a prompt whose shared prefix
    already sits in ``slot``'s leading pages (prefix sharing).

    tokens: (1, S_suffix); ``start`` is the shared token count, so
    positions run start..start+S-1.  Each layer writes the suffix K/V into
    the slot's pages and attends suffix queries over the slot's table.
    Returns (last-position logits (1, V), cache)."""
    _check_family(cfg)
    if not supports_prefix_sharing(cfg):
        raise NotImplementedError(f"suffix prefill covers attention-only "
                                  f"configs, not {cfg.arch_id}")
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
    in every attention layer's pools, in place."""
    for pool, mixer in zip(cache["layers"], _mixers(cfg)):
        if mixer not in ATTN_MIXERS:
            continue
        pool["k"][dst] = pool["k"][src]
        pool["v"][dst] = pool["v"][src]
    return cache


# ============================================================ PackedKV wire
def paged_pack(cfg: ModelConfig, cache, slot: int, page_ids,
               n_tokens: int, page_size: int, *, ship=None) -> PackedKV:
    """Copy ``slot``'s live pages (and its slot-state rows) out of the
    paged cache into a page-granular handoff payload.  ``page_size`` is
    the owning engine's: it cannot be read off a cache with no attention
    layer (pure-recurrent caches carry no pools).  ``ship`` restricts the
    pool gather to a subset of the page ids (wire dedupe: pages already
    carried by an earlier payload of the same export are referenced, not
    re-shipped)."""
    ids = torch.tensor(list(page_ids if ship is None else ship),
                       dtype=torch.long, device=cache["pos"].device)
    kv = []
    for entry, mixer in zip(cache["layers"], _mixers(cfg)):
        if mixer in ATTN_MIXERS:
            assert entry["k"].shape[1] == page_size, \
                (entry["k"].shape, page_size)
            kv.append({"k": entry["k"].index_select(0, ids),
                       "v": entry["v"].index_select(0, ids)})
        else:
            kv.append({name: t[slot:slot + 1].clone()
                       for name, t in entry.items()})
    return PackedKV(int(n_tokens), page_size, kv)


def paged_adopt_scatter(cfg: ModelConfig, cache, packed: PackedKV,
                        slot: int, page_ids):
    """Copy-on-adopt, in place: write a handed-off ``PackedKV`` into pages
    ``page_ids`` of THIS engine's pool (fresh pages, never the source's)
    and its state into row ``slot``; the slot's position becomes the
    payload's token count."""
    ids = torch.tensor(list(page_ids), dtype=torch.long,
                       device=cache["pos"].device)
    cache["pos"][slot] = packed.n_tokens
    for dst, src, mixer in zip(cache["layers"], packed.kv, _mixers(cfg)):
        if mixer in ATTN_MIXERS:
            for name in ("k", "v"):
                dst[name].index_copy_(0, ids, src[name].to(
                    device=dst[name].device, dtype=dst[name].dtype))
        else:
            for name, t in dst.items():
                t[slot] = src[name][0].to(device=t.device, dtype=t.dtype)
    return cache


def pack_single_cache(cfg: ModelConfig, single_cache,
                      page_size: int) -> PackedKV:
    """Repack a batch-1 striped cache (``cache_from_prefill``) into the
    page-granular wire form, so a recomputed cache ships and adopts
    exactly like a live-gathered one.  Each attention ring is laid out
    linearly by its stored positions (a ring of width min(window,
    max_len) keeps only its last W tokens; the positions it dropped stay
    zero, as decode masks them)."""
    n_tokens = int(single_cache["pos"][0])
    n_pages = max(pages_for(n_tokens, page_size), 1)
    width = n_pages * page_size
    kv = []
    for entry, mixer in zip(single_cache["layers"], _mixers(cfg)):
        if mixer not in ATTN_MIXERS:
            kv.append(entry)                                   # batch-1
            continue
        spos = entry["pos"][0].long()
        idx = torch.where(spos >= 0, spos, width)              # → dropped

        def lin(leaf):
            arr = torch.zeros((width + 1,) + tuple(leaf.shape[2:]),
                              dtype=leaf.dtype, device=leaf.device)
            arr[idx] = leaf[0]
            return arr[:width].reshape((n_pages, page_size)
                                       + tuple(leaf.shape[2:]))
        kv.append({"k": lin(entry["k"]), "v": lin(entry["v"])})
    return PackedKV(n_tokens, page_size, kv)
