"""Model builder: init / forward / decode for all six families, in
PyTorch.

The counterpart of ``repro.models.model``: ``family="dense"``, ``"moe"``
(a ``moe`` ffn in some or all layers: routed experts plus a shared one),
``"vlm"`` (patch embeddings, from a stubbed vision tower, projected and
placed before the text), ``"encdec"`` (an encoder over stubbed frame
embeddings, and decoder layers that add cross-attention; learned
absolute positions), ``"hybrid"`` (RG-LRU + local attention,
RecurrentGemma) and ``"ssm"`` (mLSTM + sLSTM blocks, xLSTM).  Parameters
are a plain dict: ``{"embed", "layers": [per-layer dict, ...],
"final_norm"}`` plus ``"head"`` when embeddings are not tied,
``"pos_embed"`` (learned positions), ``"patch_proj"`` (vlm) and ``"enc"``
(``{"pos", "layers", "final_norm"}``, encdec).  A layer holds ``"attn"``,
``"rec"``, ``"mlstm"`` or ``"slstm"`` by its pattern entry,
``"norm_x"``/``"xattn"`` in an encdec attention layer, and
``"norm2"`` with ``"ffn"`` or ``"moe"`` by its ffn (xLSTM blocks own their
projections: ffn ``none``).  The JAX package stacks the trunk and the
encoder for ``lax.scan``; here Python loops run over the layer lists
(``repro_torch.bridge`` unstacks JAX parameters into this layout).

Two decode-cache layouts, both ``{"layers": [per-layer entry, ...],
"pos": (n_slots,) int32, ...}``; recurrent layers keep their state
(``{"h","conv"}`` RG-LRU, ``{"C","n","m","conv"}`` mLSTM,
``{"c","n","h","m"}`` sLSTM) slot-indexed in either:
- striped (``init_cache``): each attention layer holds a ring
  ``{"k","v": (n_slots, W, kv, dh), "pos": (n_slots, W)}`` of width
  W = min(window, max_len) (``max_len`` for global layers); an encdec
  layer holds ``{"self": ring, "xk", "xv": (n_slots, enc_seq, kv, dh)}``,
  the fixed cross-attention K/V;
- paged (``init_paged_cache``, not encdec): each attention layer holds
  one K and V page pool (n_pages + 1, page_size, kv, dh) with the trash
  page at n_pages, and the top level the shared (n_slots, max_pages)
  int32 page table ``"pages"``.
Every leaf keeps the slot on axis 0 (the pools have no slot axis).
Attention caches are updated in place; ``decode_step_inplace`` updates
every leaf in place.

A ``moe`` ffn has three forms (``models.moe``): ``forward`` with a
capacity factor (the JAX default 1.25, which drops tokens) runs the
static JAX layout; every serving caller passes ``moe_cf=None`` (no
drops), and then prefill runs the grouped form (``kernel_impl="plain"``:
the static one, the reference) while decode always runs the static one,
which a CUDA graph can hold.

API:
  init_params(cfg, seed, dtype, device)             -> params
  forward(cfg, params, batch, build_cache=..., cache_len=..., moe_cf=...)
        -> {"logits", "aux", "kv"?}               (no gradient recorded)
  train_forward(cfg, params, batch, moe_cf=...)    -> {"logits", "aux"}
  decode_step(cfg, params, cache, tokens, positions) -> (logits, cache)
  decode_step_inplace(cfg, params, cache, tokens)   -> logits (in place)
  init_cache(cfg, n_slots, max_len, ...)            -> zeroed striped cache
  cache_from_prefill(cfg, kv, max_len, n_tokens)    -> striped cache
  init_paged_cache(cfg, n_slots, ...)               -> zeroed paged cache
  paged_pack / paged_adopt_scatter / pack_single_cache -> the PackedKV wire
  make_batch(cfg, batch, seq_len, seed, device)     -> {"tokens", ...}
  n_positions(cfg, batch)                           -> prefill positions
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import recurrent as R
from repro_torch.models import xlstm as X
from repro_torch.models.cache_ops import (DEFAULT_PAGE_SIZE, PackedKV,
                                          paged_geometry, pages_for,
                                          put_row, slot_row)

Params = Dict[str, Any]
ATTN_MIXERS = ("attn", "attn_full")
STATE_MIXERS = ("rec", "mlstm", "slstm")       # slot-indexed state, no K/V
_INIT = {"rec": R.init_rec, "mlstm": X.init_mlstm, "slstm": X.init_slstm}
_INIT_STATE = {"rec": R.init_rec_state, "mlstm": X.init_mlstm_state,
               "slstm": X.init_slstm_state}

# Beyond this cache length, "global" (attn_full) layers of a config with a
# window fall back to the window, so a 524k-token decode stays bounded
LONG_CONTEXT_THRESHOLD = 100_000
POS_TABLE = 4096  # learned-position table size (whisper)


def _mixer_window(cfg: ModelConfig, mixer: str,
                  max_len: Optional[int] = None) -> Optional[int]:
    """Effective attention window: ``attn`` layers use the config's
    window (None = global); ``attn_full`` layers are global, except past
    ``LONG_CONTEXT_THRESHOLD`` cache positions in a config with a window
    (the prefill mask and the striped ring width ask with ``max_len``;
    decode masks ask without it, as the ring then holds the window)."""
    if mixer == "attn_full":
        if (max_len is not None and max_len > LONG_CONTEXT_THRESHOLD
                and cfg.window is not None):
            return cfg.window
        return None
    return cfg.window


def _entries(cfg: ModelConfig) -> List[str]:
    return [cfg.layer_pattern[i % cfg.pattern_len]
            for i in range(cfg.n_layers)]


def _mixers(cfg: ModelConfig) -> List[str]:
    return [e.split(":")[0] for e in _entries(cfg)]


def has_moe(cfg: ModelConfig) -> bool:
    """Whether any layer's ffn is ``moe`` (its serving prefill reads the
    expert counts to the host, which a CUDA graph cannot hold)."""
    return any(e.split(":")[1] == "moe" for e in _entries(cfg))


# ===================================================================== init
def _init_layer(cfg: ModelConfig, entry: str, gen, dtype, dev) -> Params:
    mixer, ffn = entry.split(":")
    lp = {"norm1": L.init_norm(cfg, dtype, dev)}
    if mixer in STATE_MIXERS:
        lp[mixer] = _INIT[mixer](cfg, gen, dtype, dev)
    elif mixer in ATTN_MIXERS:
        lp["attn"] = L.init_attention(cfg, gen, dtype, dev)
        if cfg.family == "encdec":
            lp["norm_x"] = L.init_norm(cfg, dtype, dev)
            lp["xattn"] = L.init_attention(cfg, gen, dtype, dev)
    else:
        raise ValueError(f"unknown mixer {mixer}")
    if ffn == "dense":
        lp["norm2"] = L.init_norm(cfg, dtype, dev)
        lp["ffn"] = L.init_ffn(cfg, gen, dtype, dev)
    elif ffn == "moe":
        lp["norm2"] = L.init_norm(cfg, dtype, dev)
        lp["moe"] = M.init_moe(cfg, gen, dtype, dev)
    return lp


def _normal(gen, shape, scale, dtype, dev):
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
    return (w * scale).to(dtype)


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device=None) -> Params:
    """Random weights with the JAX package's distributions (normal
    embeddings, learned positions and encoder positions ×0.02, normal
    projections and expert matrices ×1/sqrt(d_in), unit norms, zero
    biases, RG-LRU ``lam`` and the xLSTM gates and recurrence in fp32),
    drawn from a ``torch.Generator`` seeded with ``seed`` on the target
    device (default: the GPU; pass ``device="cpu"`` for the CPU)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p: Params = {"embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                       dtype, dev)}
    if cfg.rope_pct == 0.0:
        p["pos_embed"] = _normal(gen, (POS_TABLE, cfg.d_model), 0.02, dtype,
                                 dev)
    if cfg.n_patches:
        p["patch_proj"] = L.dense_init(gen, cfg.d_model, cfg.d_model, dtype,
                                       dev)
    p["layers"] = [_init_layer(cfg, entry, gen, dtype, dev)
                   for entry in _entries(cfg)]
    p["final_norm"] = L.init_norm(cfg, dtype, dev)
    if not cfg.tie_embeddings:
        p["head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size, dtype, dev)
    if cfg.family == "encdec":
        p["enc"] = {
            "pos": _normal(gen, (cfg.enc_seq, cfg.d_model), 0.02, dtype, dev),
            "layers": [{"norm1": L.init_norm(cfg, dtype, dev),
                        "attn": L.init_attention(cfg, gen, dtype, dev),
                        "norm2": L.init_norm(cfg, dtype, dev),
                        "ffn": L.init_ffn(cfg, gen, dtype, dev)}
                       for _ in range(cfg.n_enc_layers)],
            "final_norm": L.init_norm(cfg, dtype, dev)}
    return p


# ================================================================== embed
def _embed_tokens(cfg: ModelConfig, params: Params, tokens, positions,
                  patches=None):
    """Token embeddings (B,S) -> (B,S,d), with the projected ``patches``
    (B,P,d) placed before the text and learned positions added where the
    model has them (indices clamped to the table)."""
    x = params["embed"][tokens]
    if cfg.family == "hybrid":          # gemma-style embedding scale
        # JAX multiplies by the Python float cast to the activation dtype
        x = x * L.const(math.sqrt(cfg.d_model), x.dtype, x.device)
    if patches is not None:
        pe = patches.to(x.dtype) @ params["patch_proj"]
        x = torch.cat([pe, x], dim=1)
    if "pos_embed" in params:
        x = x + params["pos_embed"][positions.clamp(max=POS_TABLE - 1)]
    return x


def _unembed(cfg: ModelConfig, params: Params, x):
    x = L.apply_norm(params["final_norm"], x, cfg)
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["head"]


def _ffn_block(p: Params, x, cfg: ModelConfig, *, moe_cf=None,
               grouped: bool = False, need_aux: bool = False):
    """The ffn block and its residual: (x, aux) (aux None unless a
    ``moe`` ffn was asked for it)."""
    if "ffn" in p:
        return x + L.apply_ffn(p["ffn"], L.apply_norm(p["norm2"], x, cfg),
                               cfg), None
    if "moe" in p:
        mo, aux = M.apply_moe(p["moe"], L.apply_norm(p["norm2"], x, cfg),
                              cfg, capacity_factor=moe_cf, grouped=grouped,
                              need_aux=need_aux)
        return x + mo, aux
    return x, None                      # ffn "none": the block owns its MLP


# ================================================================= encoder
def _encode(cfg: ModelConfig, enc: Params, frames, kernel_impl: str):
    """frames: (B, enc_seq, d) stubbed front-end embeddings -> encoder
    output.  Non-causal attention (the flash kernel with ``causal=False``)
    and a dense ffn per layer.  The frames are cast to the model's dtype
    first (the JAX package adds fp32 frames to the positions and, in a
    bf16 model, runs the encoder's activations in fp32; the same in an
    fp32 model)."""
    x = frames.to(enc["pos"].dtype) + enc["pos"][None]
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    for lp in enc["layers"]:
        h = L.apply_norm(lp["norm1"], x, cfg)
        a, _ = L.full_attention(lp["attn"], h, cfg, positions, causal=False,
                                rope=False, kernel_impl=kernel_impl)
        x = x + a
        x = x + L.apply_ffn(lp["ffn"], L.apply_norm(lp["norm2"], x, cfg),
                            cfg)
    return L.apply_norm(enc["final_norm"], x, cfg)


# ============================================================ layer (full)
def _cross_kv(p: Params, enc_out, cfg: ModelConfig):
    """Cross-attention K/V (B, enc_seq, kv, dh) of the encoder output."""
    B, Se, _ = enc_out.shape
    xk, xv = enc_out @ p["wk"], enc_out @ p["wv"]
    if cfg.qkv_bias:
        xk, xv = xk + p["bk"], xv + p["bv"]
    return (xk.reshape(B, Se, cfg.n_kv_heads, cfg.d_head),
            xv.reshape(B, Se, cfg.n_kv_heads, cfg.d_head))


def _apply_layer_full(lp: Params, x, cfg: ModelConfig, entry: str,
                      positions, kernel_impl: str = "kernel", *,
                      enc_out=None, cache_len: Optional[int] = None,
                      moe_cf=None, length=None):
    """One layer over a whole sequence whose positions are 0..S-1: the
    mixer, its residual (and cross-attention in an encdec layer) and the
    ffn block.  Returns (x, state, aux): state is the attention (k, v)
    (B,S,kv,dh) (encdec: ``{"self": (k, v), "xk", "xv"}``) or the
    recurrent layer's final state; aux is None unless the ffn is ``moe``.
    ``cache_len`` picks ``attn_full``'s window past the long-context
    threshold.  ``length`` ((1,) int64 tensor): x is right-padded past
    that many rows and a recurrent layer returns its state at ``length``
    (attention needs nothing: causal masking keeps the real rows exact)."""
    mixer = entry.split(":")[0]
    h = L.apply_norm(lp["norm1"], x, cfg)
    at = {} if length is None else {"length": length}
    if mixer == "rec":
        a, state = R.apply_rec(lp["rec"], h, cfg, kernel_impl=kernel_impl,
                               **at)
    elif mixer == "mlstm":
        a, state = X.apply_mlstm(lp["mlstm"], h, cfg,
                                 kernel_impl=kernel_impl, **at)
    elif mixer == "slstm":
        a, state = X.apply_slstm(lp["slstm"], h, cfg, **at)
    else:
        a, state = L.full_attention(
            lp["attn"], h, cfg, positions, rope=cfg.rope_pct > 0.0,
            window=_mixer_window(cfg, mixer, cache_len),
            kernel_impl=kernel_impl)
    x = x + a
    if cfg.family == "encdec" and mixer in ATTN_MIXERS:
        xk, xv = _cross_kv(lp["xattn"], enc_out, cfg)
        ca, _ = L.full_attention(lp["xattn"], L.apply_norm(lp["norm_x"], x,
                                                           cfg),
                                 cfg, positions, rope=False,
                                 kv_override=(xk, xv),
                                 kernel_impl=kernel_impl)
        x = x + ca
        state = {"self": state, "xk": xk, "xv": xv}
    x, aux = _ffn_block(lp, x, cfg, moe_cf=moe_cf, need_aux=True,
                        grouped=moe_cf is None and kernel_impl == "kernel")
    return x, state, aux


# ================================================================= forward
def n_positions(cfg: ModelConfig, batch: Dict[str, Any]) -> int:
    """A prefill batch's position count: its patches (vlm) and tokens."""
    n = batch["tokens"].shape[1]
    if cfg.n_patches and batch.get("patches") is not None:
        n += batch["patches"].shape[1]
    return n


@torch.no_grad()
def forward(cfg: ModelConfig, params: Params, batch: Dict[str, Any], *,
            build_cache: bool = False, cache_len: Optional[int] = None,
            moe_cf=1.25, kernel_impl: str = "kernel",
            last_only: bool = False, length=None) -> Dict[str, Any]:
    """Train / prefill forward.  batch: {"tokens": (B, S_text)} plus
    "patches" (B, n_patches, d) (vlm: placed before the text) or
    "frames" (B, enc_seq, d) (encdec: the encoder's input); positions are
    0..S-1 over S = patches + text.  ``moe_cf`` is the MoE capacity
    factor (the JAX default 1.25 drops tokens; serving passes None);
    ``cache_len`` (default S) is the decode cache's length, which picks
    ``attn_full``'s long-context window.
    Returns {"logits": (B,S,V), "aux": the MoE load-balance loss (fp32,
    0 without MoE)} ((B,1,V) logits for the last position alone with
    ``last_only``: the engines read no other row, and at a 256k vocabulary
    the full tensor is gigabytes) plus, with ``build_cache``, "kv": per
    layer the ``_apply_layer_full`` state.  ``kernel_impl``: see
    ``models.layers``.  ``length`` (a (1,) int64 tensor, None = S) is the
    real position count of a batch right-padded to a length bucket (the
    engines' captured prefills): ``last_only`` then reads row length-1,
    and recurrent layers return their state at ``length``; rows past it
    are computed and ignored.  No gradient is recorded:
    ``train_forward`` is the same computation with one."""
    return _forward(cfg, params, batch, build_cache=build_cache,
                    cache_len=cache_len, moe_cf=moe_cf,
                    kernel_impl=kernel_impl, last_only=last_only,
                    length=length)


def train_forward(cfg: ModelConfig, params: Params, batch: Dict[str, Any],
                  *, moe_cf=1.25) -> Dict[str, Any]:
    """``forward`` with gradients, for training: the plain path
    (``kernel_impl="plain"``: the CUDA kernels have no backward, and the
    JAX package trains through its XLA attention and scans, not through
    its Pallas kernels), MoE layers in the static form at capacity factor
    ``moe_cf`` with their ``aux``.  Each decoder layer is rematerialised
    in the backward pass (``torch.utils.checkpoint.checkpoint``, the
    counterpart of the JAX package's ``jax.checkpoint`` over the trunk),
    which changes no value.  Returns {"logits", "aux"}."""
    return _forward(cfg, params, batch, moe_cf=moe_cf, kernel_impl="plain",
                    remat=True)


def _without_state(layer, x):
    """(x, aux) of ``layer(x)``: a rematerialised layer keeps no state."""
    x, _, aux = layer(x)
    return x, aux


def _forward(cfg: ModelConfig, params: Params, batch: Dict[str, Any], *,
             build_cache: bool = False, cache_len: Optional[int] = None,
             moe_cf=1.25, kernel_impl: str = "kernel",
             last_only: bool = False, remat: bool = False, length=None):
    tokens = batch["tokens"]
    B, S = tokens.shape[0], n_positions(cfg, batch)
    patches = batch.get("patches") if cfg.n_patches else None
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = _embed_tokens(cfg, params, tokens, positions, patches)
    enc_out = (_encode(cfg, params["enc"], batch["frames"], kernel_impl)
               if cfg.family == "encdec" else None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kv: List[Any] = []
    for lp, entry in zip(params["layers"], _entries(cfg)):
        layer = functools.partial(
            _apply_layer_full, lp, cfg=cfg, entry=entry,
            positions=positions, kernel_impl=kernel_impl, enc_out=enc_out,
            cache_len=cache_len or S, moe_cf=moe_cf, length=length)
        if remat:
            x, a = checkpoint(_without_state, layer, x, use_reentrant=False)
        else:
            x, state, a = layer(x)
            if build_cache:
                kv.append(state)
        if a is not None:
            aux = aux + a
    if last_only:
        x = x[:, -1:] if length is None else x.index_select(1, length - 1)
    out: Dict[str, Any] = {"logits": _unembed(cfg, params, x), "aux": aux}
    if build_cache:
        out["kv"] = kv
    return out


# ============================================================== decode step
_STEP = {"rec": R.apply_rec_step, "mlstm": X.apply_mlstm_step,
         "slstm": X.apply_slstm_step}


def _decode_layers(cfg: ModelConfig, params: Params, cache, tokens,
                   positions, kernel_impl: str, inplace: bool):
    """Every layer of one decode step; returns logits (B, V).  Attention
    layers update their ring or pools in place; recurrent layers write
    their new state into the cache's own tensors with ``inplace``, else
    the cache's entry is replaced by the new state.  MoE layers run the
    static form (no host read: the step can be captured)."""
    rope = cfg.rope_pct > 0.0
    paged = "pages" in cache
    x = _embed_tokens(cfg, params, tokens[:, None], positions[:, None])
    for i, (lp, mixer) in enumerate(zip(params["layers"], _mixers(cfg))):
        h = L.apply_norm(lp["norm1"], x, cfg)
        entry = cache["layers"][i]
        if mixer in STATE_MIXERS:
            a, cache["layers"][i] = _STEP[mixer](lp[mixer], h, cfg, entry,
                                                 inplace=inplace)
        elif paged:
            a, _ = L.paged_decode_attention(
                lp["attn"], h, entry, cfg, positions, cache["pages"],
                rope=rope, window=_mixer_window(cfg, mixer),
                kernel_impl=kernel_impl)
        else:
            ring = entry["self"] if cfg.family == "encdec" else entry
            a, _ = L.decode_attention(
                lp["attn"], h, ring, cfg, positions, rope=rope,
                window=_mixer_window(cfg, mixer), kernel_impl=kernel_impl)
        x = x + a
        if cfg.family == "encdec" and mixer in ATTN_MIXERS:
            ca, _ = L.decode_attention(
                lp["xattn"], L.apply_norm(lp["norm_x"], x, cfg), None, cfg,
                positions, rope=False, cross_kv=(entry["xk"], entry["xv"]),
                kernel_impl=kernel_impl)
            x = x + ca
        x, _ = _ffn_block(lp, x, cfg)
    return _unembed(cfg, params, x)[:, 0]


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Params, cache, tokens, positions,
                *, kernel_impl: str = "kernel"):
    """tokens: (B,) last generated token; positions: (B,).  A cache with a
    ``"pages"`` table decodes attention layers against the paged pools
    (the fused step kernel appends and attends); otherwise each attention
    layer writes its ring slot and attends over the ring (the ring decode
    kernel), and an encdec layer then attends over its fixed
    cross-attention K/V.  Recurrent layers take the single-step update
    either way.  Attention caches are updated in place; recurrent entries
    and ``cache["pos"]`` are replaced by new tensors.  Returns (logits
    (B, V), cache) with ``cache["pos"]`` advanced to positions + 1.
    ``decode_step_inplace`` is the same step with every leaf updated in
    place (what the engines capture)."""
    logits = _decode_layers(cfg, params, cache, tokens, positions,
                            kernel_impl, inplace=False)
    cache["pos"] = (positions + 1).to(torch.int32)
    return logits, cache


@torch.no_grad()
def decode_step_inplace(cfg: ModelConfig, params: Params, cache, tokens,
                        *, kernel_impl: str = "kernel"):
    """``decode_step`` at ``positions = cache["pos"]`` with EVERY cache
    leaf updated in place, ``cache["pos"]`` included: no tensor the step
    reads or writes changes its address, so the step can be captured
    once as a CUDA graph and replayed (``serving.engine``).  The same
    arithmetic as ``decode_step`` (bitwise equal results).  Returns
    logits (B, V)."""
    logits = _decode_layers(cfg, params, cache, tokens, cache["pos"],
                            kernel_impl, inplace=True)
    cache["pos"].add_(1)
    return logits


# ========================================================== striped caches
def _ring_width(cfg: ModelConfig, mixer: str, max_len: int) -> int:
    win = _mixer_window(cfg, mixer, max_len)
    return min(win, max_len) if win is not None else max_len


def init_cache(cfg: ModelConfig, n_slots: int, max_len: int, *,
               dtype=torch.float32, device=None):
    """Zeroed striped decode cache: a ring per attention layer of width
    W = min(window, max_len) (``max_len`` for global layers; the window
    for ``attn_full`` past the long-context threshold), the fixed
    cross-attention K/V of an encdec layer, the state per recurrent
    layer, and the per-slot positions."""
    dev = resolve_device(device)
    layers = []
    for mixer in _mixers(cfg):
        if mixer in STATE_MIXERS:
            layers.append(_INIT_STATE[mixer](cfg, n_slots, dtype, dev))
            continue
        ring = L.init_kv_cache(cfg, n_slots, max_len, dtype, dev,
                               window=_ring_width(cfg, mixer, max_len))
        if cfg.family == "encdec":
            shape = (n_slots, cfg.enc_seq, cfg.n_kv_heads, cfg.d_head)
            ring = {"self": ring,
                    "xk": torch.zeros(shape, dtype=dtype, device=dev),
                    "xv": torch.zeros(shape, dtype=dtype, device=dev)}
        layers.append(ring)
    return {"layers": layers,
            "pos": torch.zeros((n_slots,), dtype=torch.int32, device=dev)}


def _batch_rows(entry):
    """(batch size, device) of one layer's prefill output."""
    while not isinstance(entry, torch.Tensor):
        entry = (next(iter(entry.values())) if isinstance(entry, dict)
                 else entry[0])
    return entry.shape[0], entry.device


def cache_from_prefill(cfg: ModelConfig, kv, max_len: int, n_tokens):
    """The striped decode cache of a prefill batch, from
    ``forward(build_cache=True)["kv"]``: each attention layer's K/V become
    its ring (the last W tokens at their ring slots when the sequence is
    longer than the ring), an encdec layer keeps its cross-attention K/V,
    each recurrent layer's final state is kept, and every row's position
    is ``n_tokens``, the prefill's position count (patches + text): an
    int, or a (1,) int64 tensor when the prefill was right-padded past it
    (``forward(length=...)``; the rings then hold real positions only)."""
    layers = []
    for mixer, entry in zip(_mixers(cfg), kv):
        if mixer in STATE_MIXERS:
            layers.append(entry)
            continue
        cross = entry if cfg.family == "encdec" else None
        k, v = cross["self"] if cross is not None else entry
        ring = L.kv_cache_from_prefill(
            cfg, k, v, n_tokens, max_len,
            window=_ring_width(cfg, mixer, max_len))
        if cross is not None:
            ring = {"self": ring, "xk": cross["xk"], "xv": cross["xv"]}
        layers.append(ring)
    B, dev = _batch_rows(kv[0])
    pos = (n_tokens.to(torch.int32).expand(B).clone()
           if isinstance(n_tokens, torch.Tensor)
           else torch.full((B,), n_tokens, dtype=torch.int32, device=dev))
    return {"layers": layers, "pos": pos}


# ============================================================== batch maker
def make_batch(cfg: ModelConfig, batch: int, seq_len: int, seed: int = 0,
               device=None, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Random batch drawn with numpy from ``seed``: {"tokens": (batch,
    S_text) int64} with S_text = ``seq_len`` less the patches of a vlm
    config, plus standard-normal "patches" (batch, n_patches, d) (vlm) or
    "frames" (batch, enc_seq, d) (encdec) in ``dtype``."""
    rng = np.random.default_rng(seed)
    dev = resolve_device(device)
    s_text = seq_len - cfg.n_patches if cfg.n_patches else seq_len
    toks = rng.integers(0, cfg.vocab_size, (batch, s_text))
    out = {"tokens": torch.from_numpy(toks).to(dev)}
    extra = {}
    if cfg.n_patches:
        extra["patches"] = (batch, cfg.n_patches, cfg.d_model)
    if cfg.family == "encdec":
        extra["frames"] = (batch, cfg.enc_seq, cfg.d_model)
    for name, shape in extra.items():
        out[name] = torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)
    return out


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
    ``n_pages``/``max_pages`` default from ``max_len``.  The encdec
    family stays striped: its cross-attention K/V are fixed per slot."""
    if cfg.family == "encdec":
        raise ValueError("paged caches cover decoder-only families "
                         "(cross-attention K/V is fixed-size per slot)")
    dev = resolve_device(device)
    if page_size is None:
        page_size = DEFAULT_PAGE_SIZE
    if page_size == "auto" or max_pages is None or n_pages is None:
        if max_len is None:
            raise ValueError("page_size='auto' or defaulted n_pages/"
                             "max_pages need max_len")
        page_size, _ = paged_geometry(cfg, n_slots, max_len,
                                      page_size=page_size, device=dev,
                                      dtype=dtype)
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


def _clamp(x, lo: int, hi: int):
    """``x`` (an int or a tensor) clamped to [lo, hi]."""
    if isinstance(x, torch.Tensor):
        return x.clamp(lo, hi)
    return max(min(x, hi), lo)


def paged_prefill_scatter(cfg: ModelConfig, cache, kv, slot, pt_row,
                          n_tokens):
    """Write a batch-1 prefill of an ``n_tokens``-token prompt
    (``forward(build_cache=True)["kv"]``) into ``slot``, in place:
    attention K/V straight into the slot's pages, recurrent state into the
    slot's row, and the slot's position.  Whole pages are written: the
    tail of the prompt's last page gets zeros, as the JAX package's
    page-granular scatter of its zero-padded ring cache gives, so the pools
    match it byte for byte outside the trash page.  Every prompt token is
    written, also those a window has left behind (the JAX package writes
    only its ring's last W): decode masks them, so the outputs are the
    same.  Unallocated table entries land on the trash page.

    ``slot`` and ``n_tokens`` are ints, or (1,) int64 tensors (one graph
    serves every slot and length of a bucket): the prefill may then be
    right-padded past ``n_tokens``, and the padded rows' K/V, and the
    pages wholly past the prompt, land on the trash page."""
    attn = [(pool, e) for pool, e, mixer in zip(cache["layers"], kv,
                                                 _mixers(cfg))
            if mixer in ATTN_MIXERS]
    for state, e, mixer in zip(cache["layers"], kv, _mixers(cfg)):
        if mixer in STATE_MIXERS:
            for name, dst in state.items():
                put_row(dst, slot, e[name])
    put_row(cache["pos"], slot, n_tokens)
    if not attn:
        return cache
    MP = pt_row.shape[0]
    P, ps = attn[0][0]["k"].shape[:2]
    S = attn[0][1][0].shape[1]               # the (padded) prefill length
    npg = max(min(-(-S // ps), MP), 1)       # pages the prefill spans
    live = _clamp((n_tokens + ps - 1) // ps, 1, MP)   # pages the prompt has
    row = pt_row[:npg].long()
    pg = torch.where((row >= 0)
                     & (torch.arange(npg, device=row.device) < live),
                     row, P - 1)
    pad = torch.arange(npg * ps, device=row.device) >= n_tokens
    n = min(S, npg * ps)
    for pool, (k, v) in attn:
        for name, src in (("k", k), ("v", v)):
            dst = pool[name]
            pages = torch.zeros((npg * ps,) + tuple(dst.shape[2:]),
                                dtype=dst.dtype, device=dst.device)
            pages[:n] = src[0, :n].to(dst.dtype)
            pages.masked_fill_(pad[:, None, None], 0)
            dst[pg] = pages.reshape((npg, ps) + tuple(dst.shape[2:]))
    return cache


def supports_prefix_sharing(cfg: ModelConfig) -> bool:
    """CoW prefix sharing covers configs whose every layer keeps paged
    attention state (the dense, moe and vlm configs): recurrent layers
    fold the whole prefix into one state vector, which cannot be shared
    by pages, so the hybrid and ssm families are excluded, and encdec
    stays striped entirely."""
    return cfg.family != "encdec" and all(
        mixer in ATTN_MIXERS for mixer in _mixers(cfg))


@torch.no_grad()
def paged_suffix_prefill(cfg: ModelConfig, params: Params, cache, tokens,
                         slot, start, n_tokens=None):
    """Prefill ONLY the un-cached suffix of a prompt whose shared prefix
    already sits in ``slot``'s leading pages (prefix sharing).

    tokens: (1, S_suffix); ``start`` is the shared token count, so
    positions run start..start+S-1.  Each layer writes the suffix K/V into
    the slot's pages and attends suffix queries over the slot's table.
    A ``moe`` ffn runs the grouped form with no drops, as every serving
    prefill does.  ``slot``, ``start`` and ``n_tokens`` (the real suffix
    length, default S) are ints or (1,) int64 tensors: a suffix
    right-padded past ``n_tokens`` writes its padded K/V to the trash
    page and reads its logits at row n_tokens-1.  Returns (last real
    position's logits (1, V), cache)."""
    if not supports_prefix_sharing(cfg):
        raise NotImplementedError(f"suffix prefill covers attention-only "
                                  f"configs, not {cfg.arch_id}")
    S = tokens.shape[1]
    pt_row = slot_row(cache["pages"], slot)
    positions = (start + torch.arange(S, device=tokens.device))[None]
    end = start + (S if n_tokens is None else n_tokens)
    rope = cfg.rope_pct > 0.0
    x = _embed_tokens(cfg, params, tokens, positions)
    for lp, pool, mixer in zip(params["layers"], cache["layers"],
                               _mixers(cfg)):
        h = L.apply_norm(lp["norm1"], x, cfg)
        a, _ = L.paged_suffix_attention(
            lp["attn"], h, pool, cfg, positions, pt_row, end, rope=rope,
            window=_mixer_window(cfg, mixer))
        x, _ = _ffn_block(lp, x + a, cfg, grouped=True)
    last = (x[:, -1:] if n_tokens is None
            else x.index_select(1, n_tokens - 1))
    logits = _unembed(cfg, params, last)[:, 0]
    put_row(cache["pos"], slot, end)
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
