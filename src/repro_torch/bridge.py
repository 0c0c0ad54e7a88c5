"""Weight bridge: the JAX package's parameters into the port's layout.

``repro.models.init_params`` returns a pytree whose trunk is stacked for
``lax.scan``: ``trunk`` is a tuple with one dict per pattern position,
each leaf carrying a leading repetition axis, and ``rem`` holds the
unrolled remainder layers.  The port keeps one dict per layer, so layer
``rep * pattern_len + pi`` is ``trunk[pi][...][rep]`` and the remainder
layers follow.  The caller hands the parameters over as nested dicts and
tuples of numpy arrays (``jax.device_get``); this module imports no JAX.
The encoder (encdec) is stacked the same way, under ``enc["layers"]``;
MoE layers' ``moe`` dicts (router, expert banks (E, d_in, d_out), the
shared expert), an encdec layer's ``norm_x``/``xattn``, the learned
positions ``pos_embed`` and the VLM ``patch_proj`` come over as they are.
Recurrent layers' ``rec``, ``mlstm`` and ``slstm`` dicts come over like
the rest, except for the leaves that the JAX package makes fp32 in a bf16
model, which keep their fp32 under any ``dtype``: the RG-LRU ``lam``, the
mLSTM gate weights ``w_i``, ``w_f``, ``b_i``, ``b_f`` and the sLSTM
recurrence ``r`` and bias ``b``.  A JAX decode cache (``trunk`` stacked the
same way, ``rem``, ``pos``) maps onto the port's per-layer list by the
same correspondence (``cache_from_jax``).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device


def _tensor(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: no numpy-native bf16
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device=device, dtype=dtype or t.dtype)


# (block, leaf) pairs that keep their source dtype whatever ``dtype`` asks
# for (the RG-LRU ``w_i`` is in the model dtype: the block matters)
_KEEP_DTYPE = {("rec", "lam"), ("mlstm", "w_i"), ("mlstm", "w_f"),
               ("mlstm", "b_i"), ("mlstm", "b_f"), ("slstm", "r"),
               ("slstm", "b")}


def _tree(x, fn, path=()):
    if isinstance(x, dict):
        return {k: _tree(v, fn, path + (k,)) for k, v in x.items()}
    return fn(x, path)


def _unstack(stacked, n, conv):
    return [_tree(stacked, lambda a, path, r=r: conv(np.asarray(a)[r], path))
            for r in range(n)]


def _layers(cfg, tree, conv):
    """The per-layer list of a JAX tree's stacked ``trunk`` and unrolled
    ``rem`` (parameters and decode caches share the layout)."""
    reps, plen = cfg.n_pattern_reps, cfg.pattern_len
    per_pos = [_unstack(tree["trunk"][pi], reps, conv) for pi in range(plen)]
    layers = [per_pos[pi][rep] for rep in range(reps) for pi in range(plen)]
    return layers + [_tree(lp, conv) for lp in tree["rem"]]


def params_from_jax(cfg, jax_params: Dict[str, Any], *, device=None,
                    dtype=None) -> Dict[str, Any]:
    """Port-layout parameters from numpy copies of the JAX package's
    (every family).  ``dtype`` casts every leaf but
    those of ``_KEEP_DTYPE``; None keeps the source dtype.  ``device``
    defaults to the GPU."""
    dev = resolve_device(device)

    def conv(a, path=()):
        return _tensor(a, dev, None if path[-2:] in _KEEP_DTYPE else dtype)

    out = {"embed": conv(jax_params["embed"]),
           "layers": _layers(cfg, jax_params, conv),
           "final_norm": _tree(jax_params["final_norm"], conv)}
    for name in ("head", "pos_embed", "patch_proj"):
        if name in jax_params:
            out[name] = conv(jax_params[name])
    if "enc" in jax_params:
        enc = jax_params["enc"]
        out["enc"] = {"pos": conv(enc["pos"]),
                      "layers": _unstack(enc["layers"], cfg.n_enc_layers,
                                         conv),
                      "final_norm": _tree(enc["final_norm"], conv)}
    return out


def cache_from_jax(cfg, jax_cache: Dict[str, Any], *, device=None,
                   dtype=None) -> Dict[str, Any]:
    """The port's striped decode cache (``models.init_cache``'s layout:
    ``{"layers": [...], "pos"}``) from numpy copies of a JAX one
    (``repro.models.init_cache``: stacked ``trunk``, ``rem``, ``pos``).
    ``dtype`` casts every floating leaf; None keeps the source dtype."""
    dev = resolve_device(device)

    def conv(a, path=()):
        a = np.asarray(a)
        keep = a.dtype.kind in "iub"
        return _tensor(a, dev, None if keep else dtype)

    return {"layers": _layers(cfg, jax_cache, conv),
            "pos": conv(jax_cache["pos"])}
