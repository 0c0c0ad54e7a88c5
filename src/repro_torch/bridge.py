"""Weight bridge: the JAX package's parameters into the port's layout.

``repro.models.init_params`` returns a pytree whose trunk is stacked for
``lax.scan``: ``trunk`` is a tuple with one dict per pattern position,
each leaf carrying a leading repetition axis, and ``rem`` holds the
unrolled remainder layers.  The port keeps one dict per layer, so layer
``rep * pattern_len + pi`` is ``trunk[pi][...][rep]`` and the remainder
layers follow.  The caller hands the parameters over as nested dicts and
tuples of numpy arrays (``jax.device_get``); this module imports no JAX.
Recurrent layers' ``rec`` dicts come over like the rest, except that the
RG-LRU ``lam`` keeps its fp32 under any ``dtype``, as ``init_rec`` makes
it in a bf16 model.
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


# leaves that keep their source dtype whatever ``dtype`` asks for
_KEEP_DTYPE = ("lam",)


def _tree(x, fn, key=None):
    if isinstance(x, dict):
        return {k: _tree(v, fn, k) for k, v in x.items()}
    return fn(x, key)


def params_from_jax(cfg, jax_params: Dict[str, Any], *, device=None,
                    dtype=None) -> Dict[str, Any]:
    """Port-layout parameters from numpy copies of the JAX package's
    (dense and hybrid families).  ``dtype`` casts every leaf but ``lam``;
    None keeps the source dtype.  ``device`` defaults to the GPU."""
    dev = resolve_device(device)

    def conv(a, key=None):
        return _tensor(a, dev, None if key in _KEEP_DTYPE else dtype)

    reps, plen = cfg.n_pattern_reps, cfg.pattern_len
    layers = []
    for rep in range(reps):
        for pi in range(plen):
            layers.append(_tree(jax_params["trunk"][pi],
                                lambda a, key, r=rep: conv(np.asarray(a)[r],
                                                           key)))
    layers += [_tree(lp, conv) for lp in jax_params["rem"]]
    out = {"embed": conv(jax_params["embed"]), "layers": layers,
           "final_norm": _tree(jax_params["final_norm"], conv)}
    if "head" in jax_params:
        out["head"] = conv(jax_params["head"])
    return out
