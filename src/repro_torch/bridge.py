"""Weight bridge: the JAX package's parameters into the port's layout.

``repro.models.init_params`` returns a pytree whose trunk is stacked for
``lax.scan``: ``trunk`` is a tuple with one dict per pattern position,
each leaf carrying a leading repetition axis, and ``rem`` holds the
unrolled remainder layers.  The port keeps one dict per layer, so layer
``rep * pattern_len + pi`` is ``trunk[pi][...][rep]`` and the remainder
layers follow.  The caller hands the parameters over as nested dicts and
tuples of numpy arrays (``jax.device_get``); this module imports no JAX.
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


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    return fn(x)


def params_from_jax(cfg, jax_params: Dict[str, Any], *, device=None,
                    dtype=None) -> Dict[str, Any]:
    """Port-layout parameters from numpy copies of the JAX package's
    (dense family).  ``dtype`` casts every leaf; None keeps the source
    dtype.  ``device`` defaults to the GPU."""
    dev = resolve_device(device)
    conv = lambda a: _tensor(a, dev, dtype)
    reps, plen = cfg.n_pattern_reps, cfg.pattern_len
    layers = []
    for rep in range(reps):
        for pi in range(plen):
            layers.append(_tree(jax_params["trunk"][pi],
                                lambda a, r=rep: conv(np.asarray(a)[r])))
    layers += [_tree(lp, conv) for lp in jax_params["rem"]]
    out = {"embed": conv(jax_params["embed"]), "layers": layers,
           "final_norm": _tree(jax_params["final_norm"], conv)}
    if "head" in jax_params:
        out["head"] = conv(jax_params["head"])
    return out
