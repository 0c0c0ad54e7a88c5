"""Random weights made on the device from the run's seed.

One ``torch.Generator`` on the device, one draw per kind of weight for all
layers together (a stacked tensor; each layer gets a view of its slice),
drawn straight in the type the model is served in.  The layout is the
port's parameter dict for a dense decoder (``repro_torch.models.model``):
``{"embed", "layers": [{"norm1", "attn", "norm2", "ffn"}], "final_norm"}``
plus ``"head"`` when the embeddings are not tied.  The plain reference
reads the same tensors.

Scales: embeddings and biases 0.02 (the published initializer range of
both models is about 0.02), projections 1/sqrt(fan-in), norm scales
1 + 0.1 N(0, 1) and norm biases 0.1 N(0, 1), so that every bias and norm
parameter moves the logits and a path that dropped one would show.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch


def make(cfg, seed: int, device, dtype=torch.bfloat16) -> Dict:
    gen = torch.Generator(device=device).manual_seed(seed)
    L, d, h, kv, dh, ff = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                           cfg.n_kv_heads, cfg.d_head, cfg.d_ff)

    def normal(shape, std, mean=0.0):
        t = torch.empty(shape, dtype=dtype, device=device)
        return t.normal_(mean, std, generator=gen)

    def stack(shape, std, mean=0.0) -> List[torch.Tensor]:
        return list(normal((L,) + shape, std, mean).unbind(0))

    def norms():
        return [{"scale": s, "bias": b} for s, b in
                zip(stack((d,), 0.1, 1.0), stack((d,), 0.1))]

    attn = {"wq": stack((d, h * dh), 1 / math.sqrt(d)),
            "wk": stack((d, kv * dh), 1 / math.sqrt(d)),
            "wv": stack((d, kv * dh), 1 / math.sqrt(d)),
            "wo": stack((h * dh, d), 1 / math.sqrt(h * dh))}
    if cfg.qkv_bias:
        attn.update(bq=stack((h * dh,), 0.02), bk=stack((kv * dh,), 0.02),
                    bv=stack((kv * dh,), 0.02))
    if cfg.out_bias:
        attn["bo"] = stack((d,), 0.02)
    ffn = {"w_in": stack((d, ff), 1 / math.sqrt(d)),
           "w_out": stack((ff, d), 1 / math.sqrt(ff))}
    if cfg.act == "silu":
        ffn["w_gate"] = stack((d, ff), 1 / math.sqrt(d))
    if cfg.mlp_bias:
        ffn.update(b_in=stack((ff,), 0.02), b_out=stack((d,), 0.02))
    n1, n2 = norms(), norms()
    layers = [{"norm1": n1[i],
               "attn": {k: v[i] for k, v in attn.items()},
               "norm2": n2[i],
               "ffn": {k: v[i] for k, v in ffn.items()}} for i in range(L)]
    final = normal((2, d), 0.1)
    params = {"embed": normal((cfg.vocab_size, d), 0.02), "layers": layers,
              "final_norm": {"scale": final[0] + 1, "bias": final[1]}}
    if not cfg.tie_embeddings:
        params["head"] = normal((d, cfg.vocab_size), 1 / math.sqrt(d))
    return params
