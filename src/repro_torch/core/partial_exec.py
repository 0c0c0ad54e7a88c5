"""Partial model execution over block-resident parameters.

During execute-while-load a node holds only SOME model blocks (unpacked
from their wire buffers).  These helpers run the embedding, a contiguous
layer range, or the head directly from the flat unit-keyed dict that
``core.blocks`` produces: the execution primitive behind λPipe's
execution-pipeline stages (§4.3).  Stage i runs
``apply_layer_range(cfg, flat_i, x, lo_i, hi_i, positions)`` and hands the
activation to the next stage.

The counterpart of ``repro.core.partial_exec`` for the port's families
(dense, hybrid, ssm); attention layers run the flash kernel on the card.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.blocks import build_tree, unit_items
from repro_torch.models import model as mm


@torch.no_grad()
def embed_from_flat(cfg: ModelConfig, flat: Dict[str, torch.Tensor],
                    tokens):
    """Requires the '@embed' unit. tokens: (B,S)."""
    return mm._embed_tokens(cfg, {"embed": flat["@embed/embed"]}, tokens)


@torch.no_grad()
def apply_layer_range(cfg: ModelConfig, flat: Dict[str, torch.Tensor], x,
                      lo: int, hi: int, positions, *,
                      kernel_impl: str = "kernel"):
    """Apply trunk layers [lo, hi) to x (B,S,d) at ``positions`` (B,S),
    0..S-1.  Raises KeyError when a layer's unit is not resident."""
    for li in range(lo, hi):
        sub = unit_items(flat, f"@layer{li:04d}/")
        if not sub:
            raise KeyError(f"layer {li} not resident")
        mixer = cfg.layer_pattern[li % cfg.pattern_len].split(":")[0]
        x, _ = mm._apply_layer_full(build_tree(sub), x, cfg, mixer,
                                    positions, kernel_impl)
    return x


@torch.no_grad()
def head_from_flat(cfg: ModelConfig, flat: Dict[str, torch.Tensor], x):
    """Requires the '@head' unit (+ '@embed' if embeddings are tied)."""
    params = {"final_norm": build_tree(unit_items(flat,
                                                  "@head/final_norm"))}
    if cfg.tie_embeddings:
        params["embed"] = flat["@embed/embed"]
    else:
        params["head"] = flat["@head/head"]
    return mm._unembed(cfg, params, x)


def layer_range_of_units(units) -> tuple:
    """(lo, hi) trunk-layer range covered by a block's unit list."""
    ls = [int(u[6:]) for u in units if u.startswith("@layer")]
    return (min(ls), max(ls) + 1) if ls else (0, 0)
