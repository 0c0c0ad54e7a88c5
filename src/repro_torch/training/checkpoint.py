"""Checkpointing via λScale tensor-packed blocks.

Checkpoints are stored in exactly the wire format λScale multicasts: one
contiguous packed buffer per model block plus a JSON manifest of tensor
specs (§5 "tensor packing").  A restored checkpoint can therefore be
multicast without re-packing — the storage tier and the transfer tier share
a representation, like the paper's host-memory block cache.

The counterpart of ``repro.training.checkpoint``: the port's
``pack_model`` gives the JAX package's bytes for the same weights, so
``blocks.npy`` and the manifest are the ones the JAX package writes, and
a checkpoint written by either package loads in the port.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.blocks import (BlockSpec, TensorSpec, pack_model,
                                     unpack_model)


def save_checkpoint(path: str, cfg: ModelConfig, params, *,
                    n_blocks: int = 16, step: Optional[int] = None) -> None:
    os.makedirs(path, exist_ok=True)
    stacked, specs = pack_model(cfg, params, n_blocks)
    np.save(os.path.join(path, "blocks.npy"), stacked.cpu().numpy())
    manifest = {
        "arch_id": cfg.arch_id,
        "n_blocks": len(specs),
        "step": step,
        "specs": [
            {"block_id": s.block_id, "nbytes": s.nbytes,
             "tensors": [dataclasses.asdict(t) for t in s.tensors]}
            for s in specs],
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def load_checkpoint(path: str, cfg: ModelConfig, *, device=None):
    """(params, step): the weights on ``device`` (see
    ``repro_torch.resolve_device``), views into one packed buffer."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["arch_id"] == cfg.arch_id, \
        f"checkpoint is for {manifest['arch_id']}, not {cfg.arch_id}"
    stacked = torch.from_numpy(np.load(os.path.join(path, "blocks.npy"))).to(
        resolve_device(device))
    specs = [
        BlockSpec(m["block_id"],
                  tuple(TensorSpec(t["key"], tuple(t["shape"]), t["dtype"],
                                   t["offset"], t["nbytes"])
                        for t in m["tensors"]),
                  m["nbytes"])
        for m in manifest["specs"]]
    return unpack_model(cfg, stacked, specs), manifest.get("step")
