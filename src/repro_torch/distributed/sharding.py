"""Divisibility-guarded sharding rules for params, optimizer state, batches
and decode caches on the ("data", "model") / ("pod", "data", "model")
production meshes.

The counterpart of ``repro.distributed.sharding``, with its rules line
for line.  Weights: the last dimension divisible by the model-axis size
is tensor-parallel ("model"); one further divisible dimension is
FSDP/ZeRO-sharded over "data".  Dimensions that don't divide (whisper's
51866 vocab, qwen2-moe's 60 experts, starcoder2's 24 heads) fall back to
the next dimension or replication — never a crash.

A rule gives, per leaf, a tuple of DTensor placements, one per mesh axis:
``Shard(d)`` where the axis splits tensor dim ``d``, else ``Replicate()``.
``to_spec`` turns such a tuple back into JAX ``PartitionSpec`` entries.
The JAX trunk stacks each layer's leaves on a leading (reps,) axis that
its rules skip (``skip_leading=1``); the port's trunk is a list of
per-layer leaves (``repro_torch.bridge``), so every rule here applies to
the whole leaf, and a cache leaf's batch is its dim 0.

``mesh`` is a ``DeviceMesh`` with named dims, or any object with JAX's
``axis_names`` and a ``shape`` mapping (the tests' stand-in mesh).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ModelConfig


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size}, in mesh order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {a: mesh.size(i) for i, a in enumerate(names)}
    return {a: mesh.shape[a] for a in mesh.axis_names}


def placements(spec, mesh) -> Tuple:
    """JAX-style spec entries (None, an axis name or a tuple of names per
    tensor dim) as one placement per mesh axis."""
    out = []
    for a in axis_sizes(mesh):
        dims = [d for d, e in enumerate(spec)
                if e == a or (isinstance(e, tuple) and a in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def to_spec(place, mesh, ndim: int) -> Tuple:
    """``placements``' inverse: per tensor dim None, the one axis name, or
    the tuple of names (in mesh order) that split it."""
    names = list(axis_sizes(mesh))
    spec = []
    for d in range(ndim):
        axes = tuple(a for a, p in zip(names, place)
                     if isinstance(p, Shard) and p.dim == d)
        spec.append(None if not axes else axes[0] if len(axes) == 1
                    else axes)
    return tuple(spec)


def local_shape(shape, place, mesh) -> Tuple[int, ...]:
    """Rank 0's shard shape of a leaf of ``shape`` under ``place``."""
    sizes = list(axis_sizes(mesh).values())
    out = list(shape)
    for n, p in zip(sizes, place):
        if isinstance(p, Shard):
            out[p.dim] = -(-out[p.dim] // n)
    return tuple(out)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples; leaves
    without a shape (an optimizer's step count) stay as they are."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in
                tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    if not hasattr(tree, "shape"):
        return tree
    return fn(path, tree)


def _weight_spec(shape, mesh, *, skip_leading: int = 0,
                 fsdp: bool = True) -> Tuple:
    sizes = axis_sizes(mesh)
    model_n = sizes["model"]
    data_n = sizes["data"]
    spec = [None] * len(shape)
    dims = [d for d in range(len(shape) - 1, skip_leading - 1, -1)]
    model_dim: Optional[int] = None
    for d in dims:
        if shape[d] % model_n == 0 and shape[d] >= model_n:
            spec[d] = "model"
            model_dim = d
            break
    if fsdp:
        for d in dims:
            if d == model_dim:
                continue
            if shape[d] % data_n == 0 and shape[d] >= data_n:
                spec[d] = "data"
                break
    return placements(spec, mesh)


# second-of-pair projection matrices: Megatron row-parallel (model axis on
# the CONTRACTION dim) so the producing column-parallel matmul's output
# feeds them without an activation all-gather — only one all-reduce of the
# (B,S,d) result per pair.
_ROW_PARALLEL = {"w_out", "w_down"}


def param_shardings(cfg: ModelConfig, mesh, params, *,
                    fsdp: bool = True, moe_expert_parallel: bool = False,
                    tp_pairs: bool = False, pure_fsdp: bool = False):
    """A tree of placements matching a params (or grads / optimizer
    moment) tree of anything with a ``shape``.

    moe_expert_parallel: place the EXPERT dim of MoE banks on the "model"
    axis.  tp_pairs: Megatron column/row pairing — w_out/w_down shard
    "model" on their input (contraction) dim.  pure_fsdp: ZeRO-3, every
    weight sharded over ALL mesh axes on its first divisible dim."""
    sizes = axis_sizes(mesh)
    model_n = sizes["model"]
    data_n = sizes["data"]
    all_axes = tuple(sizes)
    all_n = 1
    for a in all_axes:
        all_n *= sizes[a]

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        if len(shape) <= 1:
            return placements(spec, mesh)     # norms, biases, 1-d gates
        if pure_fsdp:
            for d in range(len(shape)):
                if shape[d] % all_n == 0 and shape[d] >= all_n:
                    spec[d] = all_axes
                    return placements(spec, mesh)
            for d in range(len(shape)):
                if shape[d] % data_n == 0 and shape[d] >= data_n:
                    spec[d] = "data"
                    return placements(spec, mesh)
            return placements(spec, mesh)
        keys = [k for k in path if isinstance(k, str)]
        is_moe_bank = any(k in ("w_in", "w_gate", "w_out") for k in keys) \
            and "moe" in keys and len(shape) == 3
        if moe_expert_parallel and is_moe_bank and shape[0] % model_n == 0:
            spec[0] = "model"                 # experts on model axis
            for d in range(len(shape) - 1, 0, -1):
                if shape[d] % data_n == 0 and shape[d] >= data_n:
                    spec[d] = "data"          # FSDP within expert
                    break
            return placements(spec, mesh)
        if (tp_pairs and any(k in _ROW_PARALLEL for k in keys)
                and len(shape) == 2):
            if shape[0] % model_n == 0 and shape[0] >= model_n:
                spec[0] = "model"
                if fsdp and shape[1] % data_n == 0:
                    spec[1] = "data"
                return placements(spec, mesh)
        return _weight_spec(shape, mesh, fsdp=fsdp)

    return _map_with_path(rule, params)


def batch_shardings(mesh, batch):
    """Shard the batch dimension over ("pod","data") when divisible."""
    sizes = axis_sizes(mesh)
    daxes = tuple(a for a in sizes if a in ("pod", "data"))
    dsize = 1
    for a in daxes:
        dsize *= sizes[a]

    def rule(path, leaf):
        if leaf.ndim == 0 or leaf.shape[0] % dsize != 0:
            return placements((), mesh)
        return placements((daxes,), mesh)

    return _map_with_path(rule, batch)


def cache_shardings(cfg: ModelConfig, mesh, cache, mode: str = "dh"):
    """Decode caches: batch (dim 0) over the data axes; model-axis
    placement per ``mode``:
      "dh"  — baseline: last divisible trailing dim (usually head_dim)
      "seq" — shard the KV *sequence* dim (dim 1 of (B, W, kv, dh)) over
              "model"."""
    sizes = axis_sizes(mesh)
    daxes = tuple(a for a in sizes if a in ("pod", "data"))
    dsize = 1
    for a in daxes:
        dsize *= sizes[a]
    model_n = sizes["model"]

    def rule(path, leaf):
        spec = [None] * leaf.ndim
        if leaf.ndim == 0:
            return placements(spec, mesh)
        if leaf.shape[0] % dsize == 0:
            spec[0] = daxes
        if mode == "seq":
            # (B, W, kv, dh) / xk (B, Se, kv, dh) / pos (B, W)
            if (leaf.ndim > 1 and leaf.shape[1] % model_n == 0
                    and leaf.shape[1] >= model_n):
                spec[1] = "model"
                return placements(spec, mesh)
        for d in range(leaf.ndim - 1, 0, -1):
            if leaf.shape[d] % model_n == 0 and leaf.shape[d] >= model_n:
                spec[d] = "model"
                break
        return placements(spec, mesh)

    return _map_with_path(rule, cache)


def to_dtensors(mesh, tree, place_tree):
    """Each leaf of ``tree`` (a global-shape tensor, fake or real) as a
    DTensor on ``mesh`` holding rank 0's shard under its placements; the
    shard is a new tensor of the leaf's dtype and device (no data is
    copied: this builds shape-only arguments)."""
    from torch.distributed.tensor import DTensor

    def one(path, leaf):
        place = _leaf_at(place_tree, path)
        local = torch.empty(local_shape(leaf.shape, place, mesh),
                            dtype=leaf.dtype, device=leaf.device)
        return DTensor.from_local(local, mesh, place, run_check=False,
                                  shape=leaf.shape, stride=leaf.stride())

    return _map_with_path(one, tree)


def _leaf_at(tree, path):
    for k in path:
        tree = tree[k]
    return tree
