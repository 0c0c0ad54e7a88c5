"""Model block partitioning + tensor packing (λScale §5), in PyTorch.

A *model block* is a contiguous range of transferable units (encoder
layers, trunk layers, with the embedding absorbed into the first block
and the head/final norm into the last).  ``pack_block`` consolidates every tensor
of a block into ONE contiguous byte buffer (the paper's "tensor packing":
a block becomes a single multicast payload instead of per-tensor sends);
``unpack_block`` restores the tensors bit-exactly.

The counterpart of ``repro.core.blocks`` over the port's per-layer
parameter layout (``repro_torch.models.model``).  Unit keys are the JAX
package's letter for letter (``@layer0003/['attn']['wq']``,
``@head/final_norm['scale']``), so the sorted key order, the byte layout
and the ``PAD_ALIGN`` zero padding are the same, and ``pack_model`` gives
the same bytes as the JAX ``pack_model`` on the same weights.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.cache_ops import bytes_as

PAD_ALIGN = 128     # pad packed buffers to multiples (the JAX layout's)


# ---------------------------------------------------------------- flatten
def _tree_items(prefix: str, tree) -> List[Tuple[str, torch.Tensor]]:
    """(prefix + key path, leaf) pairs, key paths in the JAX ``keystr``
    form (``['attn']['wq']``), dict keys sorted as JAX flattens them."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _tree_items(f"{prefix}['{k}']", tree[k])]
    return [(prefix, tree)]


def flatten_params(cfg: ModelConfig, params) -> Dict[str, torch.Tensor]:
    """Flatten into a unit-major dict: globals (embedding, learned
    positions, patch projection, head, the encoder's positions and final
    norm), encoder layers, trunk layers."""
    flat: Dict[str, torch.Tensor] = {"@embed/embed": params["embed"]}
    for name in ("pos_embed", "patch_proj"):
        if name in params:
            flat[f"@embed/{name}"] = params[name]
    if "head" in params:
        flat["@head/head"] = params["head"]
    flat.update(_tree_items("@head/final_norm", params["final_norm"]))
    if "enc" in params:
        flat["@embed/enc_pos"] = params["enc"]["pos"]
        flat.update(_tree_items("@head/enc_final_norm",
                                params["enc"]["final_norm"]))
        for i, lp in enumerate(params["enc"]["layers"]):
            flat.update(_tree_items(f"@enclayer{i:04d}/", lp))
    for li, lp in enumerate(params["layers"]):
        flat.update(_tree_items(f"@layer{li:04d}/", lp))
    return flat


def build_tree(sub: Dict[str, torch.Tensor]) -> Dict:
    """Rebuild a nested dict from keystr paths like ['attn']['wq']."""
    tree: Dict = {}
    for k, v in sub.items():
        keys = re.findall(r"\['([^']+)'\]", k)
        cur = tree
        for kk in keys[:-1]:
            cur = cur.setdefault(kk, {})
        cur[keys[-1]] = v
    return tree


def unit_items(flat: Dict[str, torch.Tensor], prefix: str
               ) -> Dict[str, torch.Tensor]:
    """The entries of ``flat`` under ``prefix``, keyed by the rest."""
    return {k[len(prefix):]: v for k, v in flat.items()
            if k.startswith(prefix)}


def unflatten_params(cfg: ModelConfig, flat: Dict[str, torch.Tensor]):
    """Inverse of flatten_params: the port's per-layer parameter dict."""
    params: Dict = {"embed": flat["@embed/embed"]}
    for name in ("pos_embed", "patch_proj"):
        if f"@embed/{name}" in flat:
            params[name] = flat[f"@embed/{name}"]
    if "@head/head" in flat:
        params["head"] = flat["@head/head"]
    params["final_norm"] = build_tree(unit_items(flat, "@head/final_norm"))
    params["layers"] = [build_tree(unit_items(flat, f"@layer{li:04d}/"))
                        for li in range(cfg.n_layers)]
    if "@embed/enc_pos" in flat:
        params["enc"] = {
            "pos": flat["@embed/enc_pos"],
            "layers": [build_tree(unit_items(flat, f"@enclayer{i:04d}/"))
                       for i in range(cfg.n_enc_layers)],
            "final_norm": build_tree(unit_items(flat,
                                                "@head/enc_final_norm"))}
    return params


# ----------------------------------------------------------- block ranges
def _unit_of(key: str) -> str:
    return key.split("/")[0]


def unit_order(cfg: ModelConfig) -> List[str]:
    units = ["@embed"]
    units += [f"@enclayer{i:04d}" for i in range(
        cfg.n_enc_layers if cfg.family == "encdec" else 0)]
    units += [f"@layer{i:04d}" for i in range(cfg.n_layers)]
    units += ["@head"]
    return units


def block_assignment(cfg: ModelConfig, n_blocks: int) -> List[List[str]]:
    """Contiguous unit ranges; @embed merges into block 0, @head into the
    last block."""
    units = unit_order(cfg)
    inner = units[1:-1]
    n_blocks = min(n_blocks, max(1, len(inner)))
    per = len(inner) / n_blocks
    blocks = []
    for i in range(n_blocks):
        lo, hi = round(i * per), round((i + 1) * per)
        blocks.append(inner[lo:hi])
    blocks[0] = [units[0]] + blocks[0]
    blocks[-1] = blocks[-1] + [units[-1]]
    return blocks


# ------------------------------------------------------------ pack/unpack
@dataclasses.dataclass(frozen=True)
class TensorSpec:
    key: str
    shape: tuple
    dtype: str       # the dtype's name as numpy/JAX spell it ("bfloat16")
    offset: int      # byte offset in the packed buffer
    nbytes: int


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    block_id: int
    tensors: tuple          # of TensorSpec
    nbytes: int             # payload bytes (unpadded)


def _to_bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().reshape(-1).view(torch.uint8)


def _from_bytes(buf: torch.Tensor, spec: TensorSpec) -> torch.Tensor:
    return bytes_as(buf[spec.offset:spec.offset + spec.nbytes], spec.shape,
                    getattr(torch, spec.dtype))


def pack_block(flat: Dict[str, torch.Tensor], keys: Sequence[str],
               block_id: int = 0) -> Tuple[torch.Tensor, BlockSpec]:
    """Pack the named tensors into one contiguous uint8 buffer on their
    device, zero-padded to a multiple of ``PAD_ALIGN``."""
    specs, parts, off = [], [], 0
    for k in sorted(keys):
        b = _to_bytes(flat[k])
        n = b.shape[0]
        specs.append(TensorSpec(k, tuple(flat[k].shape),
                                str(flat[k].dtype).removeprefix("torch."),
                                off, n))
        parts.append(b)
        off += n
    pad = (-off) % PAD_ALIGN
    if pad:
        dev = parts[0].device if parts else None
        parts.append(torch.zeros((pad,), dtype=torch.uint8, device=dev))
    buf = torch.cat(parts) if parts else torch.zeros((0,), dtype=torch.uint8)
    return buf, BlockSpec(block_id, tuple(specs), off)


def unpack_block(buf: torch.Tensor, spec: BlockSpec
                 ) -> Dict[str, torch.Tensor]:
    """The block's tensors: views into ``buf`` where a tensor's byte
    offset is a multiple of its item size, copies elsewhere."""
    return {ts.key: _from_bytes(buf, ts) for ts in spec.tensors}


def pack_model(cfg: ModelConfig, params, n_blocks: int
               ) -> Tuple[torch.Tensor, List[BlockSpec]]:
    """Pack a whole model into a (n_blocks, P) uint8 tensor (P = max padded
    block size) + per-block specs.  This is the multicast payload."""
    flat = flatten_params(cfg, params)
    assign = block_assignment(cfg, n_blocks)
    bufs, specs = [], []
    for bi, units in enumerate(assign):
        keys = [k for k in flat if _unit_of(k) in set(units)]
        buf, spec = pack_block(flat, keys, bi)
        bufs.append(buf)
        specs.append(spec)
    P = max(b.shape[0] for b in bufs)
    P += (-P) % PAD_ALIGN
    stacked = torch.zeros((len(bufs), P), dtype=torch.uint8,
                          device=bufs[0].device)
    for row, b in zip(stacked, bufs):
        row[:b.shape[0]] = b
    return stacked, specs


def unpack_flat(stacked: torch.Tensor, specs: Sequence[BlockSpec]
                ) -> Dict[str, torch.Tensor]:
    """Every block's tensors in one flat unit-keyed dict."""
    flat: Dict[str, torch.Tensor] = {}
    for bi, spec in enumerate(specs):
        flat.update(unpack_block(stacked[bi], spec))
    return flat


def unpack_model(cfg: ModelConfig, stacked: torch.Tensor,
                 specs: Sequence[BlockSpec]):
    return unflatten_params(cfg, unpack_flat(stacked, specs))


def block_bytes(cfg: ModelConfig, n_blocks: int, bytes_per_param: int = 2
                ) -> float:
    """Analytic per-block payload size (simulator)."""
    return cfg.param_count() * bytes_per_param / n_blocks


def elbow_block_count(model_bytes: float, n_nodes: int, link,
                      candidates: Sequence[int] = (4, 8, 12, 16, 24, 32, 48),
                      tolerance: float = 0.03) -> int:
    """Paper §4.2 'selective block sizes': pick the elbow of T(b) —
    the smallest b whose end-to-end time is within `tolerance` of the
    best candidate (Fig 18 finds 16 for Llama-13B on 8 nodes)."""
    from repro_torch.core.multicast import optimal_steps
    times = {b: optimal_steps(n_nodes, b) * link.step_time(model_bytes / b)
             for b in candidates}
    best = min(times.values())
    for b in sorted(candidates):
        if times[b] <= best * (1 + tolerance):
            return b
    return max(candidates)
