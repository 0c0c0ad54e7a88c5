"""λPipe mode switching (§4.4), in PyTorch.

Once multicast completes, every node holds a full replica and switches from
pipelined (cross-node) execution to local execution.  In-flight requests of
an execution pipeline are redistributed evenly across its member nodes and
each node *recomputes* the KV/recurrent cache for its assigned requests
from the tokens generated so far — the paper argues recomputation beats the
all-to-all transfer of live KV caches.

For recurrent families (SSM/hybrid) "KV recomputation" generalizes to
state recomputation: replaying prompt+generated tokens through the scan —
same code path (``forward(build_cache=True)``, the flash kernel for
attention layers on the card).  The counterpart of
``repro.core.mode_switch``.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, List, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import (cache_from_prefill, forward, n_positions,
                                pack_single_cache)

if TYPE_CHECKING:                                    # pragma: no cover
    from repro_torch.serving.scheduler import SeqState


def redistribute(request_ids: Sequence, nodes: Sequence[int]
                 ) -> Dict[int, List]:
    """Evenly assign in-flight requests to nodes (round-robin)."""
    out: Dict[int, List] = {n: [] for n in nodes}
    for i, rid in enumerate(request_ids):
        out[nodes[i % len(nodes)]].append(rid)
    return out


def recompute_cache(cfg: ModelConfig, params, batch: Dict, *,
                    cache_len: int, kernel_impl: str = "kernel"):
    """Rebuild the striped decode cache from prompt + generated tokens.

    batch["tokens"]: (B, S_so_far) — everything processed so far, with
    the batch's "patches" (vlm) or "frames" (encdec, the encoder is run
    again).  Returns a cache positioned to continue decoding after the
    last position (patches + tokens), equal to having decoded with a live
    cache all along (tested).  MoE layers drop nothing (``moe_cf=None``)."""
    out = forward(cfg, params, batch, build_cache=True, cache_len=cache_len,
                  moe_cf=None, kernel_impl=kernel_impl, last_only=True)
    return cache_from_prefill(cfg, out["kv"], cache_len,
                              n_positions(cfg, batch))


def handoff_requests(cfg: ModelConfig, params,
                     seqs: Sequence["SeqState"], *, cache_len: int,
                     page_size: Optional[int] = None,
                     kernel_impl: str = "kernel") -> Dict[int, Any]:
    """Rebuild decode caches for sequences handed off by a draining
    instance (scheduler ``handoff()`` → local ``adopt()``).

    Each sequence resumes mid-generation: its cache is recomputed once
    over prompt + generated-so-far (all but the last token, which is the
    next decode input), positioned exactly where the draining instance
    stopped — the request re-enters DECODE, never the prefill queue.
    Returns req_id -> batch-1 striped cache, or, when ``page_size`` is
    given, req_id -> ``PackedKV``: only the live pages, packed
    contiguously in the same wire form a live paged handoff ships — so
    recomputed and transferred state adopt through one code path.
    """
    device = params["embed"].device
    out: Dict[int, Any] = {}
    for seq in seqs:
        toks = seq.tokens_so_far
        assert len(toks) >= 2, "nothing decoded yet — resubmit instead"
        batch = {"tokens": torch.tensor([toks[:-1]], dtype=torch.int64,
                                        device=device)}
        cache = recompute_cache(cfg, params, batch, cache_len=cache_len,
                                kernel_impl=kernel_impl)
        if page_size is not None:
            cache = pack_single_cache(cfg, cache, page_size)
        out[seq.req_id] = cache
    return out


def recompute_cost(cfg: ModelConfig, tokens_so_far: int,
                   batch: int, peak_flops: float) -> float:
    """Seconds of recompute per node (prefill FLOPs over the generated
    prefix), used by the simulator to price a mode switch."""
    flops = 2.0 * cfg.active_param_count() * tokens_so_far * batch
    return flops / peak_flops


def kv_transfer_cost(cfg: ModelConfig, tokens_so_far: int, batch: int,
                     n_nodes: int, link_bandwidth: float) -> float:
    """Alternative the paper rejects: all-to-all of live KV caches."""
    n_attn = sum(1 for i in range(cfg.n_layers)
                 if cfg.mixer_of(i).startswith("attn"))
    kv_bytes = (2 * n_attn * cfg.n_kv_heads * cfg.d_head *
                tokens_so_far * batch * 2)
    # each node must fetch the shards of the other n-1 nodes
    return kv_bytes * (n_nodes - 1) / n_nodes / link_bandwidth
