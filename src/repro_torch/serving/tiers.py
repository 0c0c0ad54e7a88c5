"""Storage tiers and the per-node model manager (λScale §5).

Hardware constants default to the paper's GPU testbed (§7: H800 GPUs
joined by 400 Gb/s InfiniBand ≈ 50 GB/s, and Table 1: 64 GB/s host,
5 GB/s NVMe), so the port's simulated clock prices the hardware the paper
measured.  ``H800`` names that default profile.  The link constants
themselves live in ``core.multicast`` (single calibration point shared
with ``LinkModel``).

``ModelManager`` is the per-node runtime state: packed blocks for
*multiple* models across explicit GPU / host-memory tiers, with LRU
eviction on the host tier and host-memory fallback on GPU scale-down.
``ClusterState`` aggregates one manager per node and is shared by the
discrete-event simulator (metadata-only shards) and the live cluster
(shards carrying real wire buffers + unpacked tensors).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Set

from repro_torch.core.multicast import (DEFAULT_LINK_BW,
                                        DEFAULT_STEP_OVERHEAD, LinkModel,
                                        RestorePlan, pipelined_restore)


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    name: str = "h800"
    link_bw: float = DEFAULT_LINK_BW         # bytes/s inter-node
    step_overhead: float = DEFAULT_STEP_OVERHEAD  # s per multicast step
    hbm_bw: float = 3350e9           # bytes/s
    peak_flops: float = 990e12      # bf16
    host_to_gpu_bw: float = 64e9     # bytes/s (paper Table 1)
    ssd_bw: float = 5e9              # bytes/s (paper Table 1)
    remote_bw: float = 1.25e9        # bytes/s (10 Gb/s registry path)
    gpu_mem_models: int = 1          # full model replicas per node GPU
    host_mem_models: int = 3         # paper §2.3 simulation setting
    nccl_group_init: float = 0.30    # s (paper §7.2: 100s of ms)
    # cold-start fast path (ServerlessLLM-style multi-tier loading):
    # fixed cost to open a block-granular snapshot (metadata + mmap),
    # and the one-time jit/compile cost a replica pays when the
    # persistent compile cache misses (0 ⇒ compilation not modelled)
    snapshot_restore_s: float = 0.02
    jit_compile_s: float = 0.0

    def link_model(self) -> LinkModel:
        """The multicast step-time model this profile calibrates."""
        return LinkModel.from_profile(self)

    def fetch_seconds(self, nbytes: float, tier: str) -> float:
        """Seconds to materialize ``nbytes`` into GPU memory from a
        storage tier: 'gpu' (already resident), 'host' (local host
        memory), 'remote' (another node's host memory via one-sided
        RDMA), 'ssd' (local NVMe), 'registry' (remote model store)."""
        bw = {"gpu": float("inf"), "host": self.host_to_gpu_bw,
              "remote": self.link_bw, "ssd": self.ssd_bw,
              "registry": self.remote_bw}[tier]
        return nbytes / bw

    def restore_stages(self, tier: str):
        """(overhead, ordered per-stage bandwidths) a restore from
        ``tier`` moves through before the bytes are GPU-resident.  The
        'ssd' path is the snapshot tier: NVMe read then host→GPU copy,
        plus the fixed snapshot-open cost; 'remote'/'registry' stage
        through the puller's host memory the same way."""
        return {
            "gpu": (0.0, ()),
            "host": (0.0, (self.host_to_gpu_bw,)),
            "ssd": (self.snapshot_restore_s,
                    (self.ssd_bw, self.host_to_gpu_bw)),
            "remote": (0.0, (self.link_bw, self.host_to_gpu_bw)),
            "registry": (0.0, (self.remote_bw, self.host_to_gpu_bw)),
        }[tier]

    def restore_plan(self, nbytes: float, n_chunks: int, tier: str,
                     pipelined: bool = True) -> RestorePlan:
        """Chunked multi-stage restore timing from ``tier`` to GPU.
        Pipelined, chunks overlap across stages (execute-while-load can
        start at ``t_first``); naive reproduces the blocking whole-blob
        fetch each stage at a time."""
        overhead, bws = self.restore_stages(tier)
        return pipelined_restore(nbytes, n_chunks, bws,
                                 overhead=overhead, pipelined=pipelined)


H800 = HardwareProfile()     # the paper's testbed: the default profile


class LRUCache:
    """LRU set of model ids cached in a node's host memory.

    Optionally carries a payload per model (the live cluster stores the
    packed block shard there; the simulator stores nothing) — evicting a
    model drops its payload, unless a ``spill`` callback is installed
    (``ModelManager`` wires one so payload-carrying evictions demote to
    the SSD snapshot tier instead of vanishing)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._d: "OrderedDict[str, float]" = OrderedDict()
        self._payload: Dict[str, Any] = {}
        self.evictions: List[tuple] = []     # (model, t_in, t_out)
        self.spill = None                    # (model, payload, now) -> None

    def touch(self, model: str, now: float, payload: Any = None) -> None:
        if payload is not None:
            self._payload[model] = payload
        if model in self._d:
            self._d.move_to_end(model)
            return
        self._d[model] = now
        while len(self._d) > self.capacity:
            old, t_in = self._d.popitem(last=False)
            dropped = self._payload.pop(old, None)
            if dropped is not None and self.spill is not None:
                self.spill(old, dropped, now)
            self.evictions.append((old, t_in, now))

    def get(self, model: str) -> Any:
        return self._payload.get(model)

    def pop(self, model: str) -> Any:
        """Remove a model (promotion to GPU); returns its payload."""
        self._d.pop(model, None)
        return self._payload.pop(model, None)

    def __contains__(self, model: str) -> bool:
        return model in self._d

    def models(self) -> Set[str]:
        return set(self._d)


@dataclasses.dataclass
class ModelShard:
    """One model's blocks resident on one node.

    ``buffers`` maps block id → packed wire buffer (np.ndarray in the
    live cluster, None-valued placeholders are never stored); ``flat``
    holds the unpacked tensors and exists only while the shard sits in
    the GPU tier.  The simulator keeps metadata-only shards (no buffers).
    """
    model: str
    n_blocks: int = 0                # blocks of a full replica (0: unknown)
    buffers: Dict[int, Any] = dataclasses.field(default_factory=dict)
    flat: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def complete(self) -> bool:
        return self.n_blocks > 0 and len(self.buffers) == self.n_blocks


@dataclasses.dataclass
class ModelManager:
    """A node's model manager (§5): multi-model storage across tiers.

    GPU tier: up to ``gpu_capacity`` resident models (unpacked, servable).
    Host tier: ``host_cache`` LRU of packed shards (fallback on
    scale-down; the locality-driven startup's warm source).
    SSD tier: ``ssd`` block-granular snapshots — unbounded (NVMe is
    cheap), fed by host-LRU pressure spills and explicit
    ``demote_to_ssd`` parks; a restore streams back through the host
    tier chunk-by-chunk (``HardwareProfile.restore_plan``).
    """
    node_id: int
    gpu_capacity: int = 1
    gpu: "OrderedDict[str, ModelShard]" = dataclasses.field(
        default_factory=OrderedDict)
    host_cache: LRUCache = dataclasses.field(
        default_factory=lambda: LRUCache(capacity=3))
    ssd: Dict[str, ModelShard] = dataclasses.field(default_factory=dict)
    gpu_busy_since: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    # host-tier holding pen for preempted sequences: model → req_id →
    # opaque (seq, payload, …) parking record, FIFO per model.  Packed
    # KV pages are host-memory bytes like a demoted shard's buffers —
    # the GPU pool stops paying for a parked sequence entirely.
    parked: Dict[str, "OrderedDict[int, Any]"] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self) -> None:
        # host-LRU pressure spills payload-carrying shards down to the
        # snapshot tier instead of dropping them — a later cold start
        # restores from local NVMe rather than the remote registry
        self.host_cache.spill = \
            lambda model, shard, now: self.ssd.setdefault(model, shard)

    # -------------------------------------------------------- tier queries
    @property
    def gpu_model(self) -> Optional[str]:
        """The GPU-resident model (oldest first when several)."""
        return next(iter(self.gpu), None)

    @property
    def gpu_free(self) -> bool:
        return len(self.gpu) < self.gpu_capacity

    def has_block(self, model: str, block_id: int) -> bool:
        shard = self.gpu.get(model)
        return shard is not None and block_id in shard.buffers

    def gpu_shard(self, model: str) -> Optional[ModelShard]:
        return self.gpu.get(model)

    # --------------------------------------------------------- GPU intake
    def admit(self, model: str, n_blocks: int, now: float,
              shard: Optional[ModelShard] = None) -> List[str]:
        """Open (or reuse) a GPU-tier shard for ``model``; returns models
        demoted to host memory to make room (LRU over GPU residents)."""
        if model in self.gpu:
            return []
        demoted = []
        while len(self.gpu) >= self.gpu_capacity:
            old = next(iter(self.gpu))
            self.demote(old, now)
            demoted.append(old)
        self.gpu[model] = shard or ModelShard(model, n_blocks)
        self.gpu_busy_since.setdefault(model, now)
        return demoted

    def receive(self, model: str, block_id: int, buf: Any,
                flat_update: Optional[Dict[str, Any]] = None) -> bool:
        """Store one packed block (and its unpacked tensors) in the GPU
        shard.  Returns False when the block was already resident."""
        shard = self.gpu[model]
        if block_id in shard.buffers:
            return False
        shard.buffers[block_id] = buf
        if flat_update:
            shard.flat.update(flat_update)
        return True

    # ------------------------------------------------- tier transitions
    def demote(self, model: str, now: float) -> None:
        """GPU → host fallback (§5 scale-down): keep the packed wire
        buffers in host memory (LRU), drop the unpacked tensors."""
        shard = self.gpu.pop(model)
        shard.flat = {}
        self.gpu_busy_since.pop(model, None)
        self.host_cache.touch(model, now,
                              payload=shard if shard.buffers else None)

    def promote(self, model: str, now: float) -> Optional[ModelShard]:
        """Host → GPU (locality-driven warm start): move the packed shard
        back to the GPU tier; the caller re-unpacks tensors and pays the
        host→GPU transfer (``HardwareProfile.fetch_seconds``).

        A payload-less cache entry (metadata-only warmth, e.g. a demoted
        shard whose buffers were never received) is treated as COLD: it
        cannot produce a servable replica, so the stale entry is dropped
        and the caller must take a real fetch path instead."""
        if model not in self.host_cache:
            return None
        shard = self.host_cache.pop(model)
        if shard is None or not shard.buffers:
            return None
        self.admit(model, shard.n_blocks, now, shard=shard)
        return shard

    def demote_to_ssd(self, model: str, now: float) -> bool:
        """Host → SSD park (scale-to-zero): move the packed shard out of
        the host LRU into a block-granular snapshot, freeing the host
        slot.  Metadata-only entries park as metadata-only snapshots (the
        simulator's tier bookkeeping).  Returns False when the model held
        no host-tier entry at all."""
        if model not in self.host_cache:
            return False
        shard = self.host_cache.pop(model)
        self.ssd[model] = shard if shard is not None \
            else ModelShard(model, 0)
        return True

    def snapshot(self, model: str) -> Optional[ModelShard]:
        """The model's SSD snapshot, if one exists (payload or metadata)."""
        return self.ssd.get(model)

    def promote_from_ssd(self, model: str) -> Optional[ModelShard]:
        """Take the snapshot out of the SSD tier for a restore.  The
        caller streams it up through host memory (restore_plan prices the
        pipeline) and admits it to the GPU tier.  Payload-less snapshots
        return None (cold miss — restore from the registry instead) but
        stay recorded so tier accounting still sees the park."""
        shard = self.ssd.get(model)
        if shard is None or not shard.buffers:
            return None
        del self.ssd[model]
        return shard

    # ------------------------------------------- preempted-sequence park
    def park_seq(self, model: str, req_id: int, record: Any) -> None:
        """Park a preempted sequence's record in host memory (FIFO per
        model).  Re-parking an id overwrites its record."""
        self.parked.setdefault(model, OrderedDict())[req_id] = record

    def pop_parked(self, model: str, req_id: int) -> Any:
        """Take one parked record back out (resume or shed)."""
        pen = self.parked.get(model)
        record = pen.pop(req_id)
        if not pen:
            del self.parked[model]
        return record

    def parked_ids(self, model: str) -> List[int]:
        """Parked req_ids for ``model``, oldest first."""
        return list(self.parked.get(model, ()))


class ClusterState:
    """One ``ModelManager`` per node + GPU-time accounting, shared by the
    discrete-event simulator and the live cluster."""

    def __init__(self, n_nodes: int, hw: HardwareProfile):
        self.hw = hw
        self.nodes = [
            ModelManager(i, gpu_capacity=hw.gpu_mem_models,
                         host_cache=LRUCache(hw.host_mem_models))
            for i in range(n_nodes)]
        self.gpu_seconds = 0.0

    # ---------------- locality-driven startup queries (§5) ----------------
    def gpu_nodes(self, model: str) -> List[int]:
        return [n.node_id for n in self.nodes if model in n.gpu]

    def warm_nodes(self, model: str) -> List[int]:
        return [n.node_id for n in self.nodes
                if model in n.host_cache and n.gpu_free]

    def free_nodes(self) -> List[int]:
        return [n.node_id for n in self.nodes if n.gpu_free]

    def ssd_nodes(self, model: str) -> List[int]:
        """Nodes holding a local SSD snapshot of ``model`` with a free
        GPU slot — the cheapest cold restore source."""
        return [n.node_id for n in self.nodes
                if model in n.ssd and n.gpu_free]

    # ---------------------- GPU occupancy accounting ----------------------
    def occupy(self, node_id: int, model: str, now: float) -> None:
        n = self.nodes[node_id]
        assert n.gpu_free, f"node {node_id} GPU tier full"
        n.admit(model, 0, now)

    def release(self, node_id: int, now: float,
                model: Optional[str] = None) -> None:
        n = self.nodes[node_id]
        model = model or n.gpu_model
        assert model is not None and model in n.gpu
        self.gpu_seconds += now - n.gpu_busy_since[model]
        n.demote(model, now)                 # falls back to host memory

    def finalize(self, now: float) -> None:
        for n in self.nodes:
            for model, since in n.gpu_busy_since.items():
                self.gpu_seconds += now - since
                n.gpu_busy_since[model] = now
