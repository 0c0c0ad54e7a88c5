"""Live cluster manager (paper Fig 4) — multi-model tiered runtime, in
PyTorch.

In-process, N emulated nodes, all on one device (``device=``: the GPU
unless the caller asks for the CPU).  Each node runs a ``ModelManager``
(``serving/tiers.py``) holding *wire-format packed blocks* for multiple
models across explicit GPU / host-memory tiers; the cluster manager owns
one λPipe ``ScalePlan`` per actively-scaling model and can run several
concurrently (disjoint node sets).

Scaling (§4/§5): ``scale(model, n_new)`` picks multicast sources by tier
locality — GPU-resident replicas are free, a host-warm node promotes its
own copy (64 GB/s), a cold node reads a remote host copy over the link or
falls back to SSD — each priced via ``HardwareProfile.fetch_seconds`` on
the cluster's simulated clock.  ``step()`` advances every active multicast
one schedule step, physically copying block buffers between node managers
(the same byte movement ``distributed.collectives`` performs across
ranks).  The wire buffers stay host ``np.uint8`` rows, as the JAX
package's do; a node's GPU tier is the one device copy of each row it
holds and the unpacked tensors that view it.

Serving: every serving option is a continuous-batching instance driven by
the request-level ``Scheduler`` — hot sources and mode-switched
replicas run ``ContinuousBatchingEngine`` on their local replica, ready
λPipe execution pipelines run ``PipelinedEngine`` whose forward executes
``core.partial_exec.apply_layer_range`` on the blocks each member node
actually holds (§4.3).  A request admitted mid-multicast is drained and
handed off at mode switch (§4.4): it resumes in DECODE on a local replica
with its generated tokens intact — never re-prefilled, exact-token-equal
to the static reference engine (tested).

The counterpart of ``repro.serving.cluster``.  The persistent compile
cache (``compile_cache=``) is not ported: passing one raises.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.blocks import (BlockSpec, block_assignment,
                                     pack_model, unflatten_params,
                                     unpack_block)
from repro_torch.core.ewl import ScalePlan, plan_scale
from repro_torch.core.mode_switch import recompute_cost
from repro_torch.core.partial_exec import (apply_layer_range,
                                           embed_from_flat, head_from_flat,
                                           layer_range_of_units)
from repro_torch.core.pipeline import ExecutionPipeline
from repro_torch.models import PackedKV, payload_nbytes
from repro_torch.serving.autoscaler import (Autoscaler, LoadSignals,
                                            ScaleDown, ScaleUp)
from repro_torch.serving.engine import (DEFAULT_PAGE_SIZE,
                                        ContinuousBatchingEngine)
from repro_torch.serving.metrics import MetricsLog
from repro_torch.serving.placement import PlacementArbiter
from repro_torch.serving.scheduler import AdmissionPolicy
from repro_torch.serving.simulator import SimModel
from repro_torch.serving.tiers import (ClusterState, HardwareProfile,
                                       ModelShard)
from repro_torch.serving.workload import Request, SLOClass

DEFAULT_TICK_SECONDS = 0.002     # replay decode clock when no roofline

if TYPE_CHECKING:                                    # pragma: no cover
    # runtime import happens lazily in _on_scale_progress:
    # distributed.pipeline itself imports the serving package
    from repro_torch.distributed.pipeline import PipelinedEngine

DEFAULT_MAX_K = 4


# ------------------------------------------------------------- deployments
@dataclasses.dataclass
class ModelDeployment:
    """A registered model: config + packed wire blocks (the registry copy
    every cold load and multicast source ultimately descends from)."""
    name: str
    cfg: ModelConfig
    n_blocks: int
    assign: List[List[str]]          # block id -> unit names
    specs: List[BlockSpec]
    registry: np.ndarray             # (n_blocks, P) packed uint8 blocks

    @property
    def nbytes(self) -> float:
        """Wire bytes of one full replica (padded blocks)."""
        return float(self.registry.size)

    @property
    def block_nbytes(self) -> float:
        return float(self.registry.shape[1])


@dataclasses.dataclass
class PipeInstance:
    """A live λPipe execution-pipeline serving instance."""
    pipe: ExecutionPipeline
    plan_nodes: List[int]            # plan-local member ids
    members: List[int]               # real node ids
    engine: "PipelinedEngine"
    drained: bool = False


@dataclasses.dataclass
class ModelServing:
    """Per-model serving state: every instance is scheduler-driven.

    ``locals_`` holds the decode-capable replicas (role ``unified`` or
    ``decode`` — both adopt and decode; only unified also prefills);
    ``prefills`` is the disaggregated prompt pool: prefill-role engines
    that run prompt passes only and stream finished prompts to a
    ``locals_`` engine over the PackedKV wire (the tick-time export
    pump).  An empty ``prefills`` dict is today's unified serving,
    byte-identical."""
    locals_: Dict[int, ContinuousBatchingEngine] = dataclasses.field(
        default_factory=dict)
    prefills: Dict[int, ContinuousBatchingEngine] = dataclasses.field(
        default_factory=dict)
    pipes: List[PipeInstance] = dataclasses.field(default_factory=list)
    # (req_id, prompt, max_new, t_arrive, slo) waiting for capacity
    pending: List[Tuple[int, List[int], int, Optional[float],
                        Optional[SLOClass]]] = \
        dataclasses.field(default_factory=list)

    def live_pipes(self) -> List[PipeInstance]:
        return [p for p in self.pipes if not p.drained]


@dataclasses.dataclass
class ActiveScale:
    """One in-flight k→N scaling operation (one per model; several models
    may scale concurrently on disjoint node sets)."""
    model: str
    plan: ScalePlan
    node_map: Dict[int, int]         # plan-local id -> real node id
    t0: float                        # clock when the multicast starts
    step_time: float
    steps_done: int = 0
    spawned: Set[int] = dataclasses.field(default_factory=set)
    switched: Set[int] = dataclasses.field(default_factory=set)
    # role the mode-switched destinations assume (None → unified):
    # a disagg pool scales its own side without touching the other
    role: Optional[str] = None

    @property
    def done(self) -> bool:
        return self.steps_done >= self.plan.total_steps

    def time_at(self, step: int) -> float:
        return self.t0 + step * self.step_time

    @property
    def now(self) -> float:
        return self.time_at(self.steps_done)


@dataclasses.dataclass(frozen=True)
class ScaleReport:
    """Simulated-clock accounting of one ``scale()`` call — the numbers
    the locality benchmarks compare (GPU-hot vs host-warm vs cold)."""
    model: str
    source_tier: str                 # gpu | host | remote | ssd
    sources: Tuple[int, ...]
    dests: Tuple[int, ...]
    k: int
    t_request: float
    t_source_ready: float            # multicast start (source on GPU tier)
    t_first_serve: float             # first NEW serving instance available
    t_complete: float                # every destination mode-switched
    # cold-start breakdown (0 on GPU-tier scales): seconds the source
    # spent moving bytes through the loading pipeline vs building
    # executables the compile cache did not already hold
    fetch_seconds: float = 0.0
    compile_seconds: float = 0.0

    @property
    def startup_latency(self) -> float:
        return self.t_first_serve - self.t_request


@dataclasses.dataclass(frozen=True)
class HandoffDecision:
    """One request's §4.4 resume-path pricing at a drain/handoff: ship the
    packed live KV over the link, or recompute it from tokens — whichever
    the ``HardwareProfile`` prices cheaper.  The audit trail
    (``LiveCluster.handoff_log``) is what ``bench_paged`` reports."""
    model: str
    req_id: int
    n_tokens: int
    payload_bytes: int               # wire bytes the payload WOULD move
    t_transfer: float
    t_recompute: float
    chosen: str                      # "transfer" | "recompute" | "fresh"

    @property
    def t_chosen(self) -> float:
        return {"transfer": self.t_transfer,
                "recompute": self.t_recompute}.get(self.chosen, 0.0)


@dataclasses.dataclass(frozen=True)
class AuditEvent:
    """One overload-survival decision on ``LiveCluster.audit_log``: a
    shed at submit, a preemption (victim packed off its slot), a park to
    the host tier, a resume back onto a replica, or a park-timeout
    re-route/shed.  The log is deterministic given the trace — the
    degradation ORDER under overload is itself an output."""
    t: float
    kind: str                 # shed | preempt | park | resume | park_timeout
    model: str
    req_id: int
    detail: str = ""
    retry_after: float = 0.0


# ----------------------------------------------------------------- cluster
class LiveCluster:
    """``n_nodes`` emulated nodes on ``device`` (None: the GPU, which
    must be present; ``"cpu"`` runs every kernel wrapper's plain
    version).  Every node's GPU tier, every engine and every pipeline
    lives on that one device, so all launches share its stream.
    ``compile_cache`` is not ported: passing one raises
    ``NotImplementedError``; the default (no cache, no modelled
    compilation, ``hw.jit_compile_s == 0``) is the JAX path unchanged."""

    def __init__(self, *, n_nodes: int, hw: Optional[HardwareProfile] = None,
                 n_slots: int = 4, max_len: int = 96,
                 max_prefill_per_tick: int = 1, paged: bool = True,
                 page_size: int = DEFAULT_PAGE_SIZE,
                 prefix_sharing: bool = True,
                 admission: Optional[AdmissionPolicy] = None,
                 arbiter: Optional[PlacementArbiter] = None,
                 preemption: bool = False,
                 shed_limit: Optional[int] = None,
                 max_park_ticks: Optional[int] = None,
                 pipelined_loading: bool = True,
                 compile_cache=None, device=None):
        if compile_cache is not None:
            raise NotImplementedError(
                "the compile cache (repro.kernels.compile_cache) is not "
                "ported; run without compile_cache")
        self.device = resolve_device(device)
        self.hw = hw or HardwareProfile()
        self.state = ClusterState(n_nodes, self.hw)
        self.nodes = self.state.nodes
        self.link = self.hw.link_model()
        self.n_slots = n_slots
        self.max_len = max_len
        self.max_prefill_per_tick = max_prefill_per_tick
        self.paged = paged
        self.page_size = page_size
        # CoW prefix sharing on every paged local engine (each engine
        # auto-gates off for layouts that cannot share at page
        # granularity — recurrent/xLSTM mixes)
        self.prefix_sharing = prefix_sharing
        # the request control plane: one AdmissionPolicy shared by every
        # scheduler this cluster creates (FCFS default), one
        # PlacementArbiter owning node assignment (warm packing, scale
        # destinations, contention grants, handoff targets)
        self.admission = admission or AdmissionPolicy()
        self.arbiter = arbiter or PlacementArbiter()
        # overload survival (opt-in): engines preempt low-priority decode
        # slots for higher-class arrivals, schedulers shed past
        # shed_limit queued same-or-higher-priority requests, and parked
        # sequences time out after max_park_ticks cluster ticks
        self.preemption = preemption
        self.shed_limit = shed_limit
        self.max_park_ticks = max_park_ticks
        # cold-start fast path: pipelined multi-tier loading engine
        # (False = the naive blocking whole-blob fetch, the comparator
        # bench_coldstart beats); every cold source pays
        # ``hw.jit_compile_s`` (artifacts die with replicas)
        self.pipelined_loading = pipelined_loading
        # every cold (non-GPU-source) scale's breakdown, append-only —
        # (t_request, model, tier, fetch_s, compile_s, t_ready)
        self.coldstart_log: List[Tuple[float, str, str, float, float,
                                       float]] = []
        self.audit_log: List[AuditEvent] = []
        # control-plane-answered health probes (no replica existed —
        # liveness was answered WITHOUT waking the model)
        self.probe_answers: Dict[str, int] = {}
        # event outboxes the replay loop drains into the MetricsLog
        # ((model, req_id, retry_after) / (model, req_id, pages))
        self._shed_events: List[Tuple[str, int, float]] = []
        self._preempt_events: List[Tuple[str, int, int]] = []
        self._coldstart_events: List[Tuple[float, str, str, float, float,
                                           float]] = []
        # model → {req_id: generated} of engines torn down by scale_down
        # (``results`` merges these — scale-to-zero must not lose tokens)
        self._retired_results: Dict[str, Dict[int, List[int]]] = {}
        self._tick_no = 0
        # (model, node, req_id) -> tick a resume-queue park was first seen
        self._park_age: Dict[Tuple[str, int, int], int] = {}
        self.handoff_log: List[HandoffDecision] = []
        self.clock = 0.0
        self.models: Dict[str, ModelDeployment] = {}
        self.serving: Dict[str, ModelServing] = {}
        self.scales: Dict[str, ActiveScale] = {}
        self._next_id = 0
        # (model, node) -> simulated time its local engine may serve:
        # a source acquired from host/SSD exists immediately (the buffers
        # are materialized in-process) but is not READY until the priced
        # fetch completes — the replay loop routes around it until then
        self._ready_at: Dict[Tuple[str, int], float] = {}

    # -------------------------------------------------------- registration
    def register(self, name: str, cfg: ModelConfig, params, *,
                 n_blocks: int, hot_nodes: Sequence[int] = (),
                 warm_nodes: Sequence[int] = (),
                 warm_copies: int = 0,
                 prefill_nodes: Sequence[int] = (),
                 decode_nodes: Sequence[int] = ()) -> ModelDeployment:
        """Pack ``params`` into wire blocks and (optionally) pre-place the
        model: ``hot_nodes`` get a GPU-resident replica with a live local
        engine; host-tier warm copies (the §5 locality tier a later
        ``scale`` starts from) are packed across nodes by the
        ``PlacementArbiter`` — ask for ``warm_copies=n`` and the arbiter
        spreads them over the least-loaded host caches; ``warm_nodes``
        remains as an explicit pin for tests/benchmarks that need a
        specific layout.  ``prefill_nodes``/``decode_nodes`` stand up a
        disaggregated deployment: the prefill pool runs prompt passes
        only and streams finished prompts to the decode pool over the
        PackedKV wire (each pool then autoscales independently)."""
        assert cfg.family != "encdec", "runtime covers decoder-only families"
        stacked, specs = pack_model(cfg, params, n_blocks)
        stacked = stacked.cpu().numpy()     # the host registry copy
        dep = ModelDeployment(name, cfg, stacked.shape[0],
                              block_assignment(cfg, stacked.shape[0]),
                              specs, stacked)
        self.models[name] = dep
        self.serving[name] = ModelServing()
        for nd in hot_nodes:
            self._load_full(name, nd)
            self._ensure_local(name, nd)
        for nd, role in [(nd, "prefill") for nd in prefill_nodes] + \
                        [(nd, "decode") for nd in decode_nodes]:
            self._load_full(name, nd)
            self._ensure_local(name, nd, role=role)
        def warm_up(nd: int) -> None:
            shard = ModelShard(name, dep.n_blocks,
                               buffers={b: dep.registry[b]
                                        for b in range(dep.n_blocks)})
            self.nodes[nd].host_cache.touch(name, self.clock, payload=shard)

        for nd in warm_nodes:
            warm_up(nd)
        if warm_copies:      # arbiter packing skips already-warm nodes
            for nd in self.arbiter.place_warm(self.state, name,
                                              warm_copies):
                warm_up(nd)
        return dep

    def _unpack(self, dep: ModelDeployment, block_id: int, buf):
        """The block's tensors on the cluster's device: one copy of the
        host wire row, viewed at dtype-aligned offsets (the row stays
        alive as long as a tensor of the block does)."""
        row = torch.from_numpy(buf).to(self.device, copy=True)
        return unpack_block(row, dep.specs[block_id])

    def _load_full(self, model: str, node_id: int) -> None:
        """Materialize a full GPU-tier replica on ``node_id`` from the
        registry copy (caller prices the transfer on the clock)."""
        dep = self.models[model]
        mm = self.nodes[node_id]
        mm.admit(model, dep.n_blocks, self.clock)
        for b in range(dep.n_blocks):
            mm.receive(model, b, dep.registry[b],
                       self._unpack(dep, b, dep.registry[b]))

    # ------------------------------------------------------------- engines
    def _ensure_local(self, model: str, node_id: int,
                      role: str = "unified") -> ContinuousBatchingEngine:
        """Local engine for ``model`` on ``node_id``; prefill-role engines
        live in the separate ``prefills`` pool (they are not adoption or
        unified-routing candidates), everything else in ``locals_``.  A
        node already hosting the model's engine keeps it — role is fixed
        at creation (``set_role`` relaxes decode→unified at runtime)."""
        sv = self.serving[model]
        pool = sv.prefills if role == "prefill" else sv.locals_
        other = sv.locals_ if role == "prefill" else sv.prefills
        assert node_id not in other, \
            (model, node_id, "node already hosts the other role's engine")
        if node_id not in pool:
            dep = self.models[model]
            shard = self.nodes[node_id].gpu_shard(model)
            assert shard is not None and shard.complete, \
                (model, node_id, "local engine needs a full replica")
            params = unflatten_params(dep.cfg, shard.flat)
            pool[node_id] = ContinuousBatchingEngine(
                dep.cfg, params, n_slots=self.n_slots, max_len=self.max_len,
                max_prefill_per_tick=self.max_prefill_per_tick,
                paged=self.paged, page_size=self.page_size,
                prefix_sharing=self.prefix_sharing,
                policy=self.admission, role=role,
                shed_limit=self.shed_limit, preemption=self.preemption)
        return pool[node_id]

    def _pipeline_forward(self, model: str, pipe: ExecutionPipeline,
                          node_map: Dict[int, int]):
        """Full-sequence forward walking blocks in model order; each
        block's layers execute on the (real) node that owns it (§4.3 —
        activations hop between stages, the KV/state never moves).

        ``fwd(tokens (B, S), last (B,))`` gives the (B, vocab) logits at
        each row's ``last`` position (``PipelinedEngine``'s contract: only
        those rows reach the head); ``last=None`` gives the full (B, S,
        vocab) logits (the diagnostic ``forward``).  Flat tensors are
        looked up at call time, never held, so a scale-down frees them."""
        dep = self.models[model]
        cfg = dep.cfg
        owner = {b: node_map[n] for b, n in pipe.block_map().items()}

        def flat_of(node_id: int):
            return self.nodes[node_id].gpu_shard(model).flat

        @torch.no_grad()
        def fwd(tokens, last: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
            tokens = torch.as_tensor(tokens, device=self.device)
            B, S = tokens.shape
            positions = torch.arange(S, device=self.device).expand(B, S)
            x = embed_from_flat(cfg, flat_of(owner[0]), tokens)
            for b in range(dep.n_blocks):
                lo, hi = layer_range_of_units(dep.assign[b])
                x = apply_layer_range(cfg, flat_of(owner[b]), x, lo, hi,
                                      positions)
            if last is not None:
                x = x[torch.arange(B, device=x.device), last][:, None]
            # the head lives in the last block; tied embeddings live in
            # block 0 — route the final activation to whichever node owns
            # both pieces (one extra hop for tied-embedding models)
            last_node = owner[dep.n_blocks - 1]
            head_node = owner[0] if cfg.tie_embeddings else last_node
            flat = dict(flat_of(last_node))
            flat.update(flat_of(head_node))
            logits = head_from_flat(cfg, flat, x)
            return logits if last is None else logits[:, 0]

        return fwd

    # ------------------------------------------------------------- scaling
    def scale(self, model: str, n_new: int, *, k: Optional[int] = None,
              role: Optional[str] = None) -> ScaleReport:
        """Locality-driven k→N scale-up (§5): acquire sources by tier
        (GPU > host > remote-host > SSD), start the k-way multicast to
        ``n_new`` free destination nodes, and let execution pipelines
        serve during loading.  Returns simulated-clock accounting.

        ``role`` grows one disagg pool: destinations mode-switch into
        that role, and the arbiter ranks them near the OTHER pool's
        nodes (a new decode replica lands beside the prefill nodes that
        will stream KV to it, and vice versa).  A cold-acquired source
        always comes up unified — it must serve whole requests until
        the pools exist."""
        dep = self.models[model]
        assert model not in self.scales, \
            f"{model}: one scale operation at a time"
        t_req = self.clock
        sources = self.state.gpu_nodes(model)
        tier, t0 = "gpu", t_req
        fresh_source = None
        fetch_s = compile_s = src_chunk_dt = 0.0
        t_local = t_req
        if not sources:
            nd, tier = self._acquire_source(model)
            # chunked restore through the tier's bandwidth pipeline
            # (SSD→host→GPU stages overlapped when pipelined_loading):
            # the FIRST block is GPU-resident at t_first — the multicast
            # (and with it execute-while-load) starts THERE, not after
            # the whole blob lands — while the source itself serves only
            # once fully loaded and compiled (t_total + compile)
            rp = self.hw.restore_plan(dep.nbytes, dep.n_blocks, tier,
                                      pipelined=self.pipelined_loading)
            compile_s = self._charge_compile(model)
            fetch_s, src_chunk_dt = rp.t_total, rp.chunk_dt
            t0 = t_req + rp.t_first
            t_local = t_req + rp.t_total + compile_s
            sources, fresh_source = [nd], nd
            self._ensure_local(model, nd)
            self._ready_at[(model, nd)] = t_local
            self.coldstart_log.append(
                (t_req, model, tier, fetch_s, compile_s, t_local))
            self._coldstart_events.append(
                (t_req, model, tier, fetch_s, compile_s, t_local))
        k = max(1, min(k or DEFAULT_MAX_K, len(sources), DEFAULT_MAX_K))
        srcs = sources[:k]
        # arbiter-ranked destinations (§5 locality: warm-for-this-model
        # first, then least host-cache collateral) instead of first-free;
        # role-split scale-outs additionally rank near the feeding pool
        sv = self.serving[model]
        near: Tuple[int, ...] = ()
        if role == "decode":
            near = tuple(sv.prefills)
        elif role == "prefill":
            near = tuple(sv.locals_)
        dests = self.arbiter.pick_dests(self.state, model, max(n_new, 0),
                                        exclude=srcs, near=near)
        first_serve = [t_local] if fresh_source is not None else []
        t_complete = t_local
        if dests:
            for nd in dests:
                self.nodes[nd].admit(model, dep.n_blocks, self.clock)
            plan = plan_scale(k + len(dests), dep.n_blocks, k, model=model)
            node_map = {i: nd for i, nd in enumerate(srcs + list(dests))}
            # a still-loading source releases blocks one restore chunk
            # at a time: the multicast step pace can never outrun the
            # bottleneck loading stage feeding it
            sc = ActiveScale(model, plan, node_map, t0,
                             max(self.link.step_time(dep.block_nbytes),
                                 src_chunk_dt),
                             role=role)
            self.scales[model] = sc
            first_serve += [sc.time_at(r) for r in plan.pipeline_ready
                            if r >= 0]
            dest_done = [plan.node_complete[i]
                         for i in range(k, k + len(dests))]
            first_serve.append(sc.time_at(min(dest_done)))
            t_complete = max(sc.time_at(plan.total_steps), t_local)
        return ScaleReport(model, tier, tuple(srcs), tuple(dests), k,
                           t_req, t0,
                           min(first_serve) if first_serve else t0,
                           t_complete, fetch_seconds=fetch_s,
                           compile_seconds=compile_s)

    def _charge_compile(self, model: str) -> float:
        """Simulated-clock cost of building this geometry's executables
        on a fresh cold replica.  0 when the profile does not model
        compilation (``hw.jit_compile_s == 0``).
        Within one cluster, multicast destinations inherit the source's
        built kernels (one process), so only the cold source ever pays.
        The JAX package also lets a persistent compile cache waive the
        charge; that cache is not ported (the constructor refuses one)."""
        if self.hw.jit_compile_s <= 0:
            return 0.0
        return self.hw.jit_compile_s

    def _restore_from_snapshot(self, model: str, node_id: int,
                               shard: ModelShard) -> None:
        """Materialize a GPU-tier replica from a local block-granular
        SSD snapshot (caller prices the chunked restore on the clock)."""
        dep = self.models[model]
        mm = self.nodes[node_id]
        mm.admit(model, dep.n_blocks, self.clock)
        for b, buf in sorted(shard.buffers.items()):
            mm.receive(model, b, buf, self._unpack(dep, b, buf))

    def _host_payload_nodes(self, model: str) -> List[int]:
        """Nodes whose host cache holds the model's FULL packed payload —
        the only host-tier warmth the live cluster can actually serve
        from (a payload-less LRU entry is simulator-style metadata)."""
        dep = self.models[model]
        return [n.node_id for n in self.nodes
                if (s := n.host_cache.get(model)) is not None
                and len(s.buffers) == dep.n_blocks]

    def _acquire_source(self, model: str) -> Tuple[int, str]:
        """§5 locality-driven source acquisition for a model with no
        GPU-resident replica; materializes the replica (clock pricing is
        the caller's job — tiers differ only in bandwidth).  Payload-less
        host-cache entries are treated as cold: promotion would yield a
        shard that can never become ``complete``, so those nodes take a
        real fetch path (remote host copy or SSD) instead."""
        dep = self.models[model]
        payload_nodes = self._host_payload_nodes(model)
        warm = [nd for nd in self.state.warm_nodes(model)
                if nd in payload_nodes]
        if warm:
            nd = warm[0]
            shard = self.nodes[nd].promote(model, self.clock)
            assert shard is not None and shard.buffers
            for b, buf in list(shard.buffers.items()):
                shard.flat.update(self._unpack(dep, b, buf))
            shard.n_blocks = dep.n_blocks
            return nd, "host"
        free = self.state.free_nodes()
        if not free:
            raise RuntimeError(f"{model}: no free node for a source")
        # one-sided read of a remote node's host copy beats SSD (§5) —
        # but only a payload-carrying copy counts
        if payload_nodes:
            nd = free[0]
            self._load_full(model, nd)
            return nd, "remote"
        # local SSD snapshot (scale-to-zero park) restores through the
        # chunked pipeline; same tier pricing as the NVMe-backed
        # registry, but the blocks come from the snapshot itself
        for nd in self.state.ssd_nodes(model):
            shard = self.nodes[nd].promote_from_ssd(model)
            if shard is not None:
                self._restore_from_snapshot(model, nd, shard)
                return nd, "ssd"
        nd = free[0]
        self._load_full(model, nd)
        return nd, "ssd"

    def scale_down(self, model: str, nodes: Sequence[int],
                   park: str = "host") -> None:
        """Release GPU replicas; the model falls back to the host-memory
        tier (§5) where a later ``scale`` finds it warm — or, with
        ``park="ssd"``, straight through to a block-granular SSD
        snapshot (scale-to-zero: the host LRU slot is freed too, and a
        later cold start streams the snapshot back up the loading
        pipeline).  In-flight sequences drain and hand off to a
        surviving local replica (or park in its resume queue)."""
        sc = self.scales.get(model)
        if sc is not None:
            busy = set(sc.node_map.values()) & set(nodes)
            assert not busy, \
                f"{model}: nodes {sorted(busy)} are part of the in-flight " \
                f"scale plan — run it to completion before scaling down"
        sv = self.serving[model]
        for nd in nodes:
            eng = sv.locals_.pop(nd, None)
            if eng is None:
                eng = sv.prefills.pop(nd, None)
            if eng is not None:
                eng.drain()
                # finished generations must survive the replica
                # (scale-to-zero tears down the last engine; ``results``
                # still owes the tokens to the bit-equality bar)
                arch = self._retired_results.setdefault(model, {})
                arch.update({rid: s.generated
                             for rid, s in eng.sched.finished.items()})
                pairs = eng.handoff()
                target = self._adoption_target(model, exclude=nd)
                if pairs:
                    assert target is not None, \
                        f"{model}: scale_down of the last replica with " \
                        f"in-flight requests"
                    self._adopt_pairs(model, target,
                                      self._price_handoff(model, pairs))
            self.state.release(nd, self.clock, model)
            if park == "ssd":
                self.nodes[nd].demote_to_ssd(model, self.clock)

    # ------------------------------------------------------------- control
    def _advance_one(self, model: str) -> None:
        """Advance ``model``'s active multicast one schedule step:
        physically copy block buffers, spawn execution pipelines as they
        become ready, mode-switch nodes as they complete (drain →
        handoff → local DECODE resume)."""
        sc = self.scales[model]
        dep = self.models[model]
        for src, dst, blk in sc.plan.schedule.steps[sc.steps_done]:
            rs, rd = sc.node_map[src], sc.node_map[dst]
            assert self.nodes[rs].has_block(model, blk), (src, blk)
            buf = self.nodes[rs].gpu_shard(model).buffers[blk]
            self.nodes[rd].receive(model, blk, buf,
                                   self._unpack(dep, blk, buf))
        sc.steps_done += 1
        self.clock = max(self.clock, sc.now)
        self._on_scale_progress(sc)
        if sc.done:
            self._finish_scale(sc)
            del self.scales[model]

    def step(self) -> bool:
        """Advance every active multicast one schedule step; returns
        False when none advanced."""
        advanced = False
        for model in list(self.scales):
            if not self.scales[model].done:
                self._advance_one(model)
                advanced = True
        return advanced

    def step_due(self, now: float) -> bool:
        """Event-driven variant for trace replay: advance each active
        multicast only through the schedule steps whose simulated time
        has arrived (step s of a scale completes at ``t0 + s·step_time``).
        Returns False when nothing was due."""
        advanced = False
        progressed = True
        while progressed:
            progressed = False
            for model in list(self.scales):
                sc = self.scales[model]
                if not sc.done and sc.time_at(sc.steps_done + 1) <= now:
                    self._advance_one(model)
                    advanced = progressed = True
        return advanced

    def run_to_completion(self) -> None:
        while self.step():
            pass

    def _on_scale_progress(self, sc: ActiveScale) -> None:
        model, sv, step = sc.model, self.serving[sc.model], sc.steps_done
        # 1. mode switch: destinations holding the full model become
        #    local replicas (scheduler-driven CB engines)
        for pi, done_step in sc.plan.node_complete.items():
            if pi >= sc.plan.k and pi not in sc.switched \
                    and 0 <= done_step <= step:
                sc.switched.add(pi)
                self._ensure_local(model, sc.node_map[pi],
                                   role=sc.role or "unified")
        # 2. spawn execution pipelines that became ready — unless every
        #    member already mode-switched (locals serve instead)
        from repro_torch.distributed.pipeline import PipelinedEngine
        for idx, rstep in enumerate(sc.plan.pipeline_ready):
            pipe = sc.plan.pipelines[idx]
            if idx in sc.spawned or not 0 <= rstep <= step:
                continue
            sc.spawned.add(idx)
            if all(p in sc.switched for p in pipe.nodes):
                continue
            eng = PipelinedEngine(
                self.models[model].cfg,
                self._pipeline_forward(model, pipe, sc.node_map),
                device=self.device,
                n_slots=self.n_slots, max_len=self.max_len,
                max_prefill_per_tick=self.max_prefill_per_tick,
                policy=self.admission)
            sv.pipes.append(PipeInstance(pipe, list(pipe.nodes),
                                         [sc.node_map[n]
                                          for n in pipe.nodes], eng))
        # 3. pipelines whose every member mode-switched drain and hand
        #    their in-flight requests to a member's local replica (§4.4)
        for pinst in sv.live_pipes():
            if all(p in sc.switched for p in pinst.plan_nodes):
                self._drain_pipe(model, pinst)

    def _finish_scale(self, sc: ActiveScale) -> None:
        for pinst in self.serving[sc.model].live_pipes():
            self._drain_pipe(sc.model, pinst)

    def _adoption_target(self, model: str, exclude: Optional[int] = None,
                         members: Sequence[int] = (),
                         near: Sequence[int] = ()
                         ) -> Optional[ContinuousBatchingEngine]:
        """Arbiter-ranked adoption target (locality: a replica on a
        member node of the draining instance keeps the packed KV off the
        link, a ready replica costs one hop, a still-fetching replica is
        the last resort).  ``near`` biases within a tier toward replicas
        close to the exporting prefill node (the disagg wire path)."""
        return self.arbiter.handoff_target(
            self.serving[model].locals_, members=members, exclude=exclude,
            near=near,
            ready=lambda nd: self._ready_at.get((model, nd), 0.0)
            <= self.clock)

    def _adopt_pairs(self, model: str, target: ContinuousBatchingEngine,
                     pairs: Sequence[Tuple]) -> None:
        """Hand priced (seq, payload) pairs to the adopting engine.  A
        decode-role target only takes sequences already past prefill;
        never-prefilled ones return to the pending queue and re-route
        through the prefill pool (their original ``t_arrive`` rides
        along, so TTFT still reports the full wait)."""
        if target.role == "decode":
            fresh = [s for s, _ in pairs if not s.generated]
            pairs = [(s, p) for s, p in pairs if s.generated]
            sv = self.serving[model]
            for seq in fresh:
                sv.pending.append((seq.req_id, list(seq.prompt),
                                   seq.max_new_tokens, seq.t_arrive,
                                   seq.slo))
        if pairs:
            target.adopt(pairs)

    def _drain_pipe(self, model: str, pinst: PipeInstance) -> None:
        pinst.drained = True
        pinst.engine.drain()
        pairs = pinst.engine.handoff()
        if not pairs:
            return
        target = self._adoption_target(model, members=pinst.members)
        assert target is not None, "mode switch with no local replica"
        self._adopt_pairs(model, target, self._price_handoff(model, pairs))

    @staticmethod
    def _handoff_groups(pairs: Sequence[Tuple]) -> List[List[int]]:
        """Partition pair indices into wire-sharing groups: payloads of
        the same dedupe batch whose page runs overlap are connected (a
        sharer's payload is useless without the carrier holding its
        referenced pages), everything else is a singleton — union-find
        over (batch, source page id)."""
        parent = list(range(len(pairs)))

        def find(i: int) -> int:
            while parent[i] != i:
                parent[i] = parent[parent[i]]
                i = parent[i]
            return i

        owner: Dict[Tuple[int, int], int] = {}
        for i, (_, payload) in enumerate(pairs):
            if isinstance(payload, PackedKV) and payload.batch is not None \
                    and payload.page_ids:
                for pid in payload.page_ids:
                    key = (payload.batch, pid)
                    if key in owner:
                        parent[find(i)] = find(owner[key])
                    else:
                        owner[key] = i
        groups: Dict[int, List[int]] = {}
        for i in range(len(pairs)):
            groups.setdefault(find(i), []).append(i)
        return list(groups.values())

    def _price_handoff(self, model: str, pairs: Sequence[Tuple]
                       ) -> List[Tuple]:
        """Recompute-vs-transfer decision at a handoff (§4.4).

        A payload-carrying pair prices the packed wire bytes over the
        inter-node link against re-prefilling the tokens on the adopting
        replica, takes the cheaper path (dropping the payload when
        recomputation wins — the engine rebuilds it at restore time),
        and charges the simulated clock; payload-less pairs (λPipe
        sources) can only recompute.  ``PackedKV`` payloads that DO ship
        round-trip through their contiguous wire buffer, so the byte
        movement the log prices is the byte movement that happens.

        Wire-deduped payloads (prefix sharing) are priced as a GROUP:
        payloads sharing pages either all ship — total cost the deduped
        bytes, each shared page crossing the link once — or all
        recompute; a sharer shipped without its carrier would be
        unresolvable at adoption.  Singletons price exactly as before."""
        cfg = self.models[model].cfg
        rows: List[Tuple] = [None] * len(pairs)
        for group in self._handoff_groups(pairs):
            priced = []
            for i in group:
                seq, payload = pairs[i]
                n_tok = max(seq.pos - 1, 0) if seq.generated else 0
                pbytes = payload_nbytes(payload)
                t_rec = recompute_cost(cfg, n_tok, 1, self.hw.peak_flops) \
                    if seq.generated else 0.0
                priced.append((i, seq, payload, n_tok, pbytes, t_rec))
            shippable = [r for r in priced if r[2] is not None]
            ship = bool(shippable) and \
                sum(r[4] for r in shippable) / self.hw.link_bw \
                <= sum(r[5] for r in shippable)
            for i, seq, payload, n_tok, pbytes, t_rec in priced:
                if payload is None:
                    chosen = "recompute" if seq.generated else "fresh"
                    t_xfer = float("inf") if seq.generated else 0.0
                else:
                    t_xfer = pbytes / self.hw.link_bw
                    if ship:
                        chosen = "transfer"
                        if isinstance(payload, PackedKV):
                            payload = payload.from_wire(*payload.wire())
                    else:
                        chosen, payload = "recompute", None
                rows[i] = (seq, payload, HandoffDecision(
                    model, seq.req_id, n_tok, pbytes, t_xfer, t_rec,
                    chosen))
        out: List[Tuple] = []
        total = 0.0
        for seq, payload, dec in rows:
            self.handoff_log.append(dec)
            total += dec.t_chosen
            out.append((seq, payload))
        self.clock += total
        return out

    # ------------------------------------------------------------- serving
    def submit(self, model: str, prompt: Sequence[int],
               max_new_tokens: int, *,
               req_id: Optional[int] = None,
               t_arrive: Optional[float] = None,
               slo: Optional[SLOClass] = None,
               probe: bool = False) -> int:
        """Admit a request for ``model`` into a scheduler-driven serving
        instance (ready pipelines preferred over local replicas during a
        scale-out — offload spikes to the scaling nodes); queued until
        capacity exists when the model has no instance yet.
        ``t_arrive`` (simulated-clock arrival) and the ``slo`` class ride
        on the sequence for the control plane and survive handoffs.

        ``probe`` marks health-check traffic: served normally when a
        replica exists, but answered at the control plane (a counter,
        no engine) when none does — a probe must NEVER wake a
        scaled-to-zero model or queue as demand, and the liveness/
        activity split keeps engine-served probes from resetting
        keep-alive (zepfu SCALE_TO_ZERO pattern)."""
        if req_id is None:
            req_id = self._next_id
        self._next_id = max(self._next_id, req_id) + 1
        inst = self._route(model)
        if inst is None:
            if probe:
                # liveness answered from cluster metadata — the model
                # stays parked, no demand signal is generated
                self.probe_answers[model] = \
                    self.probe_answers.get(model, 0) + 1
                return req_id
            self.serving[model].pending.append(
                (req_id, list(prompt), max_new_tokens, t_arrive, slo))
        else:
            inst.submit(prompt, max_new_tokens, req_id=req_id,
                        t_arrive=t_arrive, slo=slo, probe=probe)
            self._harvest_shed(model, inst)
        return req_id

    def _harvest_shed(self, model: str, inst) -> None:
        """Drain an instance's shed log into the audit trail and the
        replay-visible event outbox (λPipe engines never shed — their
        scheduler carries no shed_limit — so the drain is a no-op)."""
        take = getattr(inst, "take_shed", None)
        if take is None:
            return
        for rid, cls, retry in take():
            self.audit_log.append(AuditEvent(
                self.clock, "shed", model, rid, detail=cls,
                retry_after=retry))
            self._shed_events.append((model, rid, retry))

    def take_shed_events(self) -> List[Tuple[str, int, float]]:
        """Drain (model, req_id, retry_after) shed events since the last
        drain — the replay loop's feed into ``MetricsLog.on_shed``."""
        out, self._shed_events = self._shed_events, []
        return out

    def take_preempt_events(self) -> List[Tuple[str, int, int]]:
        """Drain (model, req_id, pages_reclaimed) preemption events —
        the replay loop's feed into ``MetricsLog.on_preempt``."""
        out, self._preempt_events = self._preempt_events, []
        return out

    def take_coldstart_events(self) -> List[Tuple[float, str, str,
                                                  float, float, float]]:
        """Drain (t_request, model, tier, fetch_s, compile_s, t_ready)
        cold-scale events — the replay loop's feed into
        ``MetricsLog.on_cold_start``."""
        out, self._coldstart_events = self._coldstart_events, []
        return out

    def _route(self, model: str):
        """Pick the serving instance for a new request: least-loaded
        instance with a free slot, pipelines first (paper: offload spikes
        to the scaling nodes).  While a scale-out is in flight, overflow
        stays pending — new pipelines and replicas are about to appear —
        otherwise it queues on the least-loaded existing instance.

        Disaggregated path: when the model has a prefill pool AND a
        decode-capable replica to stream into, prompts land on the
        least-loaded prefill engine (the tick-time export pump moves
        them to the decode pool after their prompt pass).  With the
        decode pool gone the prefill pool is skipped — exports would
        strand — and conversely, a decode-only deployment relaxes its
        least-loaded engine to unified rather than strand prompts."""
        sv = self.serving[model]
        if sv.prefills and sv.locals_:
            pres = [(eng.sched.in_flight + eng.sched.pending, nd, eng)
                    for nd, eng in sv.prefills.items()
                    if self._ready_at.get((model, nd), 0.0) <= self.clock]
            room = [c for c in pres if c[0] < self.n_slots]
            if room:
                return min(room)[2]
            if model in self.scales:
                return None
            if pres:
                return min(pres)[2]
        pipes = [(p.engine.sched.in_flight + p.engine.sched.pending, i, p)
                 for i, p in enumerate(sv.live_pipes())]
        room = [c for c in pipes if c[0] < self.n_slots]
        if room:
            return min(room)[2].engine
        locs = [(eng.sched.in_flight + eng.sched.pending, nd, eng)
                for nd, eng in sv.locals_.items()
                if eng.role != "decode"
                and self._ready_at.get((model, nd), 0.0) <= self.clock]
        room = [c for c in locs if c[0] < self.n_slots]
        if room:
            return min(room)[2]
        if model in self.scales:
            return None
        if locs:
            return min(locs)[2]
        # every local is still inside its priced fetch window (no scale
        # plan to wait on): queue on the least-loaded one anyway rather
        # than strand the request
        locs_all = [(eng.sched.in_flight + eng.sched.pending, nd, eng)
                    for nd, eng in sv.locals_.items()
                    if eng.role != "decode"]
        if locs_all:
            return min(locs_all)[2]
        if pipes:
            return min(pipes)[2].engine
        # only decode-role engines remain and no prefill pool feeds them
        # (the disagg path above would have taken the request): relax the
        # least-loaded one to unified so prompts aren't stranded
        decs = [(eng.sched.in_flight + eng.sched.pending, nd, eng)
                for nd, eng in sv.locals_.items() if eng.role == "decode"]
        if decs and not sv.prefills:
            eng = min(decs)[2]
            eng.set_role("unified")
            return eng
        return None

    def tick(self) -> bool:
        """Run one scheduler tick on every serving instance of every
        model (and flush requests that were waiting for capacity).
        Returns False when every instance was idle."""
        did = False
        for model, sv in self.serving.items():
            if sv.pending:
                left = []
                for rid, prompt, n, t_arr, slo in sv.pending:
                    inst = self._route(model)
                    if inst is None:
                        left.append((rid, prompt, n, t_arr, slo))
                    else:
                        inst.submit(prompt, n, req_id=rid, t_arrive=t_arr,
                                    slo=slo)
                        self._harvest_shed(model, inst)
                did = did or len(left) < len(sv.pending)
                sv.pending = left
            for pinst in sv.live_pipes():
                did = pinst.engine.step() or did
            for eng in sv.prefills.values():
                did = eng.step() or did
            # export pump (disagg wire): stream finished prompt passes
            # to the decode pool.  The adoption target is found BEFORE
            # exporting — export frees the prefill slots, so with no
            # target the sequences stay parked in their slots instead
            # of being lost
            for nd, eng in list(sv.prefills.items()):
                if not eng.sched.prefilled_slots():
                    continue
                target = self._adoption_target(model, near=(nd,))
                if target is None:
                    continue
                pairs = eng.export_prefilled()
                if pairs:
                    self._adopt_pairs(model, target,
                                      self._price_handoff(model, pairs))
                    did = True
            for nd, eng in sv.locals_.items():
                did = eng.step() or did
                # harvest preemption victims before the engine's next
                # step would self-re-adopt them: packed KV parks to the
                # node's host tier (ModelManager), the GPU pool stops
                # paying for the sequence entirely
                for seq, payload, pages in eng.take_preempted():
                    self.nodes[nd].park_seq(
                        model, seq.req_id,
                        (seq, payload, self._tick_no, nd))
                    self._preempt_events.append((model, seq.req_id, pages))
                    self.audit_log.append(AuditEvent(
                        self.clock, "preempt", model, seq.req_id,
                        detail=f"node {nd}: {pages} pages reclaimed"))
                    self.audit_log.append(AuditEvent(
                        self.clock, "park", model, seq.req_id,
                        detail=f"host tier node {nd}"))
            did = self._reenter_parked(model, sv) or did
            did = self._age_resume_parks(model, sv) or did
        self._tick_no += 1
        return did

    def _resume_target(self, model: str, sv: ModelServing, seq, *,
                       relaxed: bool, near: Sequence[int] = ()
                       ) -> Optional[ContinuousBatchingEngine]:
        """Decode-capable engine a preempted/parked sequence may resume
        on: a free slot, pages for its worst-case footprint, and —
        unless ``relaxed`` (the park-timeout path) — an empty fresh
        queue, so a resumed victim never races the queued higher-class
        work its preemption freed capacity for (re-preemption thrash).
        Arbiter-ranked (locality to ``near``, then load) among the
        eligible; None when nothing qualifies."""
        cands: Dict[int, ContinuousBatchingEngine] = {}
        for nd, eng in sv.locals_.items():
            if self._ready_at.get((model, nd), 0.0) > self.clock:
                continue
            sched = eng.sched
            if sched.in_flight >= eng.n_slots:
                continue
            if not relaxed and sched.queue:
                continue
            if sched.pages is not None and not sched.pages.can_admit(
                    sched.admit_tokens(seq), prompt=seq.prompt):
                continue
            cands[nd] = eng
        if not cands:
            return None
        return self.arbiter.handoff_target(cands, near=near)

    def _reenter_parked(self, model: str, sv: ModelServing) -> bool:
        """Re-enter host-tier parked sequences, oldest first per node.
        Each goes back through the priced §4.4 handoff (ship the packed
        pages or recompute from tokens) into an arbiter-ranked replica.
        A park older than ``max_park_ticks`` relaxes the anti-thrash
        gate to ANY admitting replica — and is shed, with an audit
        entry, when none exists even then."""
        did = False
        for mm in self.nodes:
            pen = mm.parked.get(model)
            if not pen:
                continue
            for rid, (seq, payload, t_park, src) in list(pen.items()):
                age = self._tick_no - t_park
                timed_out = self.max_park_ticks is not None \
                    and age >= self.max_park_ticks
                target = self._resume_target(model, sv, seq,
                                             relaxed=timed_out, near=(src,))
                if target is not None:
                    mm.pop_parked(model, rid)
                    self._adopt_pairs(model, target, self._price_handoff(
                        model, [(seq, payload)]))
                    self.audit_log.append(AuditEvent(
                        self.clock, "resume", model, rid,
                        detail=f"parked {age} ticks on node {mm.node_id}"))
                    did = True
                elif timed_out:
                    mm.pop_parked(model, rid)
                    self.audit_log.append(AuditEvent(
                        self.clock, "park_timeout", model, rid,
                        detail=f"no admitting replica after {age} parked "
                               f"ticks; shed"))
                    self._shed_events.append((model, rid, 0.0))
                    did = True
        return did

    def _age_resume_parks(self, model: str, sv: ModelServing) -> bool:
        """Bound how long a handed-off sequence may sit in one engine's
        resume queue waiting for pages: past ``max_park_ticks`` it is
        evicted and re-routed through the arbiter to a replica that can
        admit it NOW — or shed, with an audit entry, when none can.  A
        wedged engine that could itself admit the sequence next tick is
        left alone (the scheduler resumes it without a wire hop)."""
        if self.max_park_ticks is None:
            return False
        did = False
        live: Set[Tuple[str, int, int]] = set()
        for nd, eng in list(sv.locals_.items()):
            for seq in list(eng.sched.resume_queue):
                key = (model, nd, seq.req_id)
                live.add(key)
                first = self._park_age.setdefault(key, self._tick_no)
                age = self._tick_no - first
                if age < self.max_park_ticks:
                    continue
                target = self._resume_target(model, sv, seq, relaxed=True)
                if target is eng:
                    continue
                seq2, payload = eng.evict_parked(seq.req_id)
                self._park_age.pop(key, None)
                live.discard(key)
                if target is not None:
                    self._adopt_pairs(model, target, self._price_handoff(
                        model, [(seq2, payload)]))
                    self.audit_log.append(AuditEvent(
                        self.clock, "resume", model, seq.req_id,
                        detail=f"rerouted off node {nd} after {age} "
                               f"resume-parked ticks"))
                else:
                    self.audit_log.append(AuditEvent(
                        self.clock, "park_timeout", model, seq.req_id,
                        detail=f"no admitting replica; shed off node {nd}"))
                    self._shed_events.append((model, seq.req_id, 0.0))
                did = True
        for key in [k for k in self._park_age
                    if k[0] == model and k not in live]:
            del self._park_age[key]
        return did

    def drain_serving(self) -> None:
        """Tick until every instance of every model is idle.  Raises if
        requests are stuck pending for a model that never gained a
        serving instance (registered without placement and never
        scaled) — they would otherwise be dropped silently."""
        while self.tick():
            pass
        stuck = {m: len(sv.pending)
                 for m, sv in self.serving.items() if sv.pending}
        if stuck:
            raise RuntimeError(
                f"requests pending with no serving instance: {stuck} "
                f"(scale the model or register it with hot_nodes)")
        stranded = {m: n for m, sv in self.serving.items()
                    if (n := sum(len(e.sched.prefilled_slots())
                                 for e in sv.prefills.values()))
                    and not sv.locals_}
        if stranded:
            raise RuntimeError(
                f"prefilled sequences stranded with no decode pool: "
                f"{stranded} (scale a decode or unified replica)")

    # --------------------------------------------------------- trace replay
    def _schedulers(self, model: str):
        sv = self.serving[model]
        for eng in sv.locals_.values():
            yield eng.sched
        for eng in sv.prefills.values():
            yield eng.sched
        for pinst in sv.pipes:
            yield pinst.engine.sched

    @staticmethod
    def _pool_pages(engines) -> Tuple[int, int]:
        """Summed page-pool occupancy across engines (0,0 when unpaged)."""
        total = live = 0
        for eng in engines:
            st = eng.stats()
            total += st.get("pages_total", 0)
            live += st.get("pages_live", 0)
        return total, live

    def _load_signals(self, now: float,
                      last_busy: Dict[Tuple[str, int], float],
                      recent_ttft: Dict[str, List[float]],
                      log: Optional[MetricsLog] = None,
                      arrivals: Optional[Dict[str, int]] = None,
                      recent_itl: Optional[Dict[str, List[float]]] = None,
                      sheds: Optional[Dict[str, int]] = None
                      ) -> List[LoadSignals]:
        """Per-model load as the autoscaler vocabulary (queue depth, slot
        utilization, committed nodes, idle replicas, SLO pressure from
        the metrics log, arrivals since the last decision).

        A disaggregated model emits TWO signals so its pools size
        independently: the prefill signal carries the arrival queue,
        TTFT samples and prompt-page occupancy; the decode signal
        carries decode slot utilization, inter-token latencies and
        generation-page occupancy.  A unified model emits the single
        aggregate signal it always did (role=None, byte-identical)."""
        signals = []
        for model, sv in self.serving.items():
            sc = self.scales.get(model)

            def pool_counts(pool: Dict[int, ContinuousBatchingEngine],
                            with_pipes: bool) -> Tuple[int, int, int, list]:
                queued = slots_total = slots_busy = 0
                if with_pipes:
                    for pinst in sv.live_pipes():
                        queued += pinst.engine.sched.pending
                        slots_total += pinst.engine.n_slots
                        slots_busy += pinst.engine.sched.in_flight
                for nd, eng in pool.items():
                    queued += eng.sched.pending
                    slots_total += eng.n_slots
                    slots_busy += eng.sched.in_flight
                    # a replica's keep-alive window starts when it is
                    # first observed (fresh replicas are not instantly
                    # "idle").  Liveness/activity split: probe-only work
                    # keeps the replica LIVE but not ACTIVE — health
                    # checks must not reset keep-alive, or a model with
                    # a prober can never scale to zero
                    if eng.sched.has_active:
                        last_busy[(model, nd)] = now
                    else:
                        last_busy.setdefault((model, nd), now)
                idle = [(nd, now - last_busy[(model, nd)]) for nd in pool]
                return queued, slots_total, slots_busy, idle

            if sv.prefills:
                # prefill pool: owns arrivals (pending), TTFT pressure,
                # prompt pages
                q, st, sb, idle = pool_counts(sv.prefills, False)
                busy = set(sv.prefills)
                if sc is not None and sc.role == "prefill":
                    busy |= set(sc.node_map.values())
                pt, pl = self._pool_pages(sv.prefills.values())
                signals.append(LoadSignals(
                    model, len(sv.pending) + q, st, sb, len(busy),
                    self.n_slots, scaling_in_flight=sc is not None,
                    n_replicas=len(sv.prefills),
                    recent_ttft=tuple(recent_ttft.get(model, ())),
                    idle_nodes=idle,
                    slo_pressure=log.slo_pressure(model, now)
                    if log else 0.0,
                    recent_arrivals=(arrivals or {}).get(model, 0),
                    recent_sheds=(sheds or {}).get(model, 0),
                    role="prefill", pages_total=pt, pages_live=pl,
                    model_nbytes=self.models[model].nbytes,
                    model_blocks=self.models[model].n_blocks))
                # decode pool: owns slot utilization, inter-token
                # latency, generation pages
                q, st, sb, idle = pool_counts(sv.locals_, True)
                busy = set(sv.locals_)
                if sc is not None and sc.role == "decode":
                    busy |= set(sc.node_map.values())
                pt, pl = self._pool_pages(sv.locals_.values())
                signals.append(LoadSignals(
                    model, q, st, sb, len(busy), self.n_slots,
                    scaling_in_flight=sc is not None,
                    n_replicas=len(sv.locals_),
                    idle_nodes=idle,
                    role="decode", pages_total=pt, pages_live=pl,
                    recent_itl=tuple((recent_itl or {}).get(model, ())),
                    model_nbytes=self.models[model].nbytes,
                    model_blocks=self.models[model].n_blocks))
                (recent_itl or {}).pop(model, None)
            else:
                q, st, sb, idle = pool_counts(sv.locals_, True)
                busy = set(sv.locals_)
                if sc is not None:
                    busy |= set(sc.node_map.values())
                signals.append(LoadSignals(
                    model, len(sv.pending) + q, st, sb, len(busy),
                    self.n_slots, scaling_in_flight=sc is not None,
                    n_replicas=len(sv.locals_),
                    recent_ttft=tuple(recent_ttft.get(model, ())),
                    idle_nodes=idle,
                    slo_pressure=log.slo_pressure(model, now)
                    if log else 0.0,
                    recent_arrivals=(arrivals or {}).get(model, 0),
                    recent_sheds=(sheds or {}).get(model, 0),
                    model_nbytes=self.models[model].nbytes,
                    model_blocks=self.models[model].n_blocks))
            recent_ttft[model] = []
        return signals

    def _apply_actions(self, actions: Sequence, now: float,
                       log: MetricsLog,
                       last_busy: Dict[Tuple[str, int], float],
                       pressure: Optional[Dict[str, float]] = None) -> None:
        press = pressure or {}
        # scale-downs first: they release GPUs back into the free pool
        # the scale-ups below are about to divide
        for act in actions:
            if isinstance(act, ScaleDown):
                sv = self.serving[act.model]
                pool = sv.prefills if act.role == "prefill" else sv.locals_
                # only idle standalone replicas release (their scheduler
                # is empty, so no drain/handoff is needed)
                nodes = [nd for nd in act.nodes
                         if nd in pool and pool[nd].sched.done]
                if nodes and act.model not in self.scales:
                    park = getattr(act, "park", "host")
                    self.scale_down(act.model, nodes, park=park)
                    for nd in nodes:
                        # a later re-scale-up of this node must start a
                        # fresh keep-alive window, not inherit this one
                        last_busy.pop((act.model, nd), None)
                    log.on_scale(now, "down", act.model,
                                 f"{act.reason}: -{len(nodes)} nodes "
                                 f"→ {park} tier")
        # several models asking for nodes in the same decision round
        # contend for the free pool: the arbiter divides it weighted by
        # per-model SLO pressure (uncontended asks are granted in full).
        # A cold model's scale() consumes one extra free node for its
        # source, so its ask includes it; execution runs highest
        # pressure first so a low-pressure model's source acquisition
        # can never eat nodes granted to a more urgent one.
        ups: Dict[str, ScaleUp] = {}
        for a in actions:
            if isinstance(a, ScaleUp) and a.model not in self.scales \
                    and a.model not in ups:
                # one multicast per model at a time: when both disagg
                # pools ask in the same round, first signal wins (the
                # other re-asks next round)
                ups[a.model] = a
        asked = {m: a.n_new + (0 if self.state.gpu_nodes(m) else 1)
                 for m, a in ups.items()}
        grants = self.arbiter.arbitrate(asked,
                                        len(self.state.free_nodes()), press)
        for m in self.arbiter.up_order(list(ups), press):
            act = ups[m]
            # no free node means nothing to add AND no node to acquire
            # a source on — skip entirely (logging a +0 event would
            # inflate the scale_ups metric)
            if not self.state.free_nodes():
                continue
            cold = not self.state.gpu_nodes(m)
            n_new = grants.get(m, act.n_new) - (1 if cold else 0)
            if n_new < 0 or (n_new == 0 and not cold):
                continue     # arbitrated away; capacity exists elsewhere
            rep = self.scale(m, n_new, k=act.k, role=act.role)
            log.on_scale(now, "up", m,
                         f"{act.reason}: +{len(rep.dests)} nodes "
                         f"k={rep.k} tier={rep.source_tier}"
                         + (f" role={act.role}" if act.role else ""))

    def _observe(self, now: float, log: MetricsLog,
                 recent_ttft: Dict[str, List[float]],
                 seen_first: set, seen_done: set,
                 harvested: Dict[object, int],
                 recent_itl: Optional[Dict[str, List[float]]] = None,
                 seen_decode: Optional[set] = None) -> None:
        """Harvest first-token / completion events at tick granularity,
        plus the phase marks behind the per-request breakdown: slot
        entry (queue wait ends), first decode tick on a decode-capable
        instance (trails first token by the wire transfer on the disagg
        path), and per-request inter-token latency at finish.

        ``harvested`` counts per-scheduler finished entries already
        recorded: ``Scheduler.finished`` is append-only, so only the
        islice tail is new — the scan stays O(live + new) per tick
        instead of O(all finished ever)."""
        seen_decode = set() if seen_decode is None else seen_decode
        for model in self.serving:
            for sched in self._schedulers(model):
                prefill_role = getattr(sched, "role", "unified") == "prefill"
                live = [s for s in sched.slots if s is not None]
                live += sched.resume_queue
                for seq in live:
                    rid = seq.req_id
                    if rid not in log.requests:
                        continue
                    log.on_start(rid, now)
                    if seq.generated and rid not in seen_first:
                        seen_first.add(rid)
                        log.on_first_token(rid, now)
                        recent_ttft.setdefault(model, []).append(
                            now - log.requests[rid].t_arrive)
                    if seq.generated and not prefill_role \
                            and rid not in seen_decode:
                        seen_decode.add(rid)
                        log.on_first_decode(rid, now)
                start = harvested.get(sched, 0)
                if len(sched.finished) == start:
                    continue
                harvested[sched] = len(sched.finished)
                for rid, seq in itertools.islice(sched.finished.items(),
                                                 start, None):
                    if rid in seen_done or rid not in log.requests:
                        continue
                    if rid not in seen_first:
                        seen_first.add(rid)
                        log.on_first_token(rid, now)
                        recent_ttft.setdefault(model, []).append(
                            now - log.requests[rid].t_arrive)
                    if not prefill_role and rid not in seen_decode:
                        seen_decode.add(rid)
                        log.on_first_decode(rid, now)
                    seen_done.add(rid)
                    log.on_finish(rid, now, len(seq.generated))
                    m = log.requests[rid]
                    if m.itl is not None and recent_itl is not None:
                        recent_itl.setdefault(model, []).append(m.itl)

    def replay(self, trace: Sequence[Request], *, autoscaler: Autoscaler,
               tick_seconds: Optional[float] = None,
               autoscale_dt: Optional[float] = None,
               tail_seconds: float = 0.0,
               metrics: Optional[MetricsLog] = None,
               prompt_fn=None, max_ticks: int = 200_000) -> MetricsLog:
        """Closed-loop trace replay on the simulated clock (§7.5 shape).

        Replays a workload trace end to end with the ``Autoscaler`` in
        charge: arrivals are submitted at their trace times, the
        controller reads load signals every ``autoscale_dt`` simulated
        seconds and drives ``scale()`` (k-way multicast from the best
        tier) / ``scale_down()`` (release to the host-memory tier), and
        multicast schedule steps execute exactly when their simulated
        time arrives (``step_due``).  Each scheduler tick advances every
        live sequence one token; its clock cost defaults to the
        roofline per-token time of the busiest live model
        (``SimModel.tok_time`` — the same decode pricing the
        discrete-event simulator uses, so live and simulated TTFT are
        directly comparable), falling back to ``DEFAULT_TICK_SECONDS``
        on idle ticks.  Passing ``tick_seconds`` pins the old constant
        cost instead.

        Requests carry real token prompts (``prompt_fn(request)`` or a
        deterministic per-request draw) through the real engines; the
        returned ``MetricsLog`` holds per-request TTFT/E2E on the
        simulated clock plus the scale-event audit trail and GPU-seconds.

        ``tail_seconds`` keeps the control loop running that long after
        the last request finishes, so keep-alive scale-down (release to
        the host-memory tier) is observable within the replay.
        """
        log = metrics or MetricsLog()
        # roofline decode clock (None = default): per-model tok_time on
        # THIS cluster's hardware profile, evaluated per tick below
        tok_time = {m: SimModel.from_config(dep.cfg).tok_time(self.hw)
                    for m, dep in self.models.items()}
        base_dt = tick_seconds if tick_seconds is not None \
            else DEFAULT_TICK_SECONDS
        dt_ctrl = autoscale_dt if autoscale_dt is not None else 5 * base_dt

        def tick_cost() -> float:
            if tick_seconds is not None:
                return tick_seconds
            busy = [tok_time[m] for m, sv in self.serving.items()
                    if any(e.sched.in_flight
                           for e in sv.locals_.values())
                    or any(e.sched.in_flight
                           for e in sv.prefills.values())
                    or any(p.engine.sched.in_flight
                           for p in sv.live_pipes())]
            return max(busy) if busy else base_dt

        def charge_roles(cost: float) -> None:
            """Attribute this tick's cost to each busy instance's role
            pool — the per-role GPU-seconds the disagg benchmarks
            compare (total gpu_seconds stays node-commitment-based)."""
            for sv in self.serving.values():
                for eng in sv.prefills.values():
                    if eng.sched.in_flight:
                        log.gpu_seconds_by_role["prefill"] = \
                            log.gpu_seconds_by_role.get("prefill", 0.) + cost
                for eng in sv.locals_.values():
                    if eng.sched.in_flight:
                        log.gpu_seconds_by_role[eng.role] = \
                            log.gpu_seconds_by_role.get(eng.role, 0.) + cost
                for p in sv.live_pipes():
                    if p.engine.sched.in_flight:
                        log.gpu_seconds_by_role["unified"] = \
                            log.gpu_seconds_by_role.get("unified", 0.) + cost

        arrivals = sorted(trace, key=lambda r: r.t_arrive)
        for r in arrivals:
            assert r.model in self.models, f"unregistered model {r.model}"

        def default_prompt(req: Request):
            vocab = self.models[req.model].cfg.vocab_size
            rng = np.random.default_rng(10_000 + req.req_id)
            return list(map(int, rng.integers(0, vocab,
                                              size=max(1, req.prompt_len))))

        prompt_fn = prompt_fn or default_prompt
        seen_first: set = set()
        seen_done: set = set()
        seen_decode: set = set()
        harvested: Dict[object, int] = {}
        last_busy: Dict[Tuple[str, int], float] = {}
        recent_ttft: Dict[str, List[float]] = {}
        recent_itl: Dict[str, List[float]] = {}
        arr_count: Dict[str, int] = {}       # arrivals per control window
        shed_count: Dict[str, int] = {}      # sheds per control window
        idx = 0
        now = self.clock
        next_ctrl = now
        t_drained: Optional[float] = None
        for _ in range(max_ticks):
            while idx < len(arrivals) and arrivals[idx].t_arrive <= now:
                r = arrivals[idx]
                idx += 1
                prompt = prompt_fn(r)
                if r.probe:
                    # health checks never enter the metrics log (they
                    # are not demand — see the liveness/activity split),
                    # so replay convergence does not wait on them either
                    self.submit(r.model, prompt, r.out_tokens,
                                req_id=r.req_id, t_arrive=r.t_arrive,
                                probe=True)
                    continue
                log.on_arrival(r.req_id, r.model, r.t_arrive, len(prompt),
                               slo=r.slo)
                arr_count[r.model] = arr_count.get(r.model, 0) + 1
                self.submit(r.model, prompt, r.out_tokens, req_id=r.req_id,
                            t_arrive=r.t_arrive, slo=r.slo)
            if now >= next_ctrl:
                next_ctrl = now + dt_ctrl
                sigs = self._load_signals(now, last_busy, recent_ttft,
                                          log, arr_count, recent_itl,
                                          shed_count)
                arr_count = {}
                shed_count = {}
                self._apply_actions(autoscaler.decide(now, sigs), now, log,
                                    last_busy,
                                    {s.model: s.slo_pressure for s in sigs})
            self.step_due(now)
            self.tick()
            for model, rid, retry in self.take_shed_events():
                log.on_shed(rid, now, retry_after=retry)
                shed_count[model] = shed_count.get(model, 0) + 1
                if rid in log.requests:
                    seen_done.add(rid)      # shed is terminal: converge
            for model, rid, pages in self.take_preempt_events():
                log.on_preempt(now, model, rid, pages=pages)
            for (t_req, model, tier, fetch_s, compile_s,
                 t_ready) in self.take_coldstart_events():
                log.on_cold_start(t_req, model, tier, fetch_s, compile_s,
                                  t_ready,
                                  slo_budget=autoscaler.config.coldstart_slo)
            self._observe(now, log, recent_ttft, seen_first, seen_done,
                          harvested, recent_itl, seen_decode)
            if idx >= len(arrivals) and not self.scales \
                    and len(seen_done) >= len(log.requests):
                if t_drained is None:
                    t_drained = now
                if now >= t_drained + tail_seconds:
                    break
            else:
                t_drained = None
            cost = tick_cost()
            charge_roles(cost)
            now += cost
            self.clock = max(self.clock, now)
        else:
            raise RuntimeError(
                f"replay did not converge in {max_ticks} ticks "
                f"({len(seen_done)}/{len(log.requests)} finished)")
        self.state.finalize(now)
        log.gpu_seconds = self.state.gpu_seconds
        return log

    def results(self, model: str) -> Dict[int, List[int]]:
        """req_id → generated tokens, across every instance the request
        may have touched (pipelines, handoffs, locals)."""
        out: Dict[int, List[int]] = dict(
            self._retired_results.get(model, {}))
        sv = self.serving[model]
        for pinst in sv.pipes:
            out.update({rid: s.generated
                        for rid, s in pinst.engine.sched.finished.items()})
        for eng in sv.prefills.values():
            eng.flush()
            out.update({rid: s.generated
                        for rid, s in eng.sched.finished.items()})
        for eng in sv.locals_.values():
            eng.flush()
            out.update({rid: s.generated
                        for rid, s in eng.sched.finished.items()})
        return out

    # --------------------------------------------------------- diagnostics
    def complete_nodes(self, model: str) -> List[int]:
        return [mm.node_id for mm in self.nodes
                if (s := mm.gpu_shard(model)) is not None and s.complete]

    def ready_pipelines(self, model: str) -> List[ExecutionPipeline]:
        sc = self.scales.get(model)
        if sc is None:
            return []
        return sc.plan.ready_pipelines_at(sc.steps_done)

    def forward(self, model: str, tokens) -> Optional[dict]:
        """One-shot diagnostic forward through the best currently
        available option (NOT the serving path — requests go through
        ``submit``/``tick`` and the Scheduler): used by correctness tests
        to compare logits against the reference model at every step."""
        done = self.complete_nodes(model)
        sc = self.scales.get(model)
        if done and sc is None:
            nd = done[-1]
            return {"mode": "local", "node": nd,
                    "logits": self._forward_local(model, nd, tokens)}
        if sc is not None:
            for pipe in sc.plan.ready_pipelines_at(sc.steps_done):
                members = [sc.node_map[n] for n in pipe.nodes]
                if not any(nd in done for nd in members):
                    fwd = self._pipeline_forward(model, pipe, sc.node_map)
                    return {"mode": "pipeline", "nodes": members,
                            "logits": fwd(tokens)}
        if done:
            nd = done[0]
            return {"mode": "local", "node": nd,
                    "logits": self._forward_local(model, nd, tokens)}
        return None

    @torch.no_grad()
    def _forward_local(self, model: str, node_id: int,
                       tokens) -> torch.Tensor:
        dep = self.models[model]
        flat = self.nodes[node_id].gpu_shard(model).flat
        tokens = torch.as_tensor(tokens, device=self.device)
        B, S = tokens.shape
        positions = torch.arange(S, device=self.device).expand(B, S)
        x = embed_from_flat(dep.cfg, flat, tokens)
        x = apply_layer_range(dep.cfg, flat, x, 0, dep.cfg.n_layers,
                              positions)
        return head_from_flat(dep.cfg, flat, x)
