"""Discrete-event cluster simulator for serverless LLM scaling.

The paper's cluster-scale *timing* results (Figs 7–18) are reproduced
through this calibrated simulator, while the *correctness* of every
mechanism (multicast schedule, pipelined execution, mode switching) is
executed for real in PyTorch (see ``repro_torch.distributed`` and the
tests).  The simulator consumes the same ``ScalePlan`` objects produced
by ``repro_torch.core`` — the schedules it prices are exactly the
schedules the collectives execute.

Model: requests are served by *instances* (local replica or λPipe execution
pipeline) with ``slots`` concurrent requests each.  Decode is HBM-bandwidth
bound; prefill is FLOPs bound.  The closed loop is split the way the paper
splits it: the shared ``Autoscaler`` (``autoscaler.py``) decides WHEN and
HOW MUCH to scale from load signals, and a scaling policy
(``baselines.py``) decides the MECHANISM — how new instances are
provisioned and when they become ready.  For λScale, pipeline instances
are created early (execute-while-load) and *drain* at mode-switch time
while per-node local replicas take over.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.serving.autoscaler import (Autoscaler, AutoscalerConfig,
                                            LoadSignals, ScaleUp)
from repro_torch.serving.metrics import MetricsLog, percentile
from repro_torch.serving.placement import PlacementArbiter, slo_pressure_of
from repro_torch.serving.scheduler import (DEFAULT_SLOTS, HOP_LATENCY,
                                           PIPELINE_TOK_OVERHEAD,
                                           AdmissionPolicy, Pending,
                                           instance_slot_count)
from repro_torch.serving.tiers import ClusterState, HardwareProfile
from repro_torch.serving.workload import Request


# ------------------------------------------------------------- model costs
@dataclasses.dataclass(frozen=True)
class SimModel:
    name: str
    bytes: float                 # bf16 weight bytes
    active_bytes: float          # per-token touched bytes (MoE: active only)
    active_params: float

    @staticmethod
    def from_config(cfg: ModelConfig) -> "SimModel":
        return SimModel(cfg.arch_id, 2.0 * cfg.param_count(),
                        2.0 * cfg.active_param_count(),
                        float(cfg.active_param_count()))

    def tok_time(self, hw: HardwareProfile, batch: int = 1) -> float:
        """Per-decode-step time (whole batch): memory vs compute roofline."""
        mem = self.active_bytes / hw.hbm_bw
        comp = 2.0 * self.active_params * batch / hw.peak_flops
        return max(mem, comp)

    def prefill_time(self, hw: HardwareProfile, prompt_len: int) -> float:
        return 2.0 * self.active_params * prompt_len / hw.peak_flops


# --------------------------------------------------------------- instances
# Instance concurrency and pipelined-mode penalties are the scheduler's
# constants (repro_torch.serving.scheduler): the capacity the simulator prices
# is the slot pool the continuous-batching engine actually executes, and
# ``Instance.draining`` mirrors ``Scheduler.drain`` (no admissions; live
# slots run to completion or hand off).


@dataclasses.dataclass
class Instance:
    inst_id: int
    model: str
    nodes: Tuple[int, ...]
    kind: str                    # "local" | "pipeline"
    ready_time: float
    slots: List[float]           # per-slot busy-until
    owns_gpus: bool = True       # releases node GPUs on scale-in
    draining: bool = False       # no new requests (mode switch)
    last_active: float = 0.0

    def free_slot(self, now: float) -> Optional[int]:
        if self.draining:
            return None
        best, best_i = None, None
        for i, end in enumerate(self.slots):
            if end <= max(now, self.ready_time):
                if best is None or end < best:
                    best, best_i = end, i
        return best_i


# ----------------------------------------------------------------- results
@dataclasses.dataclass
class SimResult:
    ttft: List[Tuple[float, float]]          # (arrival, ttft)
    completions: List[Tuple[float, int]]     # (finish_time, tokens)
    gpu_seconds: float
    instance_events: List[Tuple[float, str, str]]
    n_requests: int
    metrics: MetricsLog = dataclasses.field(default_factory=MetricsLog)

    def ttft_percentile(self, q: float) -> float:
        return percentile([t for _, t in self.ttft], q)

    def mean_ttft(self) -> float:
        xs = [t for _, t in self.ttft]
        return sum(xs) / max(len(xs), 1)

    def throughput_timeline(self, dt: float = 0.1,
                            horizon: Optional[float] = None
                            ) -> List[Tuple[float, float]]:
        if not self.completions:
            return []
        horizon = horizon or max(t for t, _ in self.completions) + dt
        nb = int(horizon / dt) + 1
        buckets = [0.0] * nb
        for t, toks in self.completions:
            if t < horizon:
                buckets[int(t / dt)] += toks
        return [(i * dt, b / dt) for i, b in enumerate(buckets)]

    def time_to_throughput(self, frac: float, dt: float = 0.05) -> float:
        """Ramp-up metric: first time sustained throughput ≥ frac·peak."""
        tl = self.throughput_timeline(dt)
        if not tl:
            return float("nan")
        peak = max(v for _, v in tl)
        for t, v in tl:
            if v >= frac * peak:
                return t
        return float("nan")


# --------------------------------------------------------------- simulator
class Simulator:
    """Event-driven serving simulation under a scaling policy."""

    def __init__(self, policy, n_nodes: int, hw: HardwareProfile, *,
                 slots_per_instance: int = DEFAULT_SLOTS,
                 keepalive: float = 5.0,
                 autoscale_dt: float = 0.25, scale_headroom: int = 0,
                 model_configs: Optional[Dict[str, ModelConfig]] = None,
                 autoscaler: Optional[Autoscaler] = None,
                 admission: Optional[AdmissionPolicy] = None,
                 arbiter: Optional[PlacementArbiter] = None):
        self.policy = policy
        self.hw = hw
        self.cluster = ClusterState(n_nodes, hw)
        self.slots = slots_per_instance
        self.keepalive = keepalive
        self.autoscale_dt = autoscale_dt
        self.scale_headroom = scale_headroom
        self.model_configs = model_configs or {}
        # the shared closed-loop controller (same class drives the live
        # cluster's replay); the default config reproduces the reactive
        # sizing this simulator always used
        self.autoscaler = autoscaler or Autoscaler(AutoscalerConfig(
            headroom=scale_headroom, keepalive=keepalive))
        # the request control plane — the SAME AdmissionPolicy /
        # PlacementArbiter objects the live cluster consumes, so
        # policies A/B on identical traces across runtimes
        self.admission = admission or AdmissionPolicy()
        self.arbiter = arbiter or PlacementArbiter()
        self.policy.arbiter = self.arbiter   # dest picking routes through
        self._models: Dict[str, SimModel] = {}
        self._iid = itertools.count()

    def _model(self, name: str) -> SimModel:
        if name not in self._models:
            cfg = self.model_configs.get(name) or get_config(name)
            self._models[name] = SimModel.from_config(cfg)
        return self._models[name]

    # ------------------------------------------------------------------
    def run(self, requests: Sequence[Request], *, warm_nodes: int = 1,
            duration: Optional[float] = None) -> SimResult:
        hw = self.hw
        models = sorted({r.model for r in requests})
        # seed: ≥1 replica of each model in host memory somewhere (paper
        # footnote 2) — locality-driven startup picks it up.
        for mi, m in enumerate(models):
            for w in range(warm_nodes):
                node = (mi + w) % len(self.cluster.nodes)
                self.cluster.nodes[node].host_cache.touch(m, 0.0)

        instances: Dict[int, Instance] = {}
        active: Dict[int, int] = {}
        queues: Dict[str, List[Request]] = {m: [] for m in models}
        result = SimResult([], [], 0.0, [], len(requests))
        log = result.metrics
        for r in requests:
            log.on_arrival(r.req_id, r.model, r.t_arrive, r.prompt_len,
                           slo=r.slo)
        recent_ttft: Dict[str, List[float]] = {m: [] for m in models}
        arr_count: Dict[str, int] = {m: 0 for m in models}

        evq: List[tuple] = []
        seq = itertools.count()

        def push(t, kind, payload=None):
            heapq.heappush(evq, (t, next(seq), kind, payload))

        for r in requests:
            push(r.t_arrive, "arrival", r)
        horizon = duration or (max(r.t_arrive for r in requests) + 180.0)
        t = 0.0
        while t < horizon:
            push(t, "autoscale")
            t += self.autoscale_dt

        def dispatch(now: float):
            for m, q in queues.items():
                if not q:
                    continue
                sm = self._model(m)
                # the admission policy orders the wait queue (the same
                # Pending view the live Scheduler builds); queue storage
                # stays in arrival order so FCFS ranks are stable
                order = sorted(range(len(q)), key=lambda i: (
                    self.admission.key(Pending(
                        i, q[i].slo.priority if q[i].slo else 0,
                        q[i].deadline, now - q[i].t_arrive))))
                served: set = set()
                for qi in order:
                    req = q[qi]
                    cand = None
                    for inst in instances.values():
                        if inst.model != m:
                            continue
                        si = inst.free_slot(now)
                        if si is None:
                            continue
                        key = (max(inst.ready_time, now, inst.slots[si]),
                               0 if inst.kind == "local" else 1)
                        if cand is None or key < cand[0]:
                            cand = (key, inst, si)
                    if cand is None:
                        continue
                    _, inst, si = cand
                    served.add(qi)
                    start = max(now, inst.ready_time, inst.slots[si])
                    penalty = (len(inst.nodes) * HOP_LATENCY
                               if inst.kind == "pipeline" else 0.0)
                    tok = sm.tok_time(hw) * (
                        PIPELINE_TOK_OVERHEAD if inst.kind == "pipeline"
                        else 1.0)
                    ttft = (start + sm.prefill_time(hw, req.prompt_len)
                            + penalty + tok)
                    done = ttft + (req.out_tokens - 1) * tok
                    inst.slots[si] = done
                    inst.last_active = done
                    active[inst.inst_id] = active.get(inst.inst_id, 0) + 1
                    result.ttft.append((req.t_arrive, ttft - req.t_arrive))
                    log.on_first_token(req.req_id, ttft)
                    log.on_finish(req.req_id, done, req.out_tokens)
                    recent_ttft[m].append(ttft - req.t_arrive)
                    push(done, "req_done", (inst.inst_id, req.out_tokens))
                queues[m] = [r for i, r in enumerate(q) if i not in served]

        def provision(m: str, n_new: int, now: float):
            sm = self._model(m)
            for spec in self.policy.provision(self.cluster, m, sm, n_new,
                                              now):
                # 2-D pipelining (§4.3): a g-stage pipeline keeps all g
                # nodes busy on different in-flight batches → g× slots.
                n_slots = instance_slot_count(spec["kind"],
                                              len(spec["nodes"]), self.slots)
                iid = next(self._iid)
                inst = Instance(iid, m, tuple(spec["nodes"]), spec["kind"],
                                spec["ready"], [0.0] * n_slots,
                                owns_gpus=spec.get("owns_gpus", True),
                                last_active=spec["ready"])
                instances[iid] = inst
                result.instance_events.append(
                    (spec["ready"], "up:" + spec["kind"], m))
                log.on_scale(spec["ready"], "up", m,
                             f"{spec['kind']}:{len(spec['nodes'])}n")
                push(spec["ready"], "inst_ready", iid)
                if spec.get("drain_at") is not None:
                    push(spec["drain_at"], "drain", iid)

        while evq:
            now, _, kind, payload = heapq.heappop(evq)
            if kind == "arrival":
                queues[payload.model].append(payload)
                arr_count[payload.model] += 1
                dispatch(now)
            elif kind == "req_done":
                iid, toks = payload
                result.completions.append((now, toks))
                if iid in active:
                    active[iid] -= 1
                dispatch(now)
            elif kind == "inst_ready":
                dispatch(now)
            elif kind == "drain":
                inst = instances.get(payload)
                if inst is not None:
                    inst.draining = True
                    result.instance_events.append((now, "switch", inst.model))
                    log.on_scale(now, "switch", inst.model, inst.kind)
            elif kind == "autoscale":
                # closed loop: build per-model load signals and let the
                # shared Autoscaler size the fleet; the policy keeps
                # deciding the provisioning mechanism
                signals: List[LoadSignals] = []
                for m, q in queues.items():
                    # only models with demand pressure signal the
                    # controller (a queue, recent TTFTs the SLO trigger
                    # may act on, or fresh arrivals the forecast tracks)
                    # — headroom must not provision capacity for a model
                    # receiving no requests
                    if not q and not recent_ttft[m] and not arr_count[m]:
                        continue
                    # capacity = occupied nodes (a mid-load λPipe pipeline
                    # counts its member nodes: they are provisioning
                    # capacity, not available headroom)
                    live = [i for i in instances.values()
                            if i.model == m and not i.draining]
                    nodes_busy = {nd for i in live for nd in i.nodes}
                    ready = [i for i in live if i.ready_time <= now]
                    slots_total = sum(len(i.slots) for i in ready)
                    slots_busy = sum(1 for i in ready
                                     for end in i.slots if end > now)
                    signals.append(LoadSignals(
                        m, len(q), slots_total, slots_busy,
                        len(nodes_busy), self.slots,
                        recent_ttft=recent_ttft[m],
                        slo_pressure=slo_pressure_of(q, now),
                        recent_arrivals=arr_count[m]))
                    recent_ttft[m] = []
                    arr_count[m] = 0
                # concurrent scale-ups contend for the free pool: the
                # arbiter divides it by SLO pressure (an uncontended ask
                # is granted in full — identical to the pre-arbiter
                # path), and granted models provision highest-pressure
                # first so a low-pressure model's cold-start source
                # never consumes nodes granted to a more urgent one
                # (here the source IS part of n_new — the policies
                # decrement it — unlike LiveCluster.scale)
                ups = {act.model: act
                       for act in self.autoscaler.decide(now, signals)
                       if isinstance(act, ScaleUp)}
                press = {s.model: s.slo_pressure for s in signals}
                grants = self.arbiter.arbitrate(
                    {m: a.n_new for m, a in ups.items()},
                    len(self.cluster.free_nodes()), press)
                for m in self.arbiter.up_order(list(ups), press):
                    provision(m, grants.get(m, ups[m].n_new), now)
                # scale-in (keep-alive via the autoscaler) + GC of
                # drained pipelines
                for iid in list(instances):
                    inst = instances[iid]
                    idle = (active.get(iid, 0) == 0
                            and now > inst.ready_time)
                    if inst.draining and idle:
                        del instances[iid]      # pipeline fully switched
                        continue
                    if idle and self.autoscaler.should_retire(
                            now, inst.last_active):
                        if inst.owns_gpus:
                            for nd in inst.nodes:
                                if inst.model in self.cluster.nodes[nd].gpu:
                                    self.cluster.release(nd, now,
                                                         inst.model)
                        result.instance_events.append(
                            (now, "down:" + inst.kind, inst.model))
                        log.on_scale(now, "down", inst.model, inst.kind)
                        del instances[iid]
                dispatch(now)

        self.cluster.finalize(horizon)
        result.gpu_seconds = self.cluster.gpu_seconds
        log.gpu_seconds = self.cluster.gpu_seconds
        return result
