"""Scaling policies: λScale and the paper's three baselines (§7.1).

A policy is the provisioning MECHANISM half of the closed loop: the
shared ``Autoscaler`` (``serving/autoscaler.py``) decides WHEN and HOW
MUCH to scale from load signals, then the simulator asks the policy to
provision that many nodes — so comparing policies under one controller
isolates exactly the scaling mechanism the paper compares.

Each policy's ``provision(cluster, model, sim_model, n_new, now)`` occupies
GPUs and returns instance specs:
  {"nodes": [...], "kind": "local"|"pipeline", "ready": t,
   "drain_at": t|None, "owns_gpus": bool}

* ``LambdaScalePolicy`` — locality-driven startup (§5) + λPipe (§4):
  k GPU-resident replicas multicast via the k-way binomial pipeline;
  execution pipelines serve during loading (execute-while-load); at
  completion pipelines drain and every receiving node becomes a local
  replica (mode switching with KV recompute).
* ``ServerlessLLMPolicy`` — per-node tiered loading (host-mem hit else
  SSD); serves only once fully loaded.  [28]
* ``FaaSNetPolicy`` — binary-tree block multicast (fanout 2); no
  execute-while-load.  [47]
* ``NCCLPolicy`` — ring broadcast with group-(re)initialization overhead;
  all receivers complete together.  [16]
* ``IdealPolicy`` — zero-cost instant scaling (paper Fig 14 reference).
"""
from __future__ import annotations

import math
from typing import Dict, List

from repro_torch.core.blocks import elbow_block_count
from repro_torch.core.ewl import plan_scale
from repro_torch.serving.placement import PlacementArbiter
from repro_torch.serving.simulator import SimModel
from repro_torch.serving.tiers import ClusterState, HardwareProfile

DEFAULT_BLOCKS = 16          # paper Fig 18 elbow
MODE_SWITCH_DELAY = 0.05     # s: KV recompute for in-flight requests (§4.4)


class BasePolicy:
    name = "base"

    def __init__(self, hw: HardwareProfile, n_blocks: int = DEFAULT_BLOCKS):
        self.hw = hw
        self.n_blocks = n_blocks
        # destination picking routes through the placement arbiter; the
        # Simulator overwrites this with its (shared) instance so live
        # cluster and simulator rank scale-out nodes identically
        self.arbiter = PlacementArbiter()

    # ---------------------------------------------------------------- util
    def _block_time(self, sm: SimModel) -> float:
        return sm.bytes / self.n_blocks / self.hw.link_bw \
            + self.hw.step_overhead

    def _dests(self, cluster: ClusterState, model: str, n: int) -> List[int]:
        """Arbiter-ranked free destinations (§5 locality) for a
        scale-out — first-free order when no arbiter is attached."""
        if self.arbiter is None:
            return cluster.free_nodes()[:max(n, 0)]
        return self.arbiter.pick_dests(cluster, model, n)

    def _acquire_source(self, cluster: ClusterState, model: str,
                        sm: SimModel, now: float):
        """Locality-driven source acquisition. Returns
        (source_node or None, ready_time, new_instance_specs)."""
        hot = cluster.gpu_nodes(model)
        if hot:
            return hot[0], now, []
        free = cluster.free_nodes()
        if not free:
            return None, now, []
        warm_free = [n for n in cluster.warm_nodes(model) if n in free]
        warm_any = [n.node_id for n in cluster.nodes
                    if model in n.host_cache]
        if warm_free:
            node = warm_free[0]
            delay = self.hw.fetch_seconds(sm.bytes, "host")
        elif warm_any and self.allow_remote_memory:
            # one-sided RDMA read of a remote node's host memory (§5 cold)
            node, delay = free[0], self.hw.fetch_seconds(sm.bytes, "remote")
        else:
            node, delay = free[0], self.hw.fetch_seconds(sm.bytes, "ssd")
        cluster.occupy(node, model, now)
        spec = {"nodes": [node], "kind": "local", "ready": now + delay,
                "drain_at": None, "owns_gpus": True}
        return node, now + delay, [spec]

    allow_remote_memory = True

    def mode_switch_delay(self, sm: SimModel, hw: HardwareProfile) -> float:
        return MODE_SWITCH_DELAY

    def provision(self, cluster: ClusterState, model: str, sm: SimModel,
                  n_new: int, now: float) -> List[Dict]:
        raise NotImplementedError


# ------------------------------------------------------------------ λScale
class LambdaScalePolicy(BasePolicy):
    name = "lambdascale"

    def __init__(self, hw: HardwareProfile, n_blocks: int = DEFAULT_BLOCKS,
                 max_k: int = 4, adaptive_blocks: bool = False):
        super().__init__(hw, n_blocks)
        self.max_k = max_k
        self.adaptive_blocks = adaptive_blocks

    def provision(self, cluster, model, sm, n_new, now):
        specs: List[Dict] = []
        sources = cluster.gpu_nodes(model)
        t0 = now

        # §5 locality-driven startup — warm destinations load their OWN
        # host copy (64 GB/s beats multicast), and λPipe forms execution
        # pipelines ACROSS the loading nodes so serving starts after ~1/g
        # of the load instead of all of it (paper Fig 10).
        warm_free = [n for n in cluster.warm_nodes(model)
                     if n in cluster.free_nodes()]
        take = warm_free[:max(n_new, 0 if sources else 1)]
        if take:
            load_t = self.hw.fetch_seconds(sm.bytes, "host")
            for nd in take:
                cluster.occupy(nd, model, now)
                specs.append({"nodes": [nd], "kind": "local",
                              "ready": now + load_t, "drain_at": None,
                              "owns_gpus": True})
            for i in range(0, len(take) - 1, 4):
                grp = take[i:i + 4]
                if len(grp) >= 2:
                    specs.append({
                        "nodes": grp, "kind": "pipeline",
                        "ready": now + load_t / len(grp)
                        + self.hw.step_overhead,
                        "drain_at": now + load_t
                        + self.mode_switch_delay(sm, self.hw),
                        "owns_gpus": False})
            if not sources:
                sources = [take[0]]
                t0 = now + load_t
            n_new -= len(take)
        if not sources:
            src, t0, s_specs = self._acquire_source(cluster, model, sm,
                                                    now)
            if src is None:
                return specs
            specs += s_specs
            sources = [src]
            n_new -= 1
        if n_new <= 0:
            return specs
        dests = self._dests(cluster, model, n_new)
        if not dests:
            return specs
        k = max(1, min(len(sources), self.max_k))
        srcs = sources[:k]
        b = self.n_blocks
        if self.adaptive_blocks:
            b = elbow_block_count(sm.bytes, len(dests) + k,
                                  self.hw.link_model())
        plan = plan_scale(k + len(dests), b, k)
        node_map = {i: n for i, n in enumerate(srcs + dests)}
        step_t = sm.bytes / b / self.hw.link_bw + self.hw.step_overhead
        for nd in dests:
            cluster.occupy(nd, model, now)
        # pipelines: serve during load, drain at mode switch (§4.3/§4.4)
        for pipe, rstep in zip(plan.pipelines, plan.pipeline_ready):
            if rstep < 0:
                continue
            real = [node_map[s.node] for s in pipe.stages]
            done = max(plan.node_complete[s.node] for s in pipe.stages)
            specs.append({
                "nodes": real, "kind": "pipeline",
                "ready": t0 + rstep * step_t,
                "drain_at": t0 + done * step_t
                + self.mode_switch_delay(sm, self.hw),
                "owns_gpus": False,
            })
        # local replicas take over per node at its completion (§4.4)
        for pi, nd in enumerate(dests, start=k):
            done = plan.node_complete[pi]
            specs.append({
                "nodes": [nd], "kind": "local",
                "ready": t0 + done * step_t
                + self.mode_switch_delay(sm, self.hw),
                "drain_at": None, "owns_gpus": True,
            })
        return specs


# ------------------------------------------------------------ ServerlessLLM
class ServerlessLLMPolicy(BasePolicy):
    name = "serverlessllm"
    allow_remote_memory = False       # local-cache-based loading only

    def provision(self, cluster, model, sm, n_new, now):
        specs: List[Dict] = []
        free = cluster.free_nodes()
        # locality-aware placement: warm nodes first
        warm = [n for n in cluster.warm_nodes(model) if n in free]
        cold = [n for n in free if n not in warm]
        for nd in (warm + cold)[:n_new]:
            delay = self.hw.fetch_seconds(sm.bytes,
                                          "host" if nd in warm else "ssd")
            cluster.occupy(nd, model, now)
            specs.append({"nodes": [nd], "kind": "local",
                          "ready": now + delay, "drain_at": None,
                          "owns_gpus": True})
        return specs


# ----------------------------------------------------------------- FaaSNet
class FaaSNetPolicy(BasePolicy):
    name = "faasnet"

    def provision(self, cluster, model, sm, n_new, now):
        specs: List[Dict] = []
        src, t0, s_specs = self._acquire_source(cluster, model, sm, now)
        if src is None:
            return []
        specs += s_specs
        if s_specs:
            n_new -= 1
        dests = self._dests(cluster, model, n_new)
        tb = self._block_time(sm)
        for i, nd in enumerate(dests):
            cluster.occupy(nd, model, now)
            depth = int(math.floor(math.log2(i + 2)))   # binary tree (heap)
            # fanout-2 serializes each block twice per level; no EWL
            ready = t0 + depth * 2 * tb + 2 * self.n_blocks * tb
            specs.append({"nodes": [nd], "kind": "local", "ready": ready,
                          "drain_at": None, "owns_gpus": True})
        return specs


# -------------------------------------------------------------------- NCCL
class NCCLPolicy(BasePolicy):
    name = "nccl"

    def provision(self, cluster, model, sm, n_new, now):
        specs: List[Dict] = []
        src, t0, s_specs = self._acquire_source(cluster, model, sm, now)
        if src is None:
            return []
        specs += s_specs
        if s_specs:
            n_new -= 1
        dests = self._dests(cluster, model, n_new)
        if not dests:
            return specs
        tb = self._block_time(sm)
        m = len(dests) + 1
        # ring-pipelined broadcast + group (re)initialization (§7.2, [11])
        ready = (t0 + self.hw.nccl_group_init
                 + (self.n_blocks + m - 2) * tb)
        for nd in dests:
            cluster.occupy(nd, model, now)
            specs.append({"nodes": [nd], "kind": "local", "ready": ready,
                          "drain_at": None, "owns_gpus": True})
        return specs


# ------------------------------------------------------------------- Ideal
class IdealPolicy(BasePolicy):
    name = "ideal"

    def provision(self, cluster, model, sm, n_new, now):
        specs = []
        for nd in self._dests(cluster, model, n_new):
            cluster.occupy(nd, model, now)
            specs.append({"nodes": [nd], "kind": "local", "ready": now,
                          "drain_at": None, "owns_gpus": True})
        return specs


POLICIES = {p.name: p for p in
            (LambdaScalePolicy, ServerlessLLMPolicy, FaaSNetPolicy,
             NCCLPolicy, IdealPolicy)}
