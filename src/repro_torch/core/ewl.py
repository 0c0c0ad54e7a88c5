"""Execute-while-load controller (λPipe, §4).

Pure-python orchestration shared by the discrete-event simulator and the
execute-while-load path: given a scaling operation k→N with b blocks, it
derives

  * the k-way multicast schedule (Algorithm 1 + binomial pipeline),
  * block arrival times per node,
  * the execution pipelines (Algorithm 2) and the step at which each
    becomes ready (this is when collaborative serving can start),
  * the step at which each node can mode-switch to local execution.

Capacity over time (in "serving units": 1.0 = one full local replica; a
p-stage pipeline counts as 1 instance whose per-token latency is higher but
whose 2-D pipelining keeps all p nodes busy) feeds the simulator's
throughput model.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

from repro_torch.core.multicast import Schedule, kway_schedule
from repro_torch.core.pipeline import (ExecutionPipeline,
                                 generate_pipelines_dynamic,
                                 pipeline_ready_step)


@dataclasses.dataclass
class ScalePlan:
    n_nodes: int            # total nodes incl. k sources
    n_blocks: int
    k: int
    schedule: Schedule
    pipelines: List[ExecutionPipeline]
    pipeline_ready: List[int]       # multicast step when each pipe is ready
    node_complete: Dict[int, int]   # step when node holds the full model
    model: str = ""                 # model being scaled (multi-model runtime)

    @property
    def total_steps(self) -> int:
        return self.schedule.n_steps

    def ready_pipelines_at(self, step: int) -> List[ExecutionPipeline]:
        return [p for p, r in zip(self.pipelines, self.pipeline_ready)
                if 0 <= r <= step]

    def complete_nodes_at(self, step: int) -> List[int]:
        """Destination nodes holding the full model (sources excluded —
        they already run their own serving instances)."""
        return [n for n, s in self.node_complete.items()
                if 0 <= s <= step and n >= self.k]

    def serving_instances_at(self, step: int) -> int:
        """Instances able to serve: mode-switched local replicas, plus
        pipelines whose every member is still mid-load."""
        complete = set(self.complete_nodes_at(step))
        n_inst = len(complete)
        for p, r in zip(self.pipelines, self.pipeline_ready):
            if 0 <= r <= step and not any(n in complete for n in p.nodes):
                n_inst += 1
        return n_inst


def plan_scale(n_nodes: int, n_blocks: int, k: int = 1, *,
               model: str = "") -> ScalePlan:
    """Build the λPipe plan for a k→N scaling operation."""
    sched = kway_schedule(n_nodes, n_blocks, k)
    initial = {src: list(range(n_blocks)) for src in range(k)}
    arrivals = sched.arrival_steps(initial)
    assert sched.sub_groups is not None
    dests = [g[1:] for g in sched.sub_groups]
    pipes = generate_pipelines_dynamic(dests, n_blocks, arrivals)
    ready = [pipeline_ready_step(p, arrivals) for p in pipes]
    complete = {n: max(arrivals[n].values()) if arrivals[n] else -1
                for n in range(n_nodes)}
    return ScalePlan(n_nodes, n_blocks, k, sched, pipes, ready, complete,
                     model=model)
