"""λPipe execution pipelines — Algorithm 2 + readiness analysis (§4.3).

An *execution pipeline* is a model-serving instance spanning a group of
nodes that collectively hold a complete model: an ordered list of
(node, block_ids) stages whose block sets partition [0, b).  Requests are
pinned to a pipeline (so KV caches never move between nodes) and processed
with 2-D pipelining (blocks × in-flight batches) — the 2-D part is realized
by the GPipe-style runner in ``repro_torch.distributed.pipeline`` and by
the discrete-event simulator.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence

from repro_torch.core.multicast import Schedule, kway_chunks


@dataclasses.dataclass(frozen=True)
class Stage:
    node: int
    blocks: tuple    # block ids owned by this stage (contiguous in model order)


@dataclasses.dataclass(frozen=True)
class ExecutionPipeline:
    stages: tuple    # of Stage, ordered by first block

    @property
    def nodes(self):
        return [s.node for s in self.stages]

    def block_map(self) -> Dict[int, int]:
        return {b: s.node for s in self.stages for b in s.blocks}


def generate_pipelines(sub_groups: Sequence[Sequence[int]],
                       n_blocks: int) -> List[ExecutionPipeline]:
    """Algorithm 2 — Execution Pipeline Generation.

    sub_groups: k lists of *destination* nodes with unassigned status
    (callers usually pass the schedule's sub-groups minus the sources).
    Cross-group pipelines take one node from each remaining group; the node
    from sub-group i serves chunk S_i (the first chunk in that group's
    transfer order O_i, hence the earliest it owns).  When only one group
    remains, its nodes form a single pipeline splitting the blocks
    contiguously.
    """
    k = len(sub_groups)
    chunks = kway_chunks(n_blocks, k)
    remaining: List[List[int]] = [list(g) for g in sub_groups]
    pipelines: List[ExecutionPipeline] = []

    def single_group(nodes: List[int]) -> None:
        """One pipeline over ordered nodes, blocks split contiguously;
        nodes beyond n_blocks become full-replica (local-mode) pipelines."""
        chain, extra = nodes[:n_blocks], nodes[n_blocks:]
        n = len(chain)
        stages = [Stage(node, tuple(range(round(t * n_blocks / n),
                                          round((t + 1) * n_blocks / n))))
                  for t, node in enumerate(chain)]
        pipelines.append(ExecutionPipeline(tuple(stages)))
        for node in extra:
            pipelines.append(ExecutionPipeline(
                (Stage(node, tuple(range(n_blocks))),)))

    # sub-groups whose chunk is empty (k > b edge case): their nodes serve
    # as full replicas once loaded — single-node pipelines.
    for gi in range(k):
        if not chunks[gi] and remaining[gi]:
            for node in remaining[gi]:
                pipelines.append(ExecutionPipeline(
                    (Stage(node, tuple(range(n_blocks))),)))
            remaining[gi] = []

    while any(remaining):
        live = [(i, g) for i, g in enumerate(remaining) if g]
        if len(live) == 1:
            gi, g = live[0]
            single_group(g)
            remaining[gi] = []
        else:
            # chunks of exhausted sub-groups go to the live group whose
            # transfer order O_i reaches them earliest (circular shift)
            live_ids = [gi for gi, _ in live]
            owned = {gi: list(chunks[gi]) for gi in live_ids}
            for m in range(k):
                if m in live_ids or not chunks[m]:
                    continue
                best = min(live_ids, key=lambda gi: (m - gi) % k)
                owned[best].extend(chunks[m])
            a = min(len(g) for _, g in live)
            for t in range(a):
                stages = [Stage(g[t], tuple(sorted(owned[gi])))
                          for gi, g in live]
                stages.sort(key=lambda s: s.blocks[0])
                pipelines.append(ExecutionPipeline(tuple(stages)))
            for gi, g in live:
                remaining[gi] = g[a:]
    return pipelines


def generate_pipelines_dynamic(sub_groups: Sequence[Sequence[int]],
                               n_blocks: int,
                               arrivals: Dict[int, Dict[int, int]]
                               ) -> List[ExecutionPipeline]:
    """Arrival-aware pipeline construction (the 'dynamically constructs
    execution pipelines at runtime' part of §4.3).

    Cross-sub-group pipelines keep Algorithm 2's chunk structure; pipelines
    formed WITHIN one sub-group (k=1 or leftover nodes) assign each block
    to the member that receives it earliest under the multicast schedule —
    this is what lets λScale serve 'as soon as the first blocks are loaded'
    (paper Fig 11) instead of waiting for the contiguous split to finish.
    """
    base = generate_pipelines(sub_groups, n_blocks)
    out: List[ExecutionPipeline] = []
    for pipe in base:
        nodes = pipe.nodes
        if len(nodes) <= 1:
            out.append(pipe)
            continue
        cap = math.ceil(n_blocks / len(nodes))
        load = {n: 0 for n in nodes}
        owner: Dict[int, List[int]] = {n: [] for n in nodes}
        feasible = True
        for j in range(n_blocks):
            cands = [n for n in nodes
                     if load[n] < cap and j in arrivals.get(n, {})]
            if not cands:
                feasible = False
                break
            best = min(cands, key=lambda n: (arrivals[n][j], load[n]))
            owner[best].append(j)
            load[best] += 1
        if not feasible:
            out.append(pipe)
            continue
        stages = tuple(sorted((Stage(n, tuple(bs))
                               for n, bs in owner.items() if bs),
                              key=lambda s: s.blocks[0]))
        dyn = ExecutionPipeline(stages)
        # keep whichever is ready earlier
        r_dyn = pipeline_ready_step(dyn, arrivals)
        r_base = pipeline_ready_step(pipe, arrivals)
        out.append(dyn if 0 <= r_dyn and (r_base < 0 or r_dyn <= r_base)
                   else pipe)
    return out


def pipeline_ready_step(pipe: ExecutionPipeline,
                        arrivals: Dict[int, Dict[int, int]]) -> int:
    """First multicast step after which every stage holds its blocks."""
    ready = 0
    for st in pipe.stages:
        for b in st.blocks:
            if b not in arrivals[st.node]:
                return -1            # never ready under this schedule
            ready = max(ready, arrivals[st.node][b])
    return ready


def first_ready_step(schedule: Schedule,
                     initial: Dict[int, Sequence[int]]) -> int:
    """Earliest step at which SOME complete execution pipeline exists among
    destination nodes (paper claim: ⌈b/k⌉ with k-way transmission)."""
    arrivals = schedule.arrival_steps(initial)
    assert schedule.sub_groups is not None
    dests = [g[1:] for g in schedule.sub_groups]
    pipes = generate_pipelines(dests, schedule.n_blocks)
    steps = [pipeline_ready_step(p, arrivals) for p in pipes]
    steps = [s for s in steps if s >= 0]
    return min(steps) if steps else -1
