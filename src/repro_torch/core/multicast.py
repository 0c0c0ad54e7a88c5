"""λPipe adaptive model multicast — binomial pipeline schedules (§4.2).

A *schedule* is a list of steps; each step is a list of (src, dst, block)
transfers obeying the one-send/one-receive-per-node-per-step (full-duplex
telephone) model of RDMC [24] / Ganesan-Seshadri [29].

For N a power of two we reproduce the hypercube binomial pipeline exactly:
at step s nodes exchange along dimension (s mod log2 N); the source releases
block t at step t (staggered) and every node forwards its most recently
received block the peer lacks.  This completes 1→N in the provably optimal
``b + log2 N − 1`` steps (property-tested).

For other N we fall back to a greedy maximal matching with the same
newest-block-first rule (measured slack ≤ 3 steps over the bound for all
N ≤ 64, b ≤ 24 — also property-tested).

k→N scaling (Algorithm 1, "k-way transmission") splits the nodes into k
sub-groups; sub-group i transfers the b blocks in circularly-shifted chunk
order O_i, so one node per sub-group collectively covers all blocks after
only ⌈b/k⌉ steps.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

Transfer = Tuple[int, int, int]            # (src, dst, block)


@dataclasses.dataclass
class Schedule:
    n_nodes: int
    n_blocks: int
    steps: List[List[Transfer]]
    # block transfer order per sub-group (k-way); trivial for 1→N
    block_orders: Optional[List[List[int]]] = None
    sub_groups: Optional[List[List[int]]] = None   # node ids, [source, *dests]

    @property
    def n_steps(self) -> int:
        return len(self.steps)

    def arrival_steps(self, initial: Dict[int, Sequence[int]]
                      ) -> Dict[int, Dict[int, int]]:
        """step (1-indexed; 0 = held initially) at which each node holds
        each block."""
        arr: Dict[int, Dict[int, int]] = {
            n: {} for n in range(self.n_nodes)}
        for n, blks in initial.items():
            for b in blks:
                arr[n][b] = 0
        for s, step in enumerate(self.steps):
            for src, dst, blk in step:
                if blk not in arr[dst]:
                    arr[dst][blk] = s + 1
        return arr

    def validate(self, initial: Dict[int, Sequence[int]]) -> None:
        """Raise if the schedule violates the transfer model or is
        incomplete."""
        have = {n: set(blks) for n, blks in initial.items()}
        for n in range(self.n_nodes):
            have.setdefault(n, set())
        for s, step in enumerate(self.steps):
            senders, receivers = set(), set()
            adds = []
            for src, dst, blk in step:
                assert src != dst
                assert blk in have[src], \
                    f"step {s}: node {src} sends block {blk} it lacks"
                assert src not in senders, f"step {s}: {src} sends twice"
                assert dst not in receivers, f"step {s}: {dst} recvs twice"
                senders.add(src)
                receivers.add(dst)
                adds.append((dst, blk))
            for dst, blk in adds:
                have[dst].add(blk)
        for n in range(self.n_nodes):
            assert have[n] == set(range(self.n_blocks)), \
                f"node {n} incomplete: {sorted(have[n])}"


def optimal_steps(n_nodes: int, n_blocks: int) -> int:
    """Paper's bound: b + ⌈log2 N⌉ − 1 (§4.2)."""
    return n_blocks + max(1, math.ceil(math.log2(max(n_nodes, 2)))) - 1


# ------------------------------------------------------------ 1→N schedules
def _hypercube_schedule(n_nodes: int, n_blocks: int) -> List[List[Transfer]]:
    d = (n_nodes - 1).bit_length()
    arr: List[Dict[int, int]] = [dict() for _ in range(n_nodes)]
    arr[0] = {blk: blk for blk in range(n_blocks)}   # staggered release
    steps: List[List[Transfer]] = []
    while any(len(a) < n_blocks for a in arr):
        s = len(steps)
        dim = s % d
        step: List[Transfer] = []
        for i in range(n_nodes):
            j = i ^ (1 << dim)
            if j >= n_nodes:
                continue
            useful = [blk for blk, t in arr[i].items()
                      if blk not in arr[j] and t <= s]
            if useful:
                blk = max(useful, key=lambda x: (arr[i][x], x))
                step.append((i, j, blk))
        for src, dst, blk in step:
            arr[dst].setdefault(blk, s + 1)
        steps.append(step)
    return steps


def _greedy_schedule(n_nodes: int, n_blocks: int) -> List[List[Transfer]]:
    arr: List[Dict[int, int]] = [dict() for _ in range(n_nodes)]
    arr[0] = {blk: blk for blk in range(n_blocks)}
    steps: List[List[Transfer]] = []
    bound = 5 * optimal_steps(n_nodes, n_blocks) + 20
    while any(len(a) < n_blocks for a in arr):
        s = len(steps)
        busy = set()
        step: List[Transfer] = []
        recvs = sorted((i for i in range(n_nodes) if len(arr[i]) < n_blocks),
                       key=lambda i: (len(arr[i]), i))
        for r in recvs:
            best = None
            for src in range(n_nodes):
                if src in busy or src == r:
                    continue
                useful = [blk for blk, t in arr[src].items()
                          if blk not in arr[r] and t <= s]
                if not useful:
                    continue
                blk = max(useful, key=lambda x: (arr[src][x], x))
                key = (arr[src][blk], -len(arr[src]))
                if best is None or key > best[0]:
                    best = (key, src, blk)
            if best:
                _, src, blk = best
                busy.add(src)
                step.append((src, r, blk))
        for src, dst, blk in step:
            arr[dst].setdefault(blk, s + 1)
        steps.append(step)
        assert len(steps) < bound, "greedy multicast failed to converge"
    return steps


def binomial_schedule(n_nodes: int, n_blocks: int) -> Schedule:
    """1→N multicast: node 0 holds all blocks, distributes to nodes 1..N-1."""
    assert n_nodes >= 1 and n_blocks >= 1
    if n_nodes == 1:
        return Schedule(1, n_blocks, [])
    if n_nodes & (n_nodes - 1) == 0:
        steps = _hypercube_schedule(n_nodes, n_blocks)
    else:
        steps = _greedy_schedule(n_nodes, n_blocks)
    return Schedule(n_nodes, n_blocks, steps,
                    block_orders=[list(range(n_blocks))],
                    sub_groups=[list(range(n_nodes))])


# --------------------------------------------------- Algorithm 1: k-way order
def kway_block_orders(n_blocks: int, k: int) -> List[List[int]]:
    """Algorithm 1 — k circularly-shifted chunk orders."""
    l = math.ceil(n_blocks / k)
    chunks = [list(range(l * i, min(l * (i + 1), n_blocks)))
              for i in range(k)]
    orders = []
    for i in range(k):
        o: List[int] = []
        for j in range(k):
            o.extend(chunks[(i + j) % k])
        orders.append(o)
    return orders


def kway_chunks(n_blocks: int, k: int) -> List[List[int]]:
    l = math.ceil(n_blocks / k)
    return [list(range(l * i, min(l * (i + 1), n_blocks))) for i in range(k)]


def split_sub_groups(nodes: Sequence[int], k: int) -> List[List[int]]:
    """Split nodes (sources first: nodes[0..k-1] are the k sources) into k
    sub-groups of near-equal size, each led by one source."""
    n = len(nodes)
    assert k >= 1 and n >= k
    sources, dests = list(nodes[:k]), list(nodes[k:])
    groups = [[s] for s in sources]
    for i, d in enumerate(dests):
        groups[i % k].append(d)
    return groups


def kway_schedule(n_nodes: int, n_blocks: int, k: int) -> Schedule:
    """k→N scaling: nodes 0..k-1 are sources, each leads a sub-group that
    runs an independent 1→L binomial multicast with block order O_i
    (Algorithm 1).  Sub-group schedules execute concurrently (disjoint
    node sets), merged step-wise."""
    assert 1 <= k < max(n_nodes, 2) or (k == 1 and n_nodes == 1)
    groups = split_sub_groups(list(range(n_nodes)), k)
    orders = kway_block_orders(n_blocks, k)
    merged: List[List[Transfer]] = []
    for gi, group in enumerate(groups):
        sub = binomial_schedule(len(group), n_blocks)
        order = orders[gi]
        for s, step in enumerate(sub.steps):
            while len(merged) <= s:
                merged.append([])
            for src, dst, blk in step:
                # virtual block index -> real block id via the group's order
                merged[s].append((group[src], group[dst], order[blk]))
    return Schedule(n_nodes, n_blocks, merged,
                    block_orders=orders, sub_groups=groups)


# ------------------------------------------------------------ timing model
# Single source of truth for the inter-node link calibration: the serving
# layer's HardwareProfile (serving/tiers.py) imports these as its defaults,
# so recalibrating the link means editing exactly these two constants.
DEFAULT_LINK_BW = 50e9          # bytes/s (ICI link; paper: 400Gb/s IB)
DEFAULT_STEP_OVERHEAD = 0.004   # s, per-step processing (paper Fig 18)


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """Per-step wall-clock model: t = block_bytes / bw + overhead."""
    bandwidth: float = DEFAULT_LINK_BW
    step_overhead: float = DEFAULT_STEP_OVERHEAD

    @classmethod
    def from_profile(cls, hw) -> "LinkModel":
        """Build from a ``serving.tiers.HardwareProfile`` (anything with
        ``link_bw`` / ``step_overhead`` attributes)."""
        return cls(bandwidth=hw.link_bw, step_overhead=hw.step_overhead)

    def step_time(self, block_bytes: float) -> float:
        return block_bytes / self.bandwidth + self.step_overhead

    def multicast_time(self, model_bytes: float, n_nodes: int,
                       n_blocks: int, k: int = 1) -> float:
        """End-to-end T ∝ M (1 + log N / b) with per-step overhead."""
        if n_nodes <= k:
            return 0.0
        group = math.ceil(n_nodes / k)
        steps = optimal_steps(group, n_blocks)
        return steps * self.step_time(model_bytes / n_blocks)


# ----------------------------------------------- multi-tier restore model
@dataclasses.dataclass(frozen=True)
class RestorePlan:
    """Timing of a chunked multi-stage (e.g. SSD→host→GPU) model restore.

    ``t_first`` is when the FIRST chunk is resident on the final stage
    (GPU) — the moment execute-while-load can begin; ``chunk_dt`` is the
    steady-state interval between chunk arrivals (the bottleneck stage);
    ``t_total`` is when the LAST chunk lands.  All times are relative to
    the restore's start.
    """
    n_chunks: int
    t_first: float
    chunk_dt: float
    t_total: float

    def t_chunk(self, i: int) -> float:
        """Arrival time of chunk ``i`` (0-based) on the final stage."""
        if i <= 0:
            return self.t_first
        return self.t_first + min(i, self.n_chunks - 1) * self.chunk_dt


def pipelined_restore(nbytes: float, n_chunks: int, stage_bws,
                      overhead: float = 0.0,
                      pipelined: bool = True) -> RestorePlan:
    """ServerlessLLM-style chunked loading through a bandwidth pipeline.

    ``stage_bws`` is the ordered per-stage bandwidth list (bytes/s), e.g.
    ``(ssd_bw, host_to_gpu_bw)``.  Pipelined, chunks are in flight
    through every stage simultaneously: the first chunk fills the
    pipeline (sum over stages), then one chunk emerges per bottleneck-
    stage interval.  Naive, each stage moves the WHOLE blob before the
    next starts — the blocking fetch ``fetch_seconds`` prices.  With a
    single chunk the two are identical (no overlap is possible).
    """
    bws = [float(b) for b in stage_bws if b]
    n = max(1, int(n_chunks))
    if not bws:
        return RestorePlan(n, overhead, 0.0, overhead)
    if not pipelined or n == 1:
        total = overhead + sum(nbytes / b for b in bws)
        return RestorePlan(n, total, 0.0, total)
    chunk = nbytes / n
    fill = sum(chunk / b for b in bws)
    bottleneck = max(chunk / b for b in bws)
    t_first = overhead + fill
    return RestorePlan(n, t_first, bottleneck,
                       t_first + (n - 1) * bottleneck)
