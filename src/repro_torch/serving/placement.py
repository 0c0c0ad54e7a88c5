"""Cluster-wide placement arbiter (the control plane's node assignment).

ServerlessLLM (arXiv:2401.14351) shows that *which node* serves a model
matters as much as how fast it loads; λScale's runtimes previously made
those choices locally and greedily — ``register(warm_nodes=[...])`` was
hand-placed, each ``scale()`` grabbed ``free_nodes()[:n]``, and handoff
targets were the first local replica found.  The ``PlacementArbiter``
centralizes all three decisions and is shared by BOTH runtimes (the
live ``LiveCluster`` and the discrete-event ``Simulator``), so placement
policies A/B under identical traces:

* **Warm packing** (``place_warm``): at ``register`` time, spread a
  model's host-tier copies across nodes with the least-loaded host
  caches, so later locality-driven startups find a warm source without
  LRU-evicting other models' payloads.

* **Scale-out destinations** (``pick_dests``): free nodes ranked by
  locality — nodes already host-warm for the model first (their
  mode-switched replica co-locates with its own fallback copy; a later
  scale-down/re-scale cycle stays in the host tier), then nodes whose
  host caches hold the fewest *other* models (a future demotion there
  won't evict someone else's warmth).

* **Contention arbitration** (``arbitrate``): when several models scale
  concurrently and free nodes are scarce, divide them weighted by
  per-model SLO pressure (``MetricsLog.slo_pressure``: deadline-urgency
  of waiting requests, priority-weighted) instead of first-come-take-all.
  Uncontended requests are always granted in full, so single-model runs
  are byte-identical to the pre-arbiter behavior.

* **Handoff targets** (``handoff_target``): at drain/mode-switch time,
  rank adopting replicas by KV locality — a replica on a member node of
  the draining instance (GPU tier: the packed KV never crosses the
  link) beats a ready replica elsewhere (host: one link transfer),
  beats a replica still inside its priced fetch window (remote) — load
  and node id break ties.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.metrics import slo_pressure_of   # noqa: F401 (re-export:
#   the pressure formula lives in metrics — one definition for both
#   runtimes — but callers reasonably look for it beside the arbiter)
from repro_torch.serving.tiers import ClusterState


class PlacementArbiter:
    """Stateless, deterministic placement decisions over ``ClusterState``.

    ``slo_weighted=False`` degrades ``arbitrate`` to first-come order —
    the "independent scaling" baseline ``bench_slo`` measures against.
    """

    def __init__(self, *, slo_weighted: bool = True):
        self.slo_weighted = slo_weighted

    # ------------------------------------------------------- warm packing
    def place_warm(self, state: ClusterState, model: str,
                   n_copies: int) -> List[int]:
        """Nodes for ``n_copies`` host-tier warm copies of ``model``:
        least-loaded host caches first (fewest cached models → the new
        payload is least likely to be LRU-evicted and least likely to
        evict others), skipping nodes already warm for the model."""
        cands = [n for n in state.nodes if model not in n.host_cache]
        ranked = sorted(cands,
                        key=lambda n: (len(n.host_cache.models()),
                                       n.node_id))
        return [n.node_id for n in ranked[:max(n_copies, 0)]]

    # ------------------------------------------------- scale-out placement
    def pick_dests(self, state: ClusterState, model: str, n: int,
                   exclude: Sequence[int] = (),
                   near: Sequence[int] = ()) -> List[int]:
        """Rank free nodes for a scale-out of ``model`` (§5 locality):
        warm-for-this-model first, then — for role-split pools —
        proximity to ``near`` (the feeding pool's nodes: a decode
        replica lands beside the prefill nodes that will stream KV to
        it; node-id distance is the rack-adjacency proxy), then fewest
        other-model host copies, then node id (the pre-arbiter order)."""
        warm = set(nd.node_id for nd in state.nodes
                   if model in nd.host_cache)
        free = [nd for nd in state.free_nodes() if nd not in set(exclude)]

        def rank(nd: int) -> Tuple:
            others = len(state.nodes[nd].host_cache.models() - {model})
            dist = min((abs(nd - f) for f in near), default=0)
            return (0 if nd in warm else 1, dist, others, nd)

        return sorted(free, key=rank)[:max(n, 0)]

    # --------------------------------------------------------- arbitration
    def arbitrate(self, requests: Dict[str, int], n_free: int,
                  pressure: Optional[Dict[str, float]] = None
                  ) -> Dict[str, int]:
        """Divide ``n_free`` nodes among models requesting scale-up.

        No contention (total asked ≤ free): everyone gets their full
        ask.  Under contention: proportional to SLO pressure (largest
        remainder, every pressured model keeps at least one node while
        supply lasts); with ``slo_weighted=False`` or all-zero pressure,
        first-come order (dict insertion order) takes what remains —
        the independent-scaling baseline."""
        asked = {m: max(n, 0) for m, n in requests.items()}
        total = sum(asked.values())
        if total <= n_free:
            return dict(asked)
        press = {m: (pressure or {}).get(m, 0.0) for m in asked}
        if not self.slo_weighted or all(p <= 0 for p in press.values()):
            grants, left = {}, n_free
            for m, n in asked.items():       # first-come (insertion order)
                grants[m] = min(n, left)
                left -= grants[m]
            return grants
        # proportional shares by pressure, largest-remainder rounding,
        # capped at each model's ask; leftover redistributes in pressure
        # order so no node idles while someone still wants one
        psum = sum(press.values())
        quota = {m: n_free * press[m] / psum for m in asked}
        grants = {m: min(asked[m], int(quota[m])) for m in asked}
        left = n_free - sum(grants.values())
        by_rem = sorted(asked, key=lambda m: (-(quota[m] - int(quota[m])),
                                              -press[m], m))
        while left > 0:                      # mop up rounding + cap slack
            gave = False
            for m in by_rem:
                if left <= 0:
                    break
                if grants[m] < asked[m]:
                    grants[m] += 1
                    left -= 1
                    gave = True
            if not gave:                     # everyone at their ask
                break
        return grants

    @staticmethod
    def up_order(models: Sequence[str],
                 pressure: Dict[str, float]) -> List[str]:
        """Execution order for granted scale-ups: highest SLO pressure
        first (stable for ties), so a low-pressure model acquiring a
        cold-start source can never consume nodes granted to a
        higher-pressure one."""
        return sorted(models, key=lambda m: -pressure.get(m, 0.0))

    # ----------------------------------------------------- handoff targets
    def handoff_target(self, locals_: Dict[int, object], *,
                       members: Sequence[int] = (),
                       ready: Optional[Callable[[int], bool]] = None,
                       exclude: Optional[int] = None,
                       near: Sequence[int] = ()):
        """The engine that adopts a drained instance's sequences, ranked
        by KV locality: member-node replicas (GPU: zero wire movement) >
        ready replicas (host: one link hop) > replicas still fetching
        (remote); within a tier, proximity to ``near`` (the feeding
        prefill nodes on the disagg wire; node-id distance is the
        rack-adjacency proxy, 0 when unset), then load, then node id.
        The node id is the FINAL key component, so candidates equal on
        every ranked axis resolve deterministically to the lowest node
        id — never dict-iteration order (locked by a unit test).
        Returns None when no candidate exists."""
        mem = set(members)
        best, best_key = None, None
        for nd, eng in locals_.items():
            if nd == exclude:
                continue
            if nd in mem:
                tier = 0
            elif ready is None or ready(nd):
                tier = 1
            else:
                tier = 2
            dist = min((abs(nd - f) for f in near), default=0)
            load = eng.sched.in_flight + eng.sched.pending
            key = (tier, dist, load, nd)
            if best_key is None or key < best_key:
                best, best_key = eng, key
        return best
