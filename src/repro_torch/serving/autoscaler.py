"""Reactive autoscaler: the closed loop driving λScale's mechanisms (§6).

The mechanisms — k-way multicast scale-up, execute-while-load
pipelines, mode switching, tiered scale-down — are exposed by
``LiveCluster.scale()`` and ``scale_down()``.  This module is the policy
that drives them: a reactive controller watching per-model load signals
(queue depth, slot utilization, recent TTFT against an SLO) and emitting
scale actions under cooldown and keep-alive rules.

The same ``Autoscaler`` instance drives BOTH runtimes:

* ``LiveCluster.replay(trace, autoscaler=...)`` — the live PyTorch runtime
  on its simulated clock (real tokens through the real engines);
* ``Simulator`` — the calibrated discrete-event simulator, where the
  autoscaler sizes the fleet and each ``baselines.py`` policy decides the
  *mechanism* (k-way multicast vs serial loading) used to provision it.

The controller is deliberately runtime-agnostic: it sees ``LoadSignals``
and returns ``ScaleUp``/``ScaleDown`` actions; it never touches engines,
instances, or node state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.serving.metrics import percentile

DEFAULT_MAX_K = 4


# ----------------------------------------------------------------- signals
@dataclasses.dataclass
class LoadSignals:
    """One model's load as observed by the runtime at decision time.

    A disaggregated model reports one signal PER POOL (``role`` set to
    ``"prefill"`` or ``"decode"``) instead of one aggregate: the runtime
    attaches each pool's own queue/slots/idle view plus the latency the
    pool owns — TTFT rides the prefill signal, inter-token latency the
    decode signal — so the controller sizes the two pools independently
    with the same trigger vocabulary.  ``role=None`` (the default) is
    the whole-model signal every non-disaggregated deployment emits,
    byte-identical to the pre-disagg behavior.
    """
    model: str
    queue_depth: int                 # requests with no slot anywhere
    slots_total: int                 # slots across live instances
    slots_busy: int                  # of which occupied
    nodes_busy: int                  # nodes committed (serving + scaling)
    slots_per_instance: int
    scaling_in_flight: bool = False  # a scale plan is mid-multicast
    n_replicas: int = 0              # standalone local replicas
    recent_ttft: Sequence[float] = ()    # TTFTs seen since last decision
    idle_nodes: Sequence[Tuple[int, float]] = ()  # (node, idle seconds)
    slo_pressure: float = 0.0        # MetricsLog.slo_pressure at decision
    recent_arrivals: int = 0         # arrivals since the last decision
    role: Optional[str] = None       # pool of a disaggregated model
    recent_itl: Sequence[float] = ()  # per-request mean inter-token gaps
    pages_total: int = 0             # KV page pool size (0 = not reported)
    pages_live: int = 0              # allocated pages across the pool
    recent_sheds: int = 0            # submits rejected since last decision
    # cold-start budgeting inputs (scale-to-zero): the model's replica
    # footprint and block count let the controller price a restore from
    # each tier against the per-model cold-start SLO when picking where
    # a scaled-to-zero replica parks (0 = not reported → host parking)
    model_nbytes: float = 0.0
    model_blocks: int = 0

    @property
    def utilization(self) -> float:
        return self.slots_busy / self.slots_total if self.slots_total \
            else float("inf" if self.queue_depth else 0)

    @property
    def page_utilization(self) -> float:
        """Live fraction of the KV page pool (0 when not reported):
        slot pressure can look fine while long prompts exhaust pages —
        this is the signal that sees it (``Scheduler.stats()``)."""
        return self.pages_live / self.pages_total if self.pages_total \
            else 0.0


# ----------------------------------------------------------------- actions
@dataclasses.dataclass(frozen=True)
class ScaleUp:
    model: str
    n_new: int
    k: int                           # multicast fan-out hint
    reason: str = ""
    role: Optional[str] = None       # pool the new replicas join


@dataclasses.dataclass(frozen=True)
class ScaleDown:
    model: str
    nodes: Tuple[int, ...]
    reason: str = ""
    role: Optional[str] = None       # pool the released nodes leave
    # where the released replica's blocks land: "host" (LRU fallback,
    # the pre-scale-to-zero behavior) or "ssd" (snapshot park — frees
    # the host slot, restore streams back through the loading pipeline)
    park: str = "host"


Action = Union[ScaleUp, ScaleDown]


# ------------------------------------------------------------------ config
@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    """Trigger thresholds and pacing rules.

    The defaults reproduce the simulator's original reactive sizing
    (scale when a queue exists, retire after ``keepalive`` idle seconds);
    the utilization/SLO triggers and cooldowns are opt-in knobs the
    closed-loop benchmark and live replay exercise.
    """
    headroom: int = 0                # extra nodes beyond measured demand
    util_high: float = math.inf      # slot utilization triggering +1 node
    ttft_slo: Optional[float] = None  # p95 TTFT target (seconds)
    cooldown_up: float = 0.0         # min seconds between scale-ups
    cooldown_down: float = 0.0       # min seconds between scale-downs
    keepalive: float = 5.0           # idle seconds before release (§2.3)
    max_k: int = DEFAULT_MAX_K       # multicast fan-out cap (§4.2)
    min_replicas: int = 0            # floor kept through idle periods
    max_nodes: Optional[int] = None  # per-model fleet cap
    # SLO-pressure trigger: +1 node while the priority-weighted deadline
    # urgency of waiting requests (LoadSignals.slo_pressure, fed from
    # MetricsLog) exceeds the threshold
    pressure_high: Optional[float] = None
    # inter-token latency trigger (decode pools of a disaggregated
    # model): +1 node while the recent p95 per-request ITL exceeds the
    # target — the decode-side analogue of ttft_slo, which a prefill
    # pool owns
    itl_slo: Optional[float] = None
    # page-pressure trigger: +1 node while the live fraction of the KV
    # page pool (LoadSignals via Scheduler.stats()) exceeds the
    # threshold — slot utilization alone cannot see long prompts
    # exhausting pages
    page_util_high: Optional[float] = None
    # overload trigger: +1 node while the shed fraction of the decision
    # window (sheds / arrivals) meets the threshold — shedding means
    # admission control is ALREADY turning work away, the strongest
    # possible demand signal (queue depth saturates once sheds start)
    shed_high: Optional[float] = None
    # predictive pre-warm (opt-in): Holt/EWMA short-horizon forecast of
    # the per-model arrival rate (fed from MetricsLog arrivals via
    # LoadSignals.recent_arrivals).  When the arrivals predicted over
    # the next ``forecast_horizon`` seconds exceed the currently-free
    # slot pool, scale up BEFORE the queue forms — replicas are ready at
    # burst onset instead of paying first-burst TTFT (ROADMAP item).
    forecast: bool = False
    forecast_alpha: float = 0.5      # EWMA smoothing for level and trend
    forecast_horizon: float = 2.0    # seconds of lookahead
    # per-model cold-start SLO budget (seconds from scale-up decision to
    # a servable replica).  With a HardwareProfile attached to the
    # controller, scale-to-zero parks each released replica in the
    # CHEAPEST tier whose restore still fits the budget (ssd < host in
    # $-terms; gpu = stay resident when nothing fits, which degenerates
    # to a min_replicas floor of 1).  None → park to host (legacy).
    coldstart_slo: Optional[float] = None


# -------------------------------------------------------------- controller
class Autoscaler:
    """Reactive closed-loop controller (queue / utilization / SLO)."""

    def __init__(self, config: Optional[AutoscalerConfig] = None,
                 hw=None):
        self.config = config or AutoscalerConfig()
        # optional HardwareProfile: prices tier restores against the
        # cold-start SLO budget (park_tier); None → host parking only
        self.hw = hw
        # pacing and forecast state key by (model, role): a
        # disaggregated model's prefill and decode pools pace and
        # forecast independently (role None = the whole-model signal)
        self._last_up: Dict[Tuple[str, Optional[str]], float] = {}
        self._last_down: Dict[Tuple[str, Optional[str]], float] = {}
        self.decisions: List[Tuple[float, Action]] = []
        # Holt/EWMA forecast state per pool: smoothed arrival rate
        # (req/s), its trend (req/s²), and the last observation time
        self._rate: Dict[Tuple[str, Optional[str]], float] = {}
        self._trend: Dict[Tuple[str, Optional[str]], float] = {}
        self._last_obs: Dict[Tuple[str, Optional[str]], float] = {}

    # ------------------------------------------------------------- policy
    def desired_new_nodes(self, sig: LoadSignals) -> Tuple[int, str]:
        """How many nodes the triggers ask for beyond the committed fleet.

        Queue trigger: enough instances to hold every queued request.
        Utilization trigger: one node of headroom when the slot pool is
        nearly saturated (requests are about to queue).
        TTFT-SLO trigger: one extra node while the recent p95 violates
        the target (tail pressure the queue depth alone may not show).
        """
        c = self.config
        demand = math.ceil(sig.queue_depth / sig.slots_per_instance)
        base = max(demand + c.headroom - sig.nodes_busy, 0)
        reason = "queue" if base > 0 else ""
        # the utilization / SLO boosts are INCREMENTAL headroom on top of
        # whatever fleet is already committed
        boost = 0
        if sig.slots_total > 0 and sig.utilization >= c.util_high:
            boost += 1
            reason = (reason + "+util").lstrip("+")
        if c.ttft_slo is not None and sig.recent_ttft and \
                percentile(sig.recent_ttft, 95) > c.ttft_slo:
            boost += 1
            reason = (reason + "+slo").lstrip("+")
        if c.pressure_high is not None and \
                sig.slo_pressure >= c.pressure_high:
            boost += 1
            reason = (reason + "+pressure").lstrip("+")
        if c.itl_slo is not None and sig.recent_itl and \
                percentile(sig.recent_itl, 95) > c.itl_slo:
            boost += 1
            reason = (reason + "+itl").lstrip("+")
        if c.page_util_high is not None and \
                sig.page_utilization >= c.page_util_high:
            boost += 1
            reason = (reason + "+pages").lstrip("+")
        if c.shed_high is not None and sig.recent_sheds > 0 and \
                sig.recent_sheds / max(sig.recent_arrivals, 1) \
                >= c.shed_high:
            boost += 1
            reason = (reason + "+shed").lstrip("+")
        n_new = base + boost
        if c.max_nodes is not None:
            n_new = min(n_new, c.max_nodes - sig.nodes_busy)
        return max(n_new, 0), reason

    # ------------------------------------------------------- pre-warming
    def _forecast_new_nodes(self, now: float, sig: LoadSignals
                            ) -> int:
        """Predictive pre-warm (opt-in): update the Holt/EWMA arrival-
        rate model from this decision window's arrivals and return the
        extra nodes needed so the arrivals predicted over the horizon
        fit the free slot pool.  Returns 0 while the forecast sees no
        shortfall — the reactive triggers still apply."""
        c = self.config
        m = (sig.model, sig.role)    # per-pool state for disagg models
        last = self._last_obs.get(m)
        self._last_obs[m] = now
        if last is None or now <= last:
            return 0
        dt = now - last
        r = sig.recent_arrivals / dt
        level = self._rate.get(m, r)
        trend = self._trend.get(m, 0.0)
        a = c.forecast_alpha
        new_level = a * r + (1 - a) * (level + trend * dt)
        self._trend[m] = a * (new_level - level) / dt + (1 - a) * trend
        self._rate[m] = new_level
        # predicted arrivals across the horizon (trend extrapolated,
        # clamped non-negative) vs the slots currently free
        h = c.forecast_horizon
        pred_rate = max(new_level + self._trend[m] * h, 0.0)
        pred_arrivals = 0.5 * (max(new_level, 0.0) + pred_rate) * h
        free = max(sig.slots_total - sig.slots_busy, 0)
        shortfall = pred_arrivals - free
        if shortfall <= 0:
            return 0
        return math.ceil(shortfall / sig.slots_per_instance)

    def decide(self, now: float,
               signals: Sequence[LoadSignals]) -> List[Action]:
        """One control-loop iteration: scale actions for each model."""
        c = self.config
        actions: List[Action] = []
        for sig in signals:
            m, key = sig.model, (sig.model, sig.role)
            n_new, reason = self.desired_new_nodes(sig)
            if c.forecast:
                fb = self._forecast_new_nodes(now, sig)
                if fb > n_new:               # forecast sees more demand
                    n_new = fb
                    reason = (reason + "+forecast").lstrip("+")
                if c.max_nodes is not None:
                    n_new = min(n_new, c.max_nodes - sig.nodes_busy)
            if n_new > 0 and not sig.scaling_in_flight:
                # cold start bypasses the cooldown: a model with zero
                # capacity and waiting requests cannot afford to pace —
                # nor can a forecast pre-warm FROM zero, whose whole
                # point is to beat the burst it predicts
                cold = sig.slots_total == 0 and \
                    (sig.queue_depth > 0 or "forecast" in reason)
                if cold or now - self._last_up.get(key, -math.inf) \
                        >= c.cooldown_up:
                    self._last_up[key] = now
                    actions.append(ScaleUp(m, n_new, c.max_k, reason,
                                           sig.role))
                continue
            # scale-down: idle past keep-alive, nothing queued, no scale
            # mid-flight (its nodes are about to become replicas), and
            # outside both cooldown windows
            if sig.queue_depth > 0 or sig.scaling_in_flight:
                continue
            if now - self._last_up.get(key, -math.inf) < c.cooldown_down:
                continue
            if now - self._last_down.get(key, -math.inf) < c.cooldown_down:
                continue
            idle = [nd for nd, idle_s in sig.idle_nodes
                    if idle_s >= c.keepalive]
            tier = self.park_tier(sig)
            floor = c.min_replicas if tier != "gpu" \
                else max(c.min_replicas, 1)
            n_down = min(len(idle), sig.n_replicas - floor)
            if n_down > 0:
                self._last_down[key] = now
                actions.append(ScaleDown(m, tuple(idle[:n_down]),
                                         "keepalive", sig.role,
                                         park=tier if tier != "gpu"
                                         else "host"))
        self.decisions.extend((now, a) for a in actions)
        return actions

    # -------------------------------------------------- cold-start budget
    def park_tier(self, sig: LoadSignals) -> str:
        """The cheapest tier a scaled-down replica of this model may park
        in while a later cold start still meets the per-model cold-start
        SLO budget.  Tier $-cost ordering is ssd < host < gpu; restore
        latency orders the other way, so this walks cheapest-first and
        returns the first tier whose pipelined restore fits the budget.
        Without a budget, a HardwareProfile, or a reported model size,
        parking stays on the host tier (the legacy keep-alive fallback).
        "gpu" means NO parkable tier fits — the replica must stay
        resident (an effective min_replicas floor of 1)."""
        c = self.config
        if c.coldstart_slo is None or self.hw is None \
                or sig.model_nbytes <= 0:
            return "host"
        n_chunks = max(sig.model_blocks, 1)
        for tier in ("ssd", "host"):
            plan = self.hw.restore_plan(sig.model_nbytes, n_chunks, tier)
            if plan.t_total <= c.coldstart_slo:
                return tier
        return "gpu"

    # --------------------------------------------------------- keep-alive
    def should_retire(self, now: float, last_active: float) -> bool:
        """Instance-level keep-alive check (the simulator's GC rule)."""
        return now - last_active > self.config.keepalive
