"""Shared serving metrics (paper §7: TTFT / E2E tails, GPU-seconds cost).

One metrics vocabulary for every runtime in the repo: the discrete-event
simulator, the live cluster's trace replay, and the autoscale benchmark
all record per-request timings into a ``MetricsLog`` and summarize them
the same way, so a λScale-vs-baseline comparison means the same thing
regardless of which runtime produced it.

Timestamps are *simulated-clock* seconds (the clock both runtimes share);
the log itself is runtime-agnostic — it never inspects engines or
instances, callers push observations in:

    log.on_arrival(rid, model, t, prompt_len)   # request enters the system
    log.on_first_token(rid, t)                  # TTFT endpoint
    log.on_finish(rid, t, out_tokens)           # E2E endpoint
    log.on_scale(t, kind, model, detail)        # scale-event audit trail
"""
from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence

if TYPE_CHECKING:                                    # pragma: no cover
    from repro_torch.serving.workload import SLOClass


def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (the paper reports p50/p95/p99 tails)."""
    ss = sorted(xs)
    if not ss:
        return float("nan")
    i = min(len(ss) - 1, max(0, int(math.ceil(q / 100 * len(ss))) - 1))
    return ss[i]


def slo_pressure_of(queue, now: float) -> float:
    """SLO pressure of a set of waiting requests (items exposing
    ``t_arrive`` and ``slo``): priority-weighted fraction of each TTFT
    deadline already consumed.  Classless requests contribute nothing —
    this is specifically the *SLO* pressure the placement arbiter and
    autoscaler weigh, not queue depth (signalled separately).  The ONE
    definition of the formula: ``MetricsLog.slo_pressure`` (live
    cluster) and the simulator's queue view both delegate here, so the
    two runtimes can never drift apart on arbitration weights."""
    p = 0.0
    for r in queue:
        slo = getattr(r, "slo", None)
        if slo is None:
            continue
        waited = max(now - r.t_arrive, 0.0)
        if math.isfinite(slo.ttft_deadline) and slo.ttft_deadline > 0:
            p += (1 + slo.priority) * waited / slo.ttft_deadline
    return p


@dataclasses.dataclass
class RequestMetric:
    """Per-request lifecycle timestamps on the simulated clock.

    The optional phase marks split the lifecycle into the three spans
    the disaggregation work needs to read honestly (and every runtime
    benefits from): ``t_start`` is when the request entered a prefill
    slot (queue wait ends), ``t_first_token`` when its prompt pass
    produced the first token (prefill ends), ``t_first_decode`` when a
    decode-capable instance first advanced it (on the disagg wire this
    is AFTER the PackedKV transfer and adoption), ``t_finish`` when
    generation completed (decode ends).  Runtimes that cannot observe a
    mark simply leave it None and the derived phase is None too.
    """
    req_id: int
    model: str
    t_arrive: float
    prompt_len: int = 0
    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None
    out_tokens: int = 0
    slo: Optional["SLOClass"] = None
    t_start: Optional[float] = None          # entered a prefill slot
    t_first_decode: Optional[float] = None   # first decode-phase tick
    t_shed: Optional[float] = None           # rejected under overload
    retry_after: float = 0.0                 # back-off hint at shed time

    @property
    def shed(self) -> bool:
        return self.t_shed is not None

    @property
    def ttft(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_arrive

    @property
    def met_slo(self) -> bool:
        """True iff the first token landed inside the class deadline.
        A request with no first token yet counts as a miss — a stuck
        request must not inflate attainment."""
        return (self.slo is not None and self.ttft is not None
                and self.ttft <= self.slo.ttft_deadline)

    @property
    def e2e(self) -> Optional[float]:
        if self.t_finish is None:
            return None
        return self.t_finish - self.t_arrive

    # ---------------------------------------------------- phase spans
    @property
    def queue_wait(self) -> Optional[float]:
        if self.t_start is None:
            return None
        return self.t_start - self.t_arrive

    @property
    def prefill_time(self) -> Optional[float]:
        if self.t_start is None or self.t_first_token is None:
            return None
        return self.t_first_token - self.t_start

    @property
    def decode_time(self) -> Optional[float]:
        if self.t_first_token is None or self.t_finish is None:
            return None
        return self.t_finish - self.t_first_token

    @property
    def ttfd(self) -> Optional[float]:
        """Time to first decode tick — on the disagg wire this includes
        the prefill → decode transfer and adoption the TTFT alone never
        shows."""
        if self.t_first_decode is None:
            return None
        return self.t_first_decode - self.t_arrive

    @property
    def itl(self) -> Optional[float]:
        """Mean inter-token latency across the request's decode phase
        (None until finished or with fewer than two tokens)."""
        dt = self.decode_time
        if dt is None or self.out_tokens < 2:
            return None
        return dt / (self.out_tokens - 1)


@dataclasses.dataclass
class ScaleEvent:
    """One autoscaler/runtime scaling action (the audit trail behind the
    cost numbers: when capacity appeared and when it was released)."""
    t: float
    kind: str               # up | down | switch | decision
    model: str
    detail: str = ""


@dataclasses.dataclass
class ColdStartEvent:
    """One cold (non-GPU-source) scale event's latency breakdown: where
    the startup time actually went — bytes moved (``fetch_seconds``,
    pipeline-overlapped when the loading engine is on) vs executables
    built (``compile_seconds``) — plus when the first replica became
    servable (``t_ready``) and the per-model budget it was judged
    against (``slo_budget``; None = unbudgeted)."""
    t: float                # when the scale was requested
    model: str
    tier: str               # source tier: host | ssd | remote | registry
    fetch_seconds: float
    compile_seconds: float
    t_ready: float          # first replica servable (absolute clock)
    slo_budget: Optional[float] = None

    @property
    def startup(self) -> float:
        return self.t_ready - self.t


class MetricsLog:
    """Accumulates per-request timings + scale events for one run."""

    def __init__(self) -> None:
        self.requests: Dict[int, RequestMetric] = {}
        self.scale_events: List[ScaleEvent] = []
        self.cold_starts: List[ColdStartEvent] = []
        self.gpu_seconds: float = 0.0
        # role → GPU-seconds burned by instances of that role ("unified"
        # when the runtime doesn't split pools).  Sums to gpu_seconds
        # when the runtime attributes every busy tick.
        self.gpu_seconds_by_role: Dict[str, float] = {}
        # overload-survival counters: preemptions executed, worst-case
        # pages those preemptions reclaimed, and whether any shed was
        # observed (gates the overload keys in summary() — a run that
        # never exercised the machinery emits none of them)
        self.preemptions: int = 0
        self.pages_reclaimed: int = 0
        self._shed_seen = False
        self._any_slo = False        # fast path for slo_pressure scans
        # classed requests not yet known to have a first token — the
        # working set slo_pressure scans (pruned lazily as first tokens
        # land, so the scan stays O(waiting), not O(all requests ever))
        self._open: Dict[str, set] = {}

    # ------------------------------------------------------- observations
    def on_arrival(self, req_id: int, model: str, t: float,
                   prompt_len: int = 0,
                   slo: Optional["SLOClass"] = None) -> None:
        self.requests[req_id] = RequestMetric(req_id, model, t, prompt_len,
                                              slo=slo)
        if slo is not None:
            self._any_slo = True
            self._open.setdefault(model, set()).add(req_id)

    def on_start(self, req_id: int, t: float) -> None:
        """Request entered a prefill slot (queue wait ends)."""
        m = self.requests[req_id]
        if m.t_start is None:
            m.t_start = t

    def on_first_token(self, req_id: int, t: float) -> None:
        m = self.requests[req_id]
        if m.t_first_token is None:
            m.t_first_token = t

    def on_first_decode(self, req_id: int, t: float) -> None:
        """First decode-phase tick on a decode-capable instance — on the
        disagg wire this trails on_first_token by the transfer+adopt."""
        m = self.requests[req_id]
        if m.t_first_decode is None:
            m.t_first_decode = t

    def on_gpu_time(self, role: str, seconds: float) -> None:
        """Attribute busy GPU time to a role pool (and the total)."""
        self.gpu_seconds += seconds
        self.gpu_seconds_by_role[role] = (
            self.gpu_seconds_by_role.get(role, 0.0) + seconds)

    def on_finish(self, req_id: int, t: float, out_tokens: int = 0) -> None:
        m = self.requests[req_id]
        if m.t_finish is None:
            m.t_finish = t
            m.out_tokens = out_tokens

    def on_scale(self, t: float, kind: str, model: str,
                 detail: str = "") -> None:
        self.scale_events.append(ScaleEvent(t, kind, model, detail))

    def on_cold_start(self, t: float, model: str, tier: str,
                      fetch_seconds: float, compile_seconds: float,
                      t_ready: float,
                      slo_budget: Optional[float] = None) -> None:
        """A scale-up had to materialize a replica from a non-GPU tier —
        record where the startup latency went (fetch vs compile)."""
        self.cold_starts.append(ColdStartEvent(
            t, model, tier, fetch_seconds, compile_seconds, t_ready,
            slo_budget))

    def on_preempt(self, t: float, model: str, req_id: int,
                   pages: int = 0) -> None:
        """A live slot was preempted (its sequence parked, ``pages``
        worst-case pages reclaimed for higher-class work)."""
        self.preemptions += 1
        self.pages_reclaimed += pages

    def on_shed(self, req_id: int, t: float,
                retry_after: float = 0.0) -> None:
        """The request was rejected under overload (first-write-wins,
        like the other marks).  A shed request never produces a first
        token, so it also leaves the slo_pressure working set — a
        rejected request must not keep weighing on placement."""
        self._shed_seen = True
        m = self.requests.get(req_id)
        if m is None or m.t_shed is not None:
            return
        m.t_shed = t
        m.retry_after = retry_after
        self._open.get(m.model, set()).discard(req_id)

    # ------------------------------------------------------------ queries
    def ttfts(self) -> List[float]:
        return [m.ttft for m in self.requests.values()
                if m.ttft is not None]

    def e2es(self) -> List[float]:
        return [m.e2e for m in self.requests.values() if m.e2e is not None]

    def ttft_percentile(self, q: float) -> float:
        return percentile(self.ttfts(), q)

    def e2e_percentile(self, q: float) -> float:
        return percentile(self.e2es(), q)

    def first_token_gap(self, e: ColdStartEvent) -> Optional[float]:
        """Seconds from the cold scale's request to the first token the
        model produced at-or-after it — what the cold start actually
        cost the first user; None when no such token was observed."""
        ts = [m.t_first_token for m in self.requests.values()
              if m.model == e.model and m.t_first_token is not None
              and m.t_first_token >= e.t]
        return min(ts) - e.t if ts else None

    def scale_ups(self) -> List[ScaleEvent]:
        return [e for e in self.scale_events if e.kind == "up"]

    def scale_downs(self) -> List[ScaleEvent]:
        return [e for e in self.scale_events if e.kind == "down"]

    @property
    def unfinished(self) -> List[int]:
        return [rid for rid, m in self.requests.items()
                if m.t_finish is None]

    # ------------------------------------------------- SLO-class queries
    def by_class(self) -> Dict[str, List[RequestMetric]]:
        """SLO class name → its requests (classless requests excluded)."""
        out: Dict[str, List[RequestMetric]] = {}
        for m in self.requests.values():
            if m.slo is not None:
                out.setdefault(m.slo.name, []).append(m)
        return out

    def slo_attainment(self, cls: Optional[str] = None) -> float:
        """Fraction of classed requests whose first token met their TTFT
        deadline (optionally restricted to one class); nan when the run
        carried no classed requests."""
        ms = [m for m in self.requests.values() if m.slo is not None
              and (cls is None or m.slo.name == cls)]
        if not ms:
            return float("nan")
        return sum(1 for m in ms if m.met_slo) / len(ms)

    def slo_pressure(self, model: str, now: float) -> float:
        """Priority-weighted deadline urgency of ``model``'s requests
        that have arrived but seen no first token by ``now`` — the
        weight the ``PlacementArbiter`` divides contended free nodes by
        and an optional autoscaler trigger.  Delegates to
        ``slo_pressure_of`` (one formula for both runtimes) over the
        ``_open`` working set, pruning requests whose first token has
        landed by ``now`` (monotone control clocks make the prune
        final; a request served in the future stays until then)."""
        open_ids = self._open.get(model)
        if not open_ids:
            return 0.0
        served = [rid for rid in open_ids
                  if (m := self.requests[rid]).t_first_token is not None
                  and m.t_first_token <= now]
        open_ids.difference_update(served)
        waiting = [m for rid in open_ids
                   if (m := self.requests[rid]).t_arrive <= now]
        return slo_pressure_of(waiting, now)

    def summary(self) -> Dict[str, float]:
        """The comparison row every runtime reports (BENCH_autoscale).
        Runs with classed requests additionally report per-class SLO
        attainment and per-class TTFT p99 (``BENCH_slo``)."""
        ttfts = self.ttfts()
        out = {
            "n_requests": len(self.requests),
            "n_finished": len(self.requests) - len(self.unfinished),
            "ttft_mean": sum(ttfts) / len(ttfts) if ttfts else float("nan"),
            "ttft_p50": percentile(ttfts, 50),
            "ttft_p95": percentile(ttfts, 95),
            "ttft_p99": percentile(ttfts, 99),
            "e2e_p50": self.e2e_percentile(50),
            "e2e_p99": self.e2e_percentile(99),
            "gpu_seconds": self.gpu_seconds,
            "scale_ups": float(len(self.scale_ups())),
            "scale_downs": float(len(self.scale_downs())),
        }
        # phase breakdown + disagg metrics — emitted only when the
        # runtime observed the underlying marks (tail keys on a run with
        # zero observations would be NaN, and bench diffs treat a NaN
        # tail as a hard failure)
        for key, xs in (
            ("queue_wait", [m.queue_wait for m in self.requests.values()
                            if m.queue_wait is not None]),
            ("prefill_time", [m.prefill_time for m in self.requests.values()
                              if m.prefill_time is not None]),
            ("decode_time", [m.decode_time for m in self.requests.values()
                             if m.decode_time is not None]),
            ("ttfd", [m.ttfd for m in self.requests.values()
                      if m.ttfd is not None]),
        ):
            if xs:
                out[f"{key}_p50"] = percentile(xs, 50)
                out[f"{key}_p99"] = percentile(xs, 99)
        itls = [m.itl for m in self.requests.values() if m.itl is not None]
        if itls:
            out["itl_p50"] = percentile(itls, 50)
            out["itl_p99"] = percentile(itls, 99)
        for role, secs in sorted(self.gpu_seconds_by_role.items()):
            out[f"gpu_seconds_{role}"] = secs
        # overload-survival counters ride the same NaN-gate convention:
        # emitted only when the machinery was actually exercised, so
        # runs without it keep byte-identical summaries
        overloaded = bool(self.preemptions or self._shed_seen)
        if overloaded:
            out["preemptions"] = float(self.preemptions)
            out["pages_reclaimed"] = float(self.pages_reclaimed)
            out["n_shed"] = float(sum(
                1 for m in self.requests.values() if m.shed))
        # cold-start breakdown: emitted only when a cold (non-GPU-tier)
        # scale actually happened — same NaN-gate convention as above
        if self.cold_starts:
            out["cold_starts"] = float(len(self.cold_starts))
            out["cold_fetch_seconds_mean"] = (
                sum(e.fetch_seconds for e in self.cold_starts)
                / len(self.cold_starts))
            out["cold_compile_seconds_mean"] = (
                sum(e.compile_seconds for e in self.cold_starts)
                / len(self.cold_starts))
            gaps = [g for g in (self.first_token_gap(e)
                                for e in self.cold_starts)
                    if g is not None]
            if gaps:
                out["cold_first_token_gap_p50"] = percentile(gaps, 50)
                out["cold_first_token_gap_p99"] = percentile(gaps, 99)
            budgeted = [e for e in self.cold_starts
                        if e.slo_budget is not None]
            if budgeted:
                out["cold_start_slo_miss"] = float(sum(
                    1 for e in budgeted if e.startup > e.slo_budget))
        classed = self.by_class()
        if classed:
            out["slo_attainment"] = self.slo_attainment()
            for name, ms in sorted(classed.items()):
                out[f"slo_attainment_{name}"] = self.slo_attainment(name)
                out[f"ttft_p99_{name}"] = percentile(
                    [m.ttft for m in ms if m.ttft is not None], 99)
                if overloaded:
                    # goodput = completion fraction (arrivals that
                    # finished); distinct from slo_attainment, which
                    # judges timeliness of the ones that got served
                    out[f"goodput_{name}"] = sum(
                        1 for m in ms if m.t_finish is not None) / len(ms)
                    out[f"shed_frac_{name}"] = sum(
                        1 for m in ms if m.shed) / len(ms)
        return out


def merge(logs: Sequence[MetricsLog]) -> MetricsLog:
    """Combine per-shard logs (req_ids must be globally unique)."""
    out = MetricsLog()
    for lg in logs:
        overlap = set(out.requests) & set(lg.requests)
        assert not overlap, f"duplicate req_ids across logs: {overlap}"
        out.requests.update(lg.requests)
        out.scale_events.extend(lg.scale_events)
        out.cold_starts.extend(lg.cold_starts)
        out.gpu_seconds += lg.gpu_seconds
        for role, secs in lg.gpu_seconds_by_role.items():
            out.gpu_seconds_by_role[role] = (
                out.gpu_seconds_by_role.get(role, 0.0) + secs)
        out.preemptions += lg.preemptions
        out.pages_reclaimed += lg.pages_reclaimed
        out._shed_seen = out._shed_seen or lg._shed_seen
        out._any_slo = out._any_slo or lg._any_slo
        for model, ids in lg._open.items():
            out._open.setdefault(model, set()).update(ids)
    out.scale_events.sort(key=lambda e: e.t)
    out.cold_starts.sort(key=lambda e: e.t)
    return out
