"""Workload generation: bursty request traces in the shape of the paper's
Fig 1 (Alibaba serverless inference + BurstGPT [48] Azure GPT traces).

Every request can carry an ``SLOClass`` — a TTFT deadline plus a
priority — the unit of the request control plane: admission policies
(``serving.scheduler``) order queues by it, the placement arbiter
(``serving.placement``) weighs scaling contention by it, and the metrics
layer (``serving.metrics``) reports per-class SLO attainment.  DeepServe
(arXiv:2501.14417) attaches exactly this kind of per-request class in
production; traces here emit mixed-class streams via ``slo_mix`` /
``assign_slo``.

All generators are deterministic given a seed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np


# --------------------------------------------------------------- SLO classes
@dataclasses.dataclass(frozen=True)
class SLOClass:
    """A request service class: TTFT deadline (seconds on the runtime's
    simulated clock) + scheduling priority (higher = more urgent).  The
    deadline is what EDF admission orders by and what per-class SLO
    attainment is measured against; the priority is what strict-priority
    admission and the placement arbiter's pressure weighting use."""
    name: str
    ttft_deadline: float
    priority: int = 0

    def scaled(self, factor: float) -> "SLOClass":
        """Same class with the deadline scaled — live-replay scenarios
        run on millisecond clocks where the wall-clock-shaped defaults
        would never bind."""
        return dataclasses.replace(
            self, ttft_deadline=self.ttft_deadline * factor)


INTERACTIVE = SLOClass("interactive", ttft_deadline=1.0, priority=2)
STANDARD = SLOClass("standard", ttft_deadline=5.0, priority=1)
BATCH = SLOClass("batch", ttft_deadline=30.0, priority=0)
SLO_CLASSES = {c.name: c for c in (INTERACTIVE, STANDARD, BATCH)}


@dataclasses.dataclass(frozen=True)
class Request:
    req_id: int
    model: str
    t_arrive: float
    prompt_len: int
    out_tokens: int
    slo: Optional[SLOClass] = None
    # multi-tenant prefix sharing: requests of one tenant open with the
    # same prompt prefix (system prompt / RAG context) — None = no tenant
    tenant: Optional[int] = None
    # health-check/probe traffic: served like any request when a replica
    # exists, but NOT activity — a probe must never reset keep-alive or
    # hold a model out of scale-to-zero (zepfu SCALE_TO_ZERO pattern)
    probe: bool = False

    @property
    def deadline(self) -> float:
        """Absolute TTFT deadline (inf when the request carries no SLO)."""
        if self.slo is None:
            return math.inf
        return self.t_arrive + self.slo.ttft_deadline


def assign_slo(reqs: Sequence[Request],
               slo_mix: Sequence[Tuple[SLOClass, float]], *,
               seed: int = 0) -> List[Request]:
    """Stamp each request with a class drawn from weighted ``slo_mix``
    (deterministic given the seed) — the mixed-class stream the control
    plane schedules."""
    rng = np.random.default_rng(seed)
    classes = [c for c, _ in slo_mix]
    w = np.asarray([p for _, p in slo_mix], dtype=float)
    w = w / w.sum()
    picks = rng.choice(len(classes), size=len(reqs), p=w)
    return [dataclasses.replace(r, slo=classes[int(i)])
            for r, i in zip(reqs, picks)]


def _poisson_arrivals(rate_fn, duration: float, rng, dt: float = 0.05
                      ) -> List[float]:
    """Thinned non-homogeneous Poisson process."""
    ts: List[float] = []
    t = 0.0
    rmax = max(rate_fn(x) for x in np.arange(0, duration, dt)) + 1e-9
    while t < duration:
        t += rng.exponential(1.0 / rmax)
        if t < duration and rng.random() < rate_fn(t) / rmax:
            ts.append(t)
    return ts


def bursty_rate(t: float, *, base: float, spikes: Sequence[tuple]) -> float:
    """base rps plus gaussian-shaped spikes: (center, width, height)."""
    r = base
    for c, w, h in spikes:
        r += h * math.exp(-0.5 * ((t - c) / w) ** 2)
    return r


def burstgpt_like(duration: float = 1800.0, *, model: str = "llama2-13b",
                  base_rps: float = 1.0, seed: int = 0,
                  spikes: Optional[Sequence[tuple]] = None,
                  prompt_len: int = 512, out_tokens: int = 32,
                  slo: Optional[SLOClass] = None,
                  slo_mix: Optional[Sequence[Tuple[SLOClass, float]]] = None,
                  ) -> List[Request]:
    """30-minute bursty snippet in the shape of BurstGPT (paper §7.5):
    order-of-magnitude spikes over a low base rate.  ``slo`` stamps every
    request with one class; ``slo_mix`` draws weighted mixed classes."""
    rng = np.random.default_rng(seed)
    if spikes is None:
        spikes = [(200, 18, 12 * base_rps), (420, 10, 25 * base_rps),
                  (700, 30, 8 * base_rps), (1000, 12, 30 * base_rps),
                  (1250, 20, 15 * base_rps), (1500, 8, 22 * base_rps)]
    ts = _poisson_arrivals(
        lambda t: bursty_rate(t, base=base_rps, spikes=spikes),
        duration, rng)
    reqs = []
    for i, t in enumerate(ts):
        pl = int(rng.integers(max(8, prompt_len // 2), prompt_len * 2))
        ot = int(rng.integers(max(4, out_tokens // 2), out_tokens * 2))
        reqs.append(Request(i, model, float(t), pl, ot, slo=slo))
    if slo_mix is not None:
        reqs = assign_slo(reqs, slo_mix, seed=seed + 1)
    return reqs


def constant_stress(rps: float, duration: float, *, model: str,
                    prompt_len: int = 512, out_tokens: int = 16,
                    seed: int = 0, slo: Optional[SLOClass] = None,
                    slo_mix: Optional[Sequence[Tuple[SLOClass, float]]] = None,
                    ) -> List[Request]:
    """Paper §7.3/§7.4 stress test: a burst of concurrent requests."""
    rng = np.random.default_rng(seed)
    ts = _poisson_arrivals(lambda t: rps, duration, rng)
    reqs = [Request(i, model, float(t), prompt_len, out_tokens, slo=slo)
            for i, t in enumerate(ts)]
    if slo_mix is not None:
        reqs = assign_slo(reqs, slo_mix, seed=seed + 1)
    return reqs


def overload_trace(*, model: str, capacity_rps: float,
                   overload: float = 3.0, duration: float = 10.0,
                   warmup: float = 0.0, prompt_len: int = 16,
                   out_tokens: int = 8, seed: int = 0,
                   mix: Optional[Sequence[Tuple[SLOClass, float]]] = None,
                   ) -> List[Request]:
    """Sustained mixed-class overload (the degradation-order scenario):
    arrivals at ``capacity_rps`` during ``warmup`` seconds, then a step
    to ``overload × capacity_rps`` held for the rest of ``duration`` —
    no spike shape, no relief, so no amount of scale-out arrives in
    time and who-keeps-decoding / who-parks / who-sheds IS the outcome.
    ``mix`` defaults to a 30/30/40 interactive/standard/batch split."""
    if mix is None:
        mix = ((INTERACTIVE, 0.3), (STANDARD, 0.3), (BATCH, 0.4))
    rng = np.random.default_rng(seed)
    rate = lambda t: capacity_rps if t < warmup \
        else overload * capacity_rps                          # noqa: E731
    ts = _poisson_arrivals(rate, duration, rng)
    reqs = [Request(i, model, float(t), prompt_len, out_tokens)
            for i, t in enumerate(ts)]
    return assign_slo(reqs, mix, seed=seed + 1)


# ----------------------------------------------------- shared-prefix traces
def make_shared_prefix_prompts(vocab_size: int, *, prefix_len: int,
                               kind: str = "chat", n_docs: int = 3,
                               seed: int = 0):
    """Deterministic token-level ``prompt_fn`` for shared-prefix traces.

    Every tenant owns one fixed ``prefix_len``-token prefix (its system
    prompt).  kind="chat" appends a per-request suffix directly;
    kind="rag" inserts one of the tenant's ``n_docs`` cached documents
    (``prefix_len // 2`` tokens each, chosen deterministically per
    request) between prefix and suffix — two levels of shareable
    prefix.  Suffix length is whatever ``req.prompt_len`` leaves over."""
    def prompt_fn(req: Request) -> List[int]:
        tenant = req.tenant or 0
        rng = np.random.default_rng((seed, 17, tenant))
        toks = list(map(int, rng.integers(0, vocab_size, size=prefix_len)))
        if kind == "rag":
            doc = req.req_id % n_docs
            drng = np.random.default_rng((seed, 23, tenant, doc))
            toks += list(map(int, drng.integers(0, vocab_size,
                                                size=prefix_len // 2)))
        tail = max(1, req.prompt_len - len(toks))
        trng = np.random.default_rng((seed, 29, req.req_id))
        toks += list(map(int, trng.integers(0, vocab_size, size=tail)))
        return toks
    return prompt_fn


def shared_prefix_workload(rps: float, duration: float, *, model: str,
                           vocab_size: int, n_tenants: int = 4,
                           prefix_len: int = 256, suffix_len: int = 32,
                           out_tokens: int = 16, kind: str = "chat",
                           n_docs: int = 3, seed: int = 0,
                           slo: Optional[SLOClass] = None,
                           slo_mix: Optional[Sequence[Tuple[SLOClass, float]]]
                           = None) -> Tuple[List[Request], "callable"]:
    """Multi-tenant shared-prefix stream → (requests, prompt_fn).

    Poisson arrivals over ``n_tenants`` tenants; each request's prompt
    opens with its tenant's fixed prefix (plus, for kind="rag", one of
    the tenant's cached documents) and ends in a private suffix of
    1..``suffix_len`` tokens — the multi-tenant reuse pattern a
    prefix-sharing engine prefills once per tenant instead of once per
    request.  ``prompt_fn`` reproduces the exact token ids for
    ``LiveCluster.replay(prompt_fn=...)`` or direct engine submission."""
    if kind not in ("chat", "rag"):
        raise ValueError(f"unknown shared-prefix kind: {kind!r}")
    rng = np.random.default_rng(seed)
    ts = _poisson_arrivals(lambda t: rps, duration, rng)
    shared = prefix_len + (prefix_len // 2 if kind == "rag" else 0)
    reqs = []
    for i, t in enumerate(ts):
        tenant = int(rng.integers(n_tenants))
        sfx = int(rng.integers(max(1, suffix_len // 2), suffix_len + 1))
        reqs.append(Request(i, model, float(t), shared + sfx, out_tokens,
                            slo=slo, tenant=tenant))
    if slo_mix is not None:
        reqs = assign_slo(reqs, slo_mix, seed=seed + 1)
    prompt_fn = make_shared_prefix_prompts(
        vocab_size, prefix_len=prefix_len, kind=kind, n_docs=n_docs,
        seed=seed)
    return reqs, prompt_fn


def probe_trace(model: str, *, period: float, duration: float,
                start: float = 0.0, prompt_len: int = 1,
                out_tokens: int = 1, req_id0: int = 10_000_000
                ) -> List[Request]:
    """Deterministic health-check stream: one tiny probe every ``period``
    seconds.  Probes carry ``probe=True`` so the runtime answers them
    without counting them as activity — the regression scenario for the
    liveness/activity split is exactly this trace against an otherwise
    idle model, which must still scale to zero."""
    reqs = []
    t, i = start, 0
    while t < duration:
        reqs.append(Request(req_id0 + i, model, float(t), prompt_len,
                            out_tokens, probe=True))
        i += 1
        t += period
    return reqs


def diurnal_trace(n_models: int, duration: float, *, n_hot: int = 4,
                  hot_rpm: float = 30.0, cold_rpm: float = 0.5,
                  day: float = 0.0, seed: int = 0,
                  prompt_len: int = 256, out_tokens: int = 16,
                  slo: Optional[SLOClass] = None,
                  slo_mix: Optional[Sequence[Tuple[SLOClass, float]]] = None
                  ) -> List[Request]:
    """Diurnal many-model registry trace (the scale-to-zero headline
    scenario): ``n_models`` registered, only ``n_hot`` of them hot.  Hot
    models arrive at ``hot_rpm``; the long tail at ``cold_rpm`` — most
    tail models see a handful of requests separated by minutes of
    silence, which is where keep-alive either burns GPU-seconds or
    scale-to-zero eats a cold start.  ``day`` > 0 modulates both rates
    sinusoidally with that period (trough = 20% of peak); 0 disables
    the modulation (short benches).  Deterministic given the seed."""
    rng = np.random.default_rng(seed)
    shape = (lambda t: 0.6 + 0.4 * math.sin(2 * math.pi * t / day)) \
        if day > 0 else (lambda t: 1.0)
    reqs = []
    rid = 0
    for m in range(n_models):
        rpm = hot_rpm if m < n_hot else cold_rpm
        ts = _poisson_arrivals(lambda t: shape(t) * rpm / 60.0,
                               duration, rng)
        for t in ts:
            reqs.append(Request(rid, f"model-{m:03d}", float(t),
                                prompt_len, out_tokens, slo=slo))
            rid += 1
    reqs.sort(key=lambda r: r.t_arrive)
    reqs = [dataclasses.replace(r, req_id=i) for i, r in enumerate(reqs)]
    if slo_mix is not None:
        reqs = assign_slo(reqs, slo_mix, seed=seed + 1)
    return reqs


def multi_model_trace(n_models: int, per_model_rpm: float, duration: float,
                      *, seed: int = 0, prompt_len: int = 256,
                      out_tokens: int = 16, periodic: bool = False,
                      slo_mix: Optional[Sequence[Tuple[SLOClass, float]]]
                      = None) -> List[Request]:
    """Paper §2.3 setting: many models, ~1 request/min each (Fig 2/3).

    periodic=True reproduces the paper's deterministic rate (staggered
    arrivals, exactly per_model_rpm each); False draws Poisson arrivals."""
    rng = np.random.default_rng(seed)
    period = 60.0 / per_model_rpm
    reqs = []
    rid = 0
    for m in range(n_models):
        # periodic: the FIRST arrival lands at the stagger offset
        # m·period/n_models itself (advancing before the first emit would
        # silence every model for a whole period and emit one fewer
        # request than per_model_rpm × duration promises)
        t = m * period / n_models if periodic else rng.exponential(period)
        while t < duration:
            reqs.append(Request(rid, f"model-{m:02d}", t, prompt_len,
                                out_tokens))
            rid += 1
            t += period if periodic else rng.exponential(period)
    reqs.sort(key=lambda r: r.t_arrive)
    reqs = [dataclasses.replace(r, req_id=i) for i, r in enumerate(reqs)]
    if slo_mix is not None:
        reqs = assign_slo(reqs, slo_mix, seed=seed + 1)
    return reqs
