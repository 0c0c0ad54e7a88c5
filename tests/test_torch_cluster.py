"""The port's live cluster (``repro_torch.serving.cluster.LiveCluster``)
against the JAX package's, on the same weights.

Each case runs one scenario, written once, through both packages'
``LiveCluster`` with the reduced ``qwen2.5-3b`` (4 layers) and
``stablelm-1.6b`` (2 layers) at ``d_model`` 64 in fp32, the port's
weights carried across by ``repro_torch.bridge.params_from_jax``, both
clusters on the paper's ``H800`` profile.  Required: registry bytes
equal; ``forward()`` logits within TOL of JAX's at every multicast step
in the same modes; identical greedy tokens from ``results()``; and
identical scale reports, handoff, audit and coldstart logs, scale events
and ``MetricsLog.summary()`` (``_norm`` compares each package's objects
field by field).  The scenarios mirror the cluster cases of
``test_tiered_runtime``, ``test_live_cluster``, ``test_autoscaler``,
``test_coldstart``, ``test_disagg`` and ``test_overload``, one for each
path of ``cluster.py``: two-model scale + serve with pipeline handoffs,
the autoscaled replay from zero replicas with keep-alive scale-down and
a host-tier rescale, the SSD park and cold restore, probes answered at
the control plane, disaggregated pools, and preemption with
park/resume, shedding and park timeouts.  The persistent compile cache
is not ported, and refused (``test_compile_cache_refused``).
"""
import dataclasses
import math
import types
import weakref

import jax
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import get_config, reduced
from repro.serving import autoscaler as jauto
from repro.serving import scheduler as jsched
from repro.serving import tiers as jtiers
from repro.serving import workload as jwork
from repro.serving.cluster import LiveCluster as JaxCluster
from repro_torch import configs as pconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.serving import autoscaler as tauto
from repro_torch.serving import scheduler as tsched
from repro_torch.serving import tiers as ttiers
from repro_torch.serving import workload as twork
from repro_torch.serving.cluster import LiveCluster

MAX_LEN = 48
TOL = 1e-4
ARCHS = {"A": ("qwen2.5-3b", 4, 0), "B": ("stablelm-1.6b", 2, 1)}
_CTX = {}


def _ctx(m):
    if m not in _CTX:
        arch, n_layers, seed = ARCHS[m]
        cfg = reduced(get_config(arch), d_model=64, n_layers=n_layers)
        pcfg = pconfigs.reduced(pconfigs.get_config(arch), d_model=64,
                                n_layers=n_layers)
        jp = jm.init_params(cfg, jax.random.PRNGKey(seed))
        _CTX[m] = dict(cfg=cfg, pcfg=pcfg, jp=jp,
                       tp=params_from_jax(pcfg, jax.device_get(jp),
                                          device="cpu"))
    return _CTX[m]


def _side(is_jax):
    """One package's cluster class, models and control-plane modules, so
    a scenario is written once for both."""
    def model(m):
        c = _ctx(m)
        return (c["cfg"], c["jp"]) if is_jax else (c["pcfg"], c["tp"])

    def cluster(**kw):
        kw.setdefault("max_len", MAX_LEN)
        if is_jax:
            return JaxCluster(hw=jtiers.H800, **kw)
        return LiveCluster(hw=ttiers.HardwareProfile(), device="cpu", **kw)
    return types.SimpleNamespace(
        jax=is_jax, model=model, cluster=cluster,
        auto=jauto if is_jax else tauto,
        sched=jsched if is_jax else tsched,
        work=jwork if is_jax else twork)


def _norm(x):
    """Plain, package-free value of ``x`` for an exact comparison."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                [(f.name, _norm(getattr(x, f.name)))
                 for f in dataclasses.fields(x)])
    if isinstance(x, dict):
        return ("dict", [(_norm(k), _norm(v)) for k, v in x.items()])
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, np.generic):
        return _norm(x.item())
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x


def _both(scenario):
    """Run ``scenario(side)`` on both packages: "logits" lists are held
    within TOL, everything else must be equal."""
    want, got = scenario(_side(True)), scenario(_side(False))
    assert got.keys() == want.keys()
    for key in got:
        if key == "logits":
            assert len(got[key]) == len(want[key])
            for g, w in zip(got[key], want[key]):
                g, w = g.numpy(), np.asarray(w)
                assert g.shape == w.shape
                assert float(np.max(np.abs(g - w))) < TOL
        else:
            assert _norm(got[key]) == _norm(want[key]), key
    return got


def _prompt(rng, m, n):
    return list(map(int, rng.integers(0, _ctx(m)["cfg"].vocab_size, n)))


def _served(lc, models):
    """What every scenario compares after serving: tokens per request,
    the pricing and overload logs, and each engine's stats."""
    return {
        "results": {m: dict(sorted(lc.results(m).items())) for m in models},
        "handoff": lc.handoff_log, "audit": lc.audit_log,
        "coldstart": lc.coldstart_log, "clock": lc.clock,
        "stats": {m: ({nd: e.stats for nd, e in sorted(
                          lc.serving[m].locals_.items())},
                      {nd: e.stats for nd, e in sorted(
                          lc.serving[m].prefills.items())},
                      [p.engine.stats for p in lc.serving[m].pipes])
                  for m in models}}


# ------------------------------------------------------------ register
@pytest.mark.parametrize("m", ["A", "B"])
def test_register_registry_bytes_equal(m):
    """``pack_model`` through ``register``: the same wire bytes, specs and
    block assignment; GPU-tier tensors unpacked bit-equal to the
    weights; host-tier warm copies placed by the arbiter alike."""
    def scenario(side):
        lc = side.cluster(n_nodes=4)
        dep = lc.register("m", *side.model(m), n_blocks=3, hot_nodes=[1],
                          warm_copies=2)
        flat = lc.nodes[1].gpu_shard("m").flat
        return {"registry": dep.registry.tobytes(), "specs": dep.specs,
                "assign": dep.assign, "nbytes": dep.nbytes,
                "warm": lc._host_payload_nodes("m"),
                "flat": {k: np.asarray(v).tobytes() if side.jax
                         else v.numpy().tobytes()
                         for k, v in sorted(flat.items())}}
    got = _both(scenario)
    assert len(got["registry"]) > 0 and len(got["warm"]) == 2


# ------------------------------------------------------------- forward
@pytest.mark.parametrize("k,n", [(1, 4), (2, 5)])
def test_forward_at_every_multicast_step(k, n):
    """``forward()`` at every schedule step, pipeline mode while the
    multicast runs and local mode once it completes: the same modes and
    nodes as JAX, logits within TOL (mirrors test_live_cluster's
    ``test_serve_correct_at_every_step``)."""
    tokens = np.random.default_rng(7).integers(
        0, _ctx("A")["cfg"].vocab_size, (2, 24))

    def scenario(side):
        lc = side.cluster(n_nodes=n)
        lc.register("m", *side.model("A"), n_blocks=4,
                    hot_nodes=list(range(k)))
        lc.scale("m", n - k, k=k)
        modes, logits = [], []
        while True:
            r = lc.forward("m", tokens if side.jax
                           else torch.from_numpy(tokens))
            modes.append((r["mode"], r.get("node"), r.get("nodes")))
            logits.append(r["logits"])
            if not lc.step():
                break
        return {"modes": modes, "logits": logits,
                "complete": lc.complete_nodes("m")}
    got = _both(scenario)
    kinds = [mode for mode, _, _ in got["modes"]]
    assert "pipeline" in kinds and kinds[-1] == "local"
    assert len(got["complete"]) == n


# ------------------------------------------------- two models, serving
def test_two_model_scale_and_serve_equal():
    """Model A hot on two sources scales k=2 to four more nodes while
    model B scales from a host-warm copy; a 12-request burst is served
    through pipelines mid-multicast and handed off to local replicas
    (mirrors test_tiered_runtime's two-model acceptance case)."""
    def scenario(side):
        lc = side.cluster(n_nodes=8, n_slots=2)
        lc.register("A", *side.model("A"), n_blocks=4, hot_nodes=[0, 1])
        lc.register("B", *side.model("B"), n_blocks=4, warm_nodes=[6])
        reports = [lc.scale("A", 4, k=2), lc.scale("B", 1)]
        rng = np.random.default_rng(3)
        for i in range(12):
            m = "A" if i % 2 == 0 else "B"
            lc.submit(m, _prompt(rng, m, int(rng.choice([5, 8]))),
                      int(rng.integers(3, 7)))
        while lc.step():
            lc.tick()
        lc.drain_serving()
        return {"reports": reports, **_served(lc, "AB"),
                "complete": [lc.complete_nodes(m) for m in "AB"]}
    got = _both(scenario)
    assert [r.source_tier for r in got["reports"]] == ["gpu", "host"]
    adopted = sum(s["adopted"] for m in "AB"
                  for s in got["stats"][m][0].values())
    assert adopted >= 1
    assert any(d.chosen == "recompute" for d in got["handoff"])
    assert sum(len(v) for v in got["results"].values()) == 12


# ------------------------------------------------ autoscaled replay
def test_autoscaled_replay_from_zero_then_host_rescale_equal():
    """The closed loop from zero replicas: a host-warm model scales up
    under the autoscaler, serves the trace, scales down to the host tier
    after its keep-alive, then a second burst rescales it from that host
    copy (mirrors test_autoscaler's closed-loop cases)."""
    def scenario(side):
        lc = side.cluster(n_nodes=4, n_slots=2)
        lc.register("m", *side.model("A"), n_blocks=2, warm_nodes=[0])
        asc = side.auto.Autoscaler(side.auto.AutoscalerConfig(
            cooldown_up=0.05, cooldown_down=0.02, keepalive=0.1,
            min_replicas=0, max_k=2))
        rng = np.random.default_rng(0)
        Req = side.work.Request
        first = [Req(i, "m", 0.01 + 0.002 * i, int(rng.integers(4, 8)),
                     int(rng.integers(3, 6))) for i in range(8)]
        log1 = lc.replay(first, autoscaler=asc, tick_seconds=0.002,
                         tail_seconds=0.3)
        zero = (sorted(lc.serving["m"].locals_),
                lc._host_payload_nodes("m"))
        t0 = lc.clock + 0.01
        second = [Req(100 + i, "m", t0 + 0.002 * i, 6, 4)
                  for i in range(4)]
        log2 = lc.replay(second, autoscaler=asc, tail_seconds=0.1)
        return {"summary": [log1.summary(), log2.summary()],
                "events": [log1.scale_events, log2.scale_events],
                "ttft": [log1.ttfts(), log2.ttfts()], "zero": zero,
                "decisions": asc.decisions, **_served(lc, "m")}
    got = _both(scenario)
    s1, s2 = got["summary"]
    assert s1["n_finished"] == 8 and s2["n_finished"] == 4
    assert s1["scale_ups"] >= 1 and s1["scale_downs"] >= 1
    assert got["zero"][0] == [] and got["zero"][1]
    assert any("tier=host" in e.detail for e in got["events"][1])


def test_probe_only_model_scales_to_zero_equal():
    """Probes keep a replica live but not active: it still scales to
    zero, and later probes are answered at the control plane (mirrors
    test_coldstart's probe case)."""
    def scenario(side):
        lc = side.cluster(n_nodes=2, n_slots=2)
        lc.register("m", *side.model("B"), n_blocks=2, hot_nodes=[0])
        asc = side.auto.Autoscaler(side.auto.AutoscalerConfig(
            keepalive=0.05))
        trace = side.work.probe_trace("m", period=0.02, duration=0.5)
        log = lc.replay(trace, autoscaler=asc, tick_seconds=0.002,
                        tail_seconds=0.3)
        return {"summary": log.summary(), "events": log.scale_events,
                "probes": lc.probe_answers,
                "locals": sorted(lc.serving["m"].locals_),
                "warm": lc.state.warm_nodes("m")}
    got = _both(scenario)
    assert got["locals"] == [] and got["probes"]["m"] > 0


# --------------------------------------------- SSD park, cold restore
def test_ssd_park_and_cold_restore_equal():
    """``scale_down(park="ssd")`` of the only replica, a cold restore
    from the snapshot, and a remote-host restore of a second model
    (mirrors test_coldstart's snapshot round trip)."""
    def scenario(side):
        lc = side.cluster(n_nodes=3, n_slots=2)
        lc.register("m", *side.model("B"), n_blocks=2, hot_nodes=[0])
        rng = np.random.default_rng(5)
        prompt = _prompt(rng, "B", 6)
        lc.submit("m", prompt, 4)
        lc.drain_serving()
        lc.scale_down("m", [0], park="ssd")
        parked = (lc.state.ssd_nodes("m"), sorted(lc.serving["m"].locals_))
        reports = [lc.scale("m", 0)]
        lc.run_to_completion()
        lc.submit("m", prompt, 4)
        lc.drain_serving()
        # a host copy on an occupied node: the source reads it remotely
        lc.register("n", *side.model("A"), n_blocks=2, warm_nodes=[0])
        reports.append(lc.scale("n", 1))
        lc.run_to_completion()
        lc.submit("n", _prompt(rng, "A", 5), 3)
        lc.drain_serving()
        return {"reports": reports, "parked": parked,
                "ssd_after": lc.state.ssd_nodes("m"),
                **_served(lc, ["m", "n"])}
    got = _both(scenario)
    assert [r.source_tier for r in got["reports"]] == ["ssd", "remote"]
    assert got["parked"] == ([0], []) and got["ssd_after"] == []
    r = got["results"]["m"]
    assert r[0] == r[1] and len(r[0]) == 4


def test_compile_cache_refused():
    with pytest.raises(NotImplementedError):
        LiveCluster(n_nodes=1, device="cpu", compile_cache=object())


# ------------------------------------------------------ SLO contention
def test_slo_edf_arbiter_contention_equal():
    """Two models contend for the free nodes under EDF admission and the
    SLO-pressure-weighted arbiter, a mixed interactive/batch burst from
    host-tier copies the arbiter placed (mirrors test_slo_control_plane's
    live acceptance case and ``run_slo``)."""
    def scenario(side):
        W = side.work
        inter, batch = W.INTERACTIVE.scaled(0.02), W.BATCH.scaled(0.02)
        lc = side.cluster(n_nodes=3, n_slots=2,
                          admission=side.sched.EDFPolicy())
        for m in ("a", "b"):
            lc.register(m, *side.model("B"), n_blocks=2, warm_copies=1)
        asc = side.auto.Autoscaler(side.auto.AutoscalerConfig(
            cooldown_up=0.05, keepalive=0.2, max_k=2, max_nodes=1))
        rng = np.random.default_rng(3)
        trace = []
        for i in range(12):
            slo = batch if i < 6 else inter
            trace.append(W.Request(i, "ab"[i % 2], 0.004 + 0.0003 * i, 5,
                                   int(rng.integers(3, 6)), slo=slo))
        log = lc.replay(trace, autoscaler=asc, tick_seconds=0.002,
                        tail_seconds=0.1)
        return {"summary": log.summary(), "events": log.scale_events,
                "decisions": asc.decisions, **_served(lc, "ab")}
    got = _both(scenario)
    assert got["summary"]["n_finished"] == 12
    assert "slo_attainment_interactive" in got["summary"]


# ------------------------------------------------------ disaggregation
def test_disaggregated_pools_equal():
    """``prefill_nodes``/``decode_nodes``: the prefill pool exports every
    prompt over the PackedKV wire into the decode pool, each export
    priced on the handoff log; per-role load signals (mirrors
    test_disagg's cluster fixture)."""
    def scenario(side):
        lc = side.cluster(n_nodes=3, n_slots=2)
        lc.register("m", *side.model("A"), n_blocks=2, prefill_nodes=[0],
                    decode_nodes=[1])
        rng = np.random.default_rng(11)
        for i, n in enumerate([5, 8, 21, 8, 5, 13]):
            lc.submit("m", _prompt(rng, "A", n), 8, req_id=i)
        lc.drain_serving()
        sigs = lc._load_signals(lc.clock, {}, {})
        return {"signals": sigs, **_served(lc, "m")}
    got = _both(scenario)
    assert len(got["results"]["m"]) == 6
    assert [s.role for s in got["signals"]] == ["prefill", "decode"]
    assert got["stats"]["m"][1][0]["exported"] == 6
    assert got["stats"]["m"][0][1]["prefills"] == 0
    assert len(got["handoff"]) == 6


# ------------------------------------------------------------ overload
def test_preemption_park_resume_and_shed_equal():
    """``preemption=True`` with a ``shed_limit``: interactive arrivals
    preempt batch decodes, victims park in the host tier and resume,
    and arrivals past the shed limit are shed with a retry hint
    (mirrors test_overload's cluster wiring)."""
    def scenario(side):
        W = side.work
        lc = side.cluster(n_nodes=1, n_slots=2, page_size=16,
                          admission=side.sched.StrictPriorityPolicy(),
                          preemption=True, shed_limit=3)
        lc.register("m", *side.model("A"), n_blocks=2, hot_nodes=[0])
        rng = np.random.default_rng(60)
        for _ in range(2):
            lc.submit("m", _prompt(rng, "A", 6), 10, slo=W.BATCH)
        for _ in range(4):
            lc.tick()
        for _ in range(6):
            lc.submit("m", _prompt(rng, "A", 6), 4, slo=W.INTERACTIVE)
        parked = 0
        for _ in range(400):
            active = lc.tick()
            parked += any(mm.parked.get("m") for mm in lc.nodes)
            if not active:
                break
        return {"preempted": lc.take_preempt_events(),
                "shed": lc.take_shed_events(), "parked_ticks": parked,
                **_served(lc, "m")}
    got = _both(scenario)
    kinds = {e.kind for e in got["audit"]}
    assert {"preempt", "park", "resume", "shed"} <= kinds
    assert got["preempted"] and got["shed"] and got["parked_ticks"]


def test_park_timeout_sheds_equal():
    """A victim that cannot re-enter within ``max_park_ticks`` is shed
    with a park_timeout audit entry (mirrors test_overload)."""
    def scenario(side):
        W = side.work
        lc = side.cluster(n_nodes=1, n_slots=2, page_size=16,
                          admission=side.sched.StrictPriorityPolicy(),
                          preemption=True, max_park_ticks=3)
        lc.register("m", *side.model("A"), n_blocks=2, hot_nodes=[0])
        rng = np.random.default_rng(70)
        lc.submit("m", _prompt(rng, "A", 6), 20, slo=W.BATCH)
        for _ in range(4):
            lc.tick()
        for _ in range(8):
            lc.submit("m", _prompt(rng, "A", 6), 8, slo=W.INTERACTIVE)
        for _ in range(600):
            if not lc.tick():
                break
        return {"shed": lc.take_shed_events(), **_served(lc, "m")}
    got = _both(scenario)
    assert ("park_timeout", 0) in [(e.kind, e.req_id) for e in got["audit"]]
    assert 0 not in got["results"]["m"]


# --------------------------------------------------- device residency
def test_scale_down_frees_the_replica_tensors():
    """A demoted shard drops its device tensors and the torn-down engine
    holds none: nothing keeps a released replica's weights alive."""
    lc = LiveCluster(n_nodes=2, n_slots=2, max_len=MAX_LEN, device="cpu")
    lc.register("m", *_side(False).model("B"), n_blocks=2, hot_nodes=[0])
    lc.scale("m", 1)
    lc.run_to_completion()
    rng = np.random.default_rng(1)
    lc.submit("m", _prompt(rng, "B", 5), 3)
    lc.drain_serving()
    refs = [weakref.ref(t)
            for t in lc.nodes[1].gpu_shard("m").flat.values()]
    flat0 = lc.nodes[0].gpu_shard("m").flat
    row = next(iter(flat0.values()))
    assert row.untyped_storage().data_ptr() != \
        lc.models["m"].registry.ctypes.data     # a copy, not the registry
    lc.scale_down("m", [1])
    assert lc.nodes[1].host_cache.get("m").flat == {}
    assert all(r() is None for r in refs)


def test_live_cluster_needs_a_device(monkeypatch):
    """No device given: the GPU, and a raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LiveCluster(n_nodes=1)
