"""The port's control plane against the JAX package: metrics, storage
tiers, placement, the autoscaler, the discrete-event simulator and the
scaling-policy baselines.

These modules are copies that do only host arithmetic, so every case
requires EXACT equality: the same inputs, made once from a seed (numpy)
or drawn by hypothesis, go through ``repro.serving.*`` and
``repro_torch.serving.*``, and the results are compared field by field
after ``_norm`` turns each package's objects into plain values (class
names kept, NaN made comparable).  The JAX side is built with the
paper's ``H800`` profile; the port's default ``HardwareProfile()`` is
that profile (``test_default_profile_is_h800``).
"""
import dataclasses
import math
import types

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as jget
from repro.serving import autoscaler as ja
from repro.serving import baselines as jb
from repro.serving import metrics as jmet
from repro.serving import placement as jpl
from repro.serving import simulator as jsim
from repro.serving import tiers as jt
from repro.serving import workload as jw
from repro_torch.configs import get_config as tget
from repro_torch.serving import autoscaler as ta
from repro_torch.serving import baselines as tb
from repro_torch.serving import metrics as tmet
from repro_torch.serving import placement as tpl
from repro_torch.serving import simulator as tsim
from repro_torch.serving import tiers as tt
from repro_torch.serving import workload as tw

JAX = types.SimpleNamespace(a=ja, b=jb, met=jmet, pl=jpl, sim=jsim, t=jt,
                            w=jw, cfg=jget, hw=jt.H800)
PORT = types.SimpleNamespace(a=ta, b=tb, met=tmet, pl=tpl, sim=tsim, t=tt,
                             w=tw, cfg=tget, hw=tt.HardwareProfile())
MODELS = ("a", "b", "c")


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
    if isinstance(x, (set, frozenset)):
        return ("set", sorted(_norm(v) for v in x))
    if isinstance(x, np.generic):
        return _norm(x.item())
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    if callable(x):
        return "<callable>"
    if hasattr(x, "__dict__"):
        return (type(x).__name__, _norm(dict(vars(x))))
    return x


def _same(scenario):
    """Run ``scenario(side)`` on both packages; the results must agree."""
    want, got = _norm(scenario(JAX)), _norm(scenario(PORT))
    assert got == want


# ------------------------------------------------------------- profile
def test_default_profile_is_h800():
    """The port's default profile is the paper's GPU testbed, field by
    field the JAX package's ``H800`` (its own default is a TPU profile,
    which the port never runs on)."""
    assert dataclasses.asdict(tt.HardwareProfile()) == \
        dataclasses.asdict(jt.H800)
    assert dataclasses.asdict(tt.H800) == dataclasses.asdict(jt.H800)
    for tier in ("gpu", "host", "remote", "ssd", "registry"):
        assert tt.H800.fetch_seconds(3e9, tier) == \
            jt.H800.fetch_seconds(3e9, tier)
        assert _norm(tt.H800.restore_plan(3e9, 4, tier)) == \
            _norm(jt.H800.restore_plan(3e9, 4, tier))


# ------------------------------------------------------------- metrics
def _metrics_events(seed: int):
    """One random event sequence, in the order a replay would emit it."""
    rng = np.random.default_rng(seed)
    ev, t = [], 0.0
    n = int(rng.integers(8, 24))
    for rid in range(n):
        t += float(rng.exponential(0.01))
        slo = [None, "interactive", "standard", "batch"][
            int(rng.integers(0, 4))]
        ev.append(("arrival", rid, MODELS[rid % 3], t,
                   int(rng.integers(4, 64)), slo))
    for rid in range(n):
        if rng.random() < 0.15:
            ev.append(("shed", rid, t + 0.001, float(rng.random())))
            continue
        t0 = t + float(rng.exponential(0.02))
        ev.append(("start", rid, t0))
        t1 = t0 + float(rng.exponential(0.01))
        ev.append(("first", rid, t1))
        if rng.random() < 0.8:
            ev.append(("first_decode", rid, t1 + float(rng.random()) * 1e-3))
        if rng.random() < 0.85:
            ev.append(("finish", rid, t1 + float(rng.exponential(0.05)),
                       int(rng.integers(1, 32))))
    for _ in range(int(rng.integers(0, 4))):
        ev.append(("scale", float(rng.random()),
                   ["up", "down"][int(rng.integers(0, 2))],
                   MODELS[int(rng.integers(0, 3))], "reason"))
    for _ in range(int(rng.integers(0, 3))):
        tr = float(rng.random())
        ev.append(("cold", tr, MODELS[int(rng.integers(0, 3))],
                   ["host", "ssd", "remote"][int(rng.integers(0, 3))],
                   float(rng.random()), float(rng.random()) * 0.1,
                   tr + float(rng.random()),
                   None if rng.random() < 0.5 else float(rng.random())))
    for _ in range(int(rng.integers(0, 3))):
        ev.append(("preempt", float(rng.random()),
                   MODELS[int(rng.integers(0, 3))], int(rng.integers(0, n)),
                   int(rng.integers(1, 9))))
    for role in ("unified", "prefill", "decode"):
        if rng.random() < 0.5:
            ev.append(("gpu", role, float(rng.random())))
    return ev, float(rng.random()), t


def _replay_metrics(side, events, gpu_seconds):
    log = side.met.MetricsLog()
    for e in events:
        kind, *a = e
        if kind == "arrival":
            rid, model, t, plen, slo = a
            log.on_arrival(rid, model, t, plen,
                           slo=side.w.SLO_CLASSES[slo] if slo else None)
        elif kind == "shed":
            log.on_shed(a[0], a[1], retry_after=a[2])
        elif kind == "start":
            log.on_start(*a)
        elif kind == "first":
            log.on_first_token(*a)
        elif kind == "first_decode":
            log.on_first_decode(*a)
        elif kind == "finish":
            log.on_finish(*a)
        elif kind == "scale":
            log.on_scale(*a)
        elif kind == "cold":
            *args, budget = a
            log.on_cold_start(*args, slo_budget=budget)
        elif kind == "preempt":
            t, model, rid, pages = a
            log.on_preempt(t, model, rid, pages=pages)
        elif kind == "gpu":
            log.on_gpu_time(*a)
    log.gpu_seconds = gpu_seconds
    return log


@pytest.mark.parametrize("seed", range(6))
def test_metrics_summary_equal(seed):
    events, gpu_s, t_end = _metrics_events(seed)

    def scenario(side):
        log = _replay_metrics(side, events, gpu_s)
        return (log.summary(), log.ttfts(), log.e2es(), log.unfinished,
                [log.slo_pressure(m, t_end) for m in MODELS],
                [log.slo_attainment(c) for c in (None, "interactive",
                                                 "batch")],
                [log.first_token_gap(e) for e in log.cold_starts],
                side.met.merge([log, side.met.MetricsLog()]).summary())
    _same(scenario)


def test_percentile_and_pressure_equal():
    rng = np.random.default_rng(5)
    xs = list(map(float, rng.random(37)))
    for q in (0, 1, 50, 90, 95, 99, 100):
        assert tmet.percentile(xs, q) == jmet.percentile(xs, q)
    assert math.isnan(tmet.percentile([], 50))
    ts = list(map(float, rng.random(12)))
    classes = ["interactive", None, "batch", "standard"] * 3

    def queue(side):
        return [types.SimpleNamespace(
            t_arrive=t, slo=side.w.SLO_CLASSES[c] if c else None)
            for t, c in zip(ts, classes)]
    assert tmet.slo_pressure_of(queue(PORT), 0.7) == \
        jmet.slo_pressure_of(queue(JAX), 0.7)
    assert tpl.slo_pressure_of is tmet.slo_pressure_of


# --------------------------------------------------------------- tiers
def test_model_manager_tier_transitions_equal():
    """A scripted walk over every ModelManager transition (admit,
    receive, demote, promote, demote_to_ssd, snapshot, park) and the
    ClusterState queries after each step."""
    def scenario(side):
        hw = dataclasses.replace(side.hw, host_mem_models=2,
                                 gpu_mem_models=1)
        cs = side.t.ClusterState(3, hw)
        out = []

        def snap(tag, ret=None):
            out.append((tag, ret, cs.gpu_nodes("a"), cs.warm_nodes("a"),
                        cs.warm_nodes("b"), cs.free_nodes(),
                        cs.ssd_nodes("a"), cs.gpu_seconds,
                        [(n.node_id, list(n.gpu), n.host_cache.models(),
                          n.host_cache.evictions, sorted(n.ssd),
                          n.gpu_busy_since, {m: list(p) for m, p in
                                             n.parked.items()})
                         for n in cs.nodes]))
        mm = cs.nodes[0]
        snap("admit", mm.admit("a", 2, 0.0))
        snap("recv0", mm.receive("a", 0, b"blk0", {"w0": 1}))
        snap("recv0 again", mm.receive("a", 0, b"blk0"))
        snap("recv1", mm.receive("a", 1, b"blk1", {"w1": 2}))
        snap("complete", mm.gpu_shard("a").complete)
        snap("has", (mm.has_block("a", 1), mm.has_block("b", 0)))
        snap("admit b evicts a", mm.admit("b", 1, 1.0))
        snap("promote a", mm.promote("a", 2.0) is not None)
        snap("shard flat", mm.gpu_shard("a").flat)
        cs.release(0, 3.0, "a")
        snap("release a")
        for t, m in enumerate(["c", "d", "e"]):
            cs.occupy(1, m, 4.0 + t)
            cs.release(1, 4.5 + t, m)
        snap("lru churn on node 1")
        snap("promote metadata-only", cs.nodes[1].promote("d", 8.0))
        snap("demote_to_ssd", cs.nodes[0].demote_to_ssd("a", 9.0))
        snap("demote_to_ssd none", cs.nodes[0].demote_to_ssd("zz", 9.0))
        snap("snapshot", cs.nodes[0].snapshot("a") is not None)
        shard = cs.nodes[0].promote_from_ssd("a")
        snap("promote_from_ssd", None if shard is None else shard.buffers)
        cs.nodes[2].host_cache.touch("b", 10.0)
        cs.nodes[2].demote_to_ssd("b", 10.5)
        snap("metadata snapshot", cs.nodes[2].promote_from_ssd("b"))
        for rid in (5, 3, 5):
            cs.nodes[2].park_seq("a", rid, ("rec", rid))
        snap("parked", cs.nodes[2].parked_ids("a"))
        snap("pop", cs.nodes[2].pop_parked("a", 5))
        snap("pop last", cs.nodes[2].pop_parked("a", 3))
        gm = side.t.ModelManager(0, gpu_capacity=2)
        gm.admit("a", 1, 0.0)
        gm.admit("b", 1, 1.0)
        out.append(("gpu lru", gm.admit("c", 1, 2.0), list(gm.gpu),
                    gm.host_cache.models(), gm.gpu_model))
        cs.finalize(12.0)
        snap("finalize")
        return out
    _same(scenario)


@pytest.mark.parametrize("seed", range(4))
def test_cluster_state_random_walk_equal(seed):
    """A random walk of occupy/release/touch/promote/demote_to_ssd over a
    4-node cluster with an LRU of 2: every state and ``gpu_seconds``."""
    rng = np.random.default_rng(seed)
    ops = [(int(rng.integers(0, 6)), int(rng.integers(0, 4)),
            MODELS[int(rng.integers(0, 3))], float(i)) for i in range(60)]

    def scenario(side):
        cs = side.t.ClusterState(4, dataclasses.replace(
            side.hw, host_mem_models=2))
        out = []
        for op, nd, m, now in ops:
            n = cs.nodes[nd]
            if op == 0 and n.gpu_free:
                cs.occupy(nd, m, now)
            elif op == 1 and n.gpu_model is not None:
                cs.release(nd, now)
            elif op == 2:
                n.host_cache.touch(m, now, payload=side.t.ModelShard(
                    m, 1, buffers={0: b"x"}))
            elif op == 3:
                out.append(n.promote(m, now) is not None)
            elif op == 4:
                out.append(n.demote_to_ssd(m, now))
            else:
                out.append(n.promote_from_ssd(m) is not None)
            out.append((cs.free_nodes(), [cs.warm_nodes(x) for x in MODELS],
                        [cs.ssd_nodes(x) for x in MODELS], cs.gpu_seconds,
                        [(list(k.gpu), k.host_cache.models(),
                          k.host_cache.evictions) for k in cs.nodes]))
        cs.finalize(61.0)
        out.append(cs.gpu_seconds)
        return out
    _same(scenario)


# ----------------------------------------------------------- placement
_node = st.tuples(st.sampled_from((None,) + MODELS),
                  st.lists(st.sampled_from(MODELS + ("d",)), max_size=3))


def _state(side, nodes):
    cs = side.t.ClusterState(len(nodes), side.hw)
    for i, (gpu, host) in enumerate(nodes):
        for t, m in enumerate(host):
            cs.nodes[i].host_cache.touch(m, float(t))
        if gpu is not None:
            cs.occupy(i, gpu, 0.0)
    return cs


@settings(max_examples=60, deadline=None)
@given(nodes=st.lists(_node, min_size=1, max_size=8),
       model=st.sampled_from(MODELS), n=st.integers(-1, 9),
       exclude=st.lists(st.integers(0, 7), max_size=3),
       near=st.lists(st.integers(0, 7), max_size=2),
       asks=st.dictionaries(st.sampled_from(MODELS), st.integers(-1, 6)),
       press=st.dictionaries(st.sampled_from(MODELS),
                             st.floats(0, 4, allow_nan=False)),
       n_free=st.integers(0, 9), weighted=st.booleans(),
       loads=st.lists(st.integers(0, 4), min_size=8, max_size=8),
       members=st.lists(st.integers(0, 7), max_size=3),
       ready=st.lists(st.booleans(), min_size=8, max_size=8))
def test_placement_arbiter_equal(nodes, model, n, exclude, near, asks,
                                 press, n_free, weighted, loads, members,
                                 ready):
    def scenario(side):
        arb = side.pl.PlacementArbiter(slo_weighted=weighted)
        cs = _state(side, nodes)
        engines = {nd: types.SimpleNamespace(
            name=nd, sched=types.SimpleNamespace(in_flight=loads[nd] // 2,
                                                 pending=loads[nd] % 2))
            for nd in range(len(nodes)) if nd % 2 == 0 or loads[nd]}
        target = arb.handoff_target(
            engines, members=members, exclude=exclude[0] if exclude
            else None, near=near, ready=lambda nd: ready[nd])
        return (arb.place_warm(cs, model, n),
                arb.pick_dests(cs, model, n, exclude=exclude, near=near),
                arb.arbitrate(asks, n_free, press),
                arb.up_order(list(asks), press),
                None if target is None else target.name)
    _same(scenario)


# ---------------------------------------------------------- autoscaler
_sig = st.fixed_dictionaries({
    "model": st.sampled_from(MODELS), "queue_depth": st.integers(0, 40),
    "slots_total": st.integers(0, 32), "slots_busy": st.integers(0, 32),
    "nodes_busy": st.integers(0, 8),
    "slots_per_instance": st.integers(1, 8),
    "scaling_in_flight": st.booleans(), "n_replicas": st.integers(0, 4),
    "recent_ttft": st.lists(st.floats(0, 2, allow_nan=False), max_size=5),
    "idle_nodes": st.lists(st.tuples(st.integers(0, 7),
                                     st.floats(0, 1, allow_nan=False)),
                           max_size=3),
    "slo_pressure": st.floats(0, 5, allow_nan=False),
    "recent_arrivals": st.integers(0, 20),
    "role": st.sampled_from((None, "prefill", "decode")),
    "recent_itl": st.lists(st.floats(0, 0.1, allow_nan=False), max_size=4),
    "pages_total": st.integers(0, 64), "pages_live": st.integers(0, 64),
    "recent_sheds": st.integers(0, 5),
    "model_nbytes": st.sampled_from((0.0, 6e9, 26e9)),
    "model_blocks": st.sampled_from((0, 4, 16))})
_cfg = st.fixed_dictionaries({
    "headroom": st.integers(0, 2),
    "util_high": st.sampled_from((math.inf, 0.5, 0.9)),
    "ttft_slo": st.sampled_from((None, 0.1, 1.0)),
    "cooldown_up": st.sampled_from((0.0, 0.05)),
    "cooldown_down": st.sampled_from((0.0, 0.02)),
    "keepalive": st.sampled_from((0.1, 0.5, 5.0)),
    "max_k": st.integers(1, 4), "min_replicas": st.integers(0, 2),
    "max_nodes": st.sampled_from((None, 2, 6)),
    "pressure_high": st.sampled_from((None, 0.5)),
    "itl_slo": st.sampled_from((None, 0.01)),
    "page_util_high": st.sampled_from((None, 0.8)),
    "shed_high": st.sampled_from((None, 0.2)),
    "forecast": st.booleans(),
    "coldstart_slo": st.sampled_from((None, 0.5, 5.0))})


@settings(max_examples=60, deadline=None)
@given(cfg=_cfg, rounds=st.lists(st.lists(_sig, max_size=3), min_size=1,
                                 max_size=6),
       with_hw=st.booleans())
def test_autoscaler_decide_equal(cfg, rounds, with_hw):
    def scenario(side):
        asc = side.a.Autoscaler(side.a.AutoscalerConfig(**cfg),
                                hw=side.hw if with_hw else None)
        out = []
        for i, sigs in enumerate(rounds):
            out.append(asc.decide(0.05 * i,
                                  [side.a.LoadSignals(**s) for s in sigs]))
        return out, asc.decisions
    _same(scenario)


# ----------------------------------------------- simulator + baselines
def _sim_traces(side):
    burst = side.w.burstgpt_like(duration=40.0, base_rps=0.5, seed=3,
                                 spikes=[(5.0, 2.0, 40.0), (25.0, 2.0, 30.0)],
                                 prompt_len=512, out_tokens=128)
    multi = side.w.multi_model_trace(4, per_model_rpm=6.0, duration=60.0,
                                     seed=2, prompt_len=128, out_tokens=8)
    return {"burstgpt": (burst, None),
            "multi": (multi, {f"model-{i:02d}": side.cfg("llama2-7b")
                              for i in range(4)})}


@pytest.mark.parametrize("trace", ["burstgpt", "multi"])
@pytest.mark.parametrize("policy", sorted(jb.POLICIES))
def test_simulator_policies_equal(policy, trace):
    assert sorted(tb.POLICIES) == sorted(jb.POLICIES)

    def scenario(side):
        reqs, cfgs = _sim_traces(side)[trace]
        sim = side.sim.Simulator(side.b.POLICIES[policy](side.hw), 6,
                                 side.hw, keepalive=2.0, model_configs=cfgs)
        res = sim.run(reqs)
        return (res.ttft, res.completions, res.gpu_seconds,
                res.instance_events, res.n_requests, res.mean_ttft(),
                res.ttft_percentile(99), res.metrics.summary(),
                res.metrics.scale_events, res.time_to_throughput(0.5))
    _same(scenario)


def test_sim_model_and_policy_pricing_equal():
    """``SimModel`` pricing and each policy's provisioning on the same
    cluster state, at the published configs the benchmarks use."""
    def scenario(side):
        out = []
        for arch in ("llama2-13b", "qwen2.5-3b", "stablelm-1.6b"):
            sm = side.sim.SimModel.from_config(side.cfg(arch))
            out.append((sm, sm.tok_time(side.hw), sm.tok_time(side.hw, 8),
                        sm.prefill_time(side.hw, 512)))
            for name in sorted(side.b.POLICIES):
                cs = side.t.ClusterState(8, side.hw)
                cs.nodes[3].host_cache.touch(arch, 0.0)
                pol = side.b.POLICIES[name](side.hw)
                out.append((name, pol.provision(cs, arch, sm, 5, 1.0),
                            pol.mode_switch_delay(sm, side.hw),
                            cs.free_nodes()))
        return out
    _same(scenario)
