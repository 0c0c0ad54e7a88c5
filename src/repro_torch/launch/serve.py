"""Serving entry point of the PyTorch port: bring up a model on the GPU
and serve a static batch through ``InferenceEngine`` (the default, as
``repro.launch.serve.run_engine`` does), replay a mixed-length burst
through the continuous-batching engine (``--continuous``), scale two
models on the live tiered cluster while it serves (``--live``), replay a
trace under the autoscaler from zero replicas (``--autoscale``), replay
a two-model mixed-SLO trace under FCFS and under EDF with the placement
arbiter (``--slo``), serve one trace unified and through role-split
prefill/decode pools (``--disagg``), survive a sustained 3x overload on
one node with preemption, page quotas and shedding (``--overload``), run
the scale-to-zero cold-start demo with the persistent compile cache
(``--coldstart``), or compare the scaling policies on the calibrated
simulator (``--sim``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch pixtral-12b \
      --prompt 320
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-large-v3
  PYTHONPATH=src python -m repro_torch.launch.serve --continuous
  PYTHONPATH=src python -m repro_torch.launch.serve --continuous \
      --arch qwen2-moe-a2.7b
  PYTHONPATH=src python -m repro_torch.launch.serve --continuous \\
      --d-model 64 --device cpu --requests 6 --prompt 16 --tokens 4
  PYTHONPATH=src python -m repro_torch.launch.serve --live --nodes 7
  PYTHONPATH=src python -m repro_torch.launch.serve --autoscale --nodes 4
  PYTHONPATH=src python -m repro_torch.launch.serve --slo --nodes 6
  PYTHONPATH=src python -m repro_torch.launch.serve --disagg
  PYTHONPATH=src python -m repro_torch.launch.serve --overload
  PYTHONPATH=src python -m repro_torch.launch.serve --overload \\
      --d-model 64 --device cpu --dtype float32
  PYTHONPATH=src python -m repro_torch.launch.serve --coldstart
  PYTHONPATH=src python -m repro_torch.launch.serve --coldstart \\
      --device cpu --dtype float32
  PYTHONPATH=src python -m repro_torch.launch.serve --sim --nodes 8 \\
      --rps 20 --duration 2

``--arch`` is served at its full published width unless ``--d-model``
asks for a reduced variant (which also cuts the vocabulary to 2048, as
``repro.launch.serve`` does).  The static batch carries random patch
embeddings (vlm: ``--prompt`` counts them, as ``make_batch`` does) or
frame embeddings (encdec); ``--continuous`` serves text, and not the
encoder-decoder family, which the JAX package serves through the static
engine only.  ``--slo``, ``--disagg`` and ``--overload`` serve
``--arch`` like the other cluster modes (``--overload`` too, where the
JAX demo fixes ``d_model`` 64); their printed TTFTs, attainments and
audit times are on the simulated clock, their wall times on the host's.
``--coldstart`` runs the JAX demo's 6-layer model at ``--d-model``
(default 64).  Weights are random, from
``--seed``.  ``--sim``
runs no model: it prices the scaling policies on the simulated clock of
the paper's testbed profile (``serving.tiers.H800``).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.compile_cache import CompileCache
from repro_torch.models import init_params, make_batch, payload_nbytes
from repro_torch.serving import (BATCH, INTERACTIVE, POLICIES,
                                 AdmissionPolicy, Autoscaler,
                                 AutoscalerConfig, ContinuousBatchingEngine,
                                 EDFPolicy, HardwareProfile, InferenceEngine,
                                 LiveCluster, PlacementArbiter, Request,
                                 Simulator, StrictPriorityPolicy,
                                 constant_stress)
from repro_torch.serving.scheduler import PageQuota
from repro_torch.serving.workload import overload_trace, probe_trace

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def mixed_trace(n: int, prompt: int, tokens: int, seed: int = 0):
    """Mixed-length request list (prompt_len, out_tokens) around the
    requested means — the workload shape where continuous batching wins."""
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(max(4, prompt // 2), prompt * 2)),
             int(rng.integers(max(2, tokens // 2), tokens * 2)))
            for _ in range(n)]


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def _config(args, arch=None):
    cfg = get_config(arch or args.arch)
    if args.d_model is not None:
        cfg = reduced(cfg, d_model=args.d_model, vocab=2048)
    return cfg


def _model(args, device, arch=None, seed=None):
    cfg = _config(args, arch)
    seed = args.seed if seed is None else seed
    return cfg, init_params(cfg, seed=seed, dtype=DTYPES[args.dtype],
                            device=device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_engine(args) -> None:
    """Serve one static batch of ``--requests`` prompts of ``--prompt``
    tokens, ``--tokens`` new tokens each, through ``InferenceEngine``."""
    n_patches = _config(args).n_patches
    if args.prompt <= n_patches:
        raise SystemExit(f"--prompt counts {args.arch}'s {n_patches} patch "
                         f"embeddings: give more")
    device = resolve_device(args.device)
    cfg, params = _model(args, device)
    eng = InferenceEngine(cfg, params, max_len=args.prompt + args.tokens)
    batch = make_batch(cfg, args.requests, args.prompt, seed=args.seed + 1,
                       device=device)
    _sync(device)
    t0 = time.perf_counter()
    out = eng.generate(batch, args.tokens)
    _sync(device)
    dt = time.perf_counter() - t0
    total = args.requests * args.tokens
    print(f"arch={cfg.arch_id} d_model={cfg.d_model} layers={cfg.n_layers} "
          f"dtype={args.dtype}: served {args.requests} requests x "
          f"{args.tokens} tokens in {dt:.3f}s ({total / dt:.1f} tok/s on "
          f"{device_name(device)}); output shape {tuple(out.shape)}")


def run_continuous(args) -> None:
    """Drive the continuous-batching engine through a mixed-length spike:
    every request arrives at once (the burst), slots refill mid-decode."""
    if args.requests < 1:
        raise SystemExit("--continuous needs --requests >= 1")
    if _config(args).family == "encdec":
        raise SystemExit("the encoder-decoder family is served by the "
                         "static engine only (drop --continuous)")
    device = resolve_device(args.device)
    cfg, params = _model(args, device)
    trace = mixed_trace(args.requests, args.prompt, args.tokens,
                        seed=args.seed)
    max_len = max(p + t for p, t in trace)
    rng = np.random.default_rng(args.seed + 1)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, size=p)))
               for p, _ in trace]
    eng = ContinuousBatchingEngine(cfg, params, n_slots=args.slots,
                                   max_len=max_len)
    for (_, otok), prompt in zip(trace, prompts):
        eng.submit(prompt, otok)
    _sync(device)
    t0 = time.perf_counter()
    out = eng.run()
    _sync(device)
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in out.values())
    s = eng.stats
    print(f"arch={cfg.arch_id} d_model={cfg.d_model} layers={cfg.n_layers} "
          f"dtype={args.dtype}: {len(trace)} requests ({args.slots} slots) "
          f"-> {total} tokens in {dt:.3f}s ({total / dt:.1f} tok/s on "
          f"{device_name(device)})")
    print(f"  prefills={s['prefills']} decode_ticks={s['decode_ticks']} "
          f"mean decode batch="
          f"{s['decode_tokens'] / max(s['decode_ticks'], 1):.2f}")


def run_live(args) -> None:
    """Two models on one tiered cluster (multi-model runtime): model A
    (``--arch``) hot on node 0, model B (stablelm-1.6b) host-warm on the
    last node; both scale concurrently while a mixed request burst is
    absorbed through the scheduler-driven serving instances (pipelines
    during load, local replicas after the mode switch)."""
    device = resolve_device(args.device)
    max_len = args.prompt + args.tokens + 8
    lc = LiveCluster(n_nodes=args.nodes, n_slots=args.slots,
                     max_len=max_len, device=device)
    cfgs = {}
    for m, arch, seed, kw in [("A", args.arch, args.seed,
                               {"hot_nodes": [0]}),
                              ("B", "stablelm-1.6b", args.seed + 1,
                               {"warm_nodes": [args.nodes - 1]})]:
        cfg, params = _model(args, device, arch, seed)
        lc.register(m, cfg, params, n_blocks=4, **kw)
        cfgs[m] = cfg
        del params
    half = max(1, (args.nodes - 2) // 2)
    reports = {"A": lc.scale("A", half), "B": lc.scale("B", half)}
    for m, rep in reports.items():
        print(f"scale {m} ({cfgs[m].arch_id}): {rep.source_tier}-tier "
              f"source {rep.sources} -> {len(rep.dests)} dests; first new "
              f"capacity at {rep.t_first_serve * 1e3:.1f} ms, complete at "
              f"{rep.t_complete * 1e3:.1f} ms (simulated clock)")
    rng = np.random.default_rng(args.seed + 2)
    for i in range(args.requests):
        m = "A" if i % 2 == 0 else "B"
        prompt = list(map(int, rng.integers(0, cfgs[m].vocab_size,
                                            size=max(4, args.prompt // 4))))
        lc.submit(m, prompt, args.tokens)
    _sync(device)
    t0 = time.perf_counter()
    while lc.step():           # serve while the multicasts are in flight
        lc.tick()
    lc.drain_serving()
    _sync(device)
    dt = time.perf_counter() - t0
    out = {m: lc.results(m) for m in ("A", "B")}
    total = sum(len(v) for res in out.values() for v in res.values())
    adopted = sum(e.stats["adopted"] for m in ("A", "B")
                  for e in lc.serving[m].locals_.values())
    print(f"{args.requests} requests across 2 models -> {total} tokens in "
          f"{dt:.3f}s wall on {device_name(device)}; {adopted} handed off "
          f"mid-generation; replicas: A={sorted(lc.serving['A'].locals_)} "
          f"B={sorted(lc.serving['B'].locals_)}")


def run_autoscale(args) -> None:
    """Closed loop on the live runtime: the model starts host-warm with
    ZERO replicas; a bursty trace arrives and the autoscaler does the
    rest — scale-up via k-way multicast from the warm copy, serving
    through EWL pipelines and mode-switched replicas, then keep-alive
    scale-down back to the host tier when the burst passes."""
    device = resolve_device(args.device)
    cfg, params = _model(args, device)
    max_len = max(4, args.prompt // 4) + args.tokens + 8
    lc = LiveCluster(n_nodes=args.nodes, n_slots=args.slots,
                     max_len=max_len, device=device)
    lc.register("m", cfg, params, n_blocks=4, warm_nodes=[0])
    del params
    rng = np.random.default_rng(args.seed + 2)
    trace = [Request(i, "m", 0.005 + 0.002 * i,
                     max(4, args.prompt // 4), args.tokens)
             for i in range(args.requests)]
    asc = Autoscaler(AutoscalerConfig(cooldown_up=0.05, cooldown_down=0.02,
                                      keepalive=0.15, min_replicas=0,
                                      max_k=2))
    _sync(device)
    t0 = time.perf_counter()
    log = lc.replay(trace, autoscaler=asc, tick_seconds=0.002,
                    tail_seconds=0.5,
                    prompt_fn=lambda r: list(map(int, rng.integers(
                        0, cfg.vocab_size, size=r.prompt_len))))
    _sync(device)
    dt = time.perf_counter() - t0
    s = log.summary()
    print(f"closed-loop replay: {int(s['n_finished'])}/{len(trace)} "
          f"requests in {dt:.3f}s wall on {device_name(device)}; TTFT "
          f"p50={s['ttft_p50'] * 1e3:.1f}ms p99={s['ttft_p99'] * 1e3:.1f}ms "
          f"and gpu_seconds={s['gpu_seconds']:.3f} (simulated clock, "
          f"{lc.hw.name} profile)")
    for e in log.scale_events:
        print(f"  t={e.t * 1e3:7.1f}ms (simulated clock) {e.kind:6s} "
              f"{e.detail}")
    print(f"replicas now: {sorted(lc.serving['m'].locals_)} (host-warm "
          f"fallback on {lc._host_payload_nodes('m')})")


def run_slo(args) -> None:
    """Mixed-class demo of the request control plane: the SAME bursty
    two-model trace (interactive + batch SLO classes) replayed twice on
    the live runtime — FCFS admission with independent scaling vs EDF
    admission with the SLO-pressure-weighted placement arbiter — and the
    per-class TTFT tails / SLO attainment printed side by side.  Greedy
    tokens are identical across the two runs; only who waits changes.
    Both models ("a" and "b") carry ``--arch``'s weights from
    ``--seed``."""
    device = resolve_device(args.device)
    cfg, params = _model(args, device)
    inter, batch = INTERACTIVE.scaled(0.02), BATCH.scaled(0.02)
    rng = np.random.default_rng(3)
    n = max(args.requests, 8)
    trace = []
    for i in range(n):       # batch half arrives first — worst for FCFS
        slo = batch if i < n // 2 else inter
        out = int(rng.integers(5, 8)) if slo is batch \
            else int(rng.integers(3, 5))
        trace.append(Request(i, "a" if i % 2 == 0 else "b",
                             0.004 + 0.0003 * i, max(4, args.prompt // 16),
                             out, slo=slo))
    conditions = {
        "fcfs+independent": (AdmissionPolicy(),
                             PlacementArbiter(slo_weighted=False)),
        "edf+arbiter": (EDFPolicy(), PlacementArbiter()),
    }
    results = {}
    for name, (admission, arbiter) in conditions.items():
        lc = LiveCluster(n_nodes=args.nodes, n_slots=2,
                         max_len=max(4, args.prompt // 16) + 8 + 8,
                         admission=admission, arbiter=arbiter, device=device)
        lc.register("a", cfg, params, n_blocks=2, warm_copies=1)
        lc.register("b", cfg, params, n_blocks=2, warm_copies=1)
        asc = Autoscaler(AutoscalerConfig(cooldown_up=0.05, keepalive=0.2,
                                          max_k=2, max_nodes=1))
        _sync(device)
        t0 = time.perf_counter()
        log = lc.replay(trace, autoscaler=asc, tick_seconds=0.002,
                        tail_seconds=0.1)
        _sync(device)
        dt = time.perf_counter() - t0
        results[name] = {m: lc.results(m) for m in ("a", "b")}
        s = log.summary()
        p99i = s["ttft_p99_interactive"] * 1e3
        p99b = s["ttft_p99_batch"] * 1e3
        print(f"{name:18s} interactive p99={p99i:6.1f}ms  "
              f"batch p99={p99b:6.1f}ms  "
              f"attainment={s['slo_attainment']:.2f} "
              f"(interactive {s['slo_attainment_interactive']:.2f}) "
              f"(simulated clock); {dt:.3f}s wall on {device_name(device)}")
    if results["fcfs+independent"] != results["edf+arbiter"]:
        raise AssertionError("admission policy changed the greedy tokens")
    n_tokens = sum(len(v) for r in results["edf+arbiter"].values()
                   for v in r.values())
    print(f"greedy tokens bit-equal across both policies ({n_tokens} "
          f"tokens)")


def run_disagg(args) -> None:
    """Prefill/decode disaggregation demo: the SAME mixed trace served
    by a unified cluster and by a role-split one — a prefill pool runs
    the prompt passes, exports finished prompts as deduped PackedKV, and
    a decode pool adopts them straight into generation.  Greedy tokens
    are bit-identical (asserted); only which engine does what changes."""
    device = resolve_device(args.device)
    cfg, params = _model(args, device)
    rng = np.random.default_rng(4)
    n = max(args.requests, 2)
    prompts = [list(map(int, rng.integers(
                   0, cfg.vocab_size, size=int(rng.integers(8, args.prompt)))))
               for _ in range(n)]
    max_len = args.prompt + args.tokens + 8

    def serve(**pools):
        lc = LiveCluster(n_nodes=args.nodes, n_slots=args.slots,
                         max_len=max_len, device=device)
        lc.register("m", cfg, params, n_blocks=4, **pools)
        for i, p in enumerate(prompts):
            lc.submit("m", p, args.tokens, req_id=i)
        _sync(device)
        t0 = time.perf_counter()
        lc.drain_serving()
        _sync(device)
        return lc, time.perf_counter() - t0

    cu, dt_u = serve(hot_nodes=[0, 1])
    cd, dt_d = serve(prefill_nodes=[0], decode_nodes=[1])
    ref, got = cu.results("m"), cd.results("m")
    if got != ref:
        raise AssertionError("disagg diverged from unified greedy tokens")
    sv = cd.serving["m"]
    pre, dec = sv.prefills[0], sv.locals_[1]
    by_choice = {c: sum(1 for d in cd.handoff_log if d.chosen == c)
                 for c in ("transfer", "recompute", "fresh")}
    priced = sum(d.payload_bytes for d in cd.handoff_log)
    total = sum(len(v) for v in got.values())
    print(f"arch={cfg.arch_id} d_model={cfg.d_model} dtype={args.dtype} "
          f"disagg: {n} requests -> {total} tokens, bit-equal to unified "
          f"(unified {dt_u:.3f}s, disagg {dt_d:.3f}s wall on "
          f"{device_name(device)})")
    print(f"  prefill pool node 0: prefills={pre.stats['prefills']} "
          f"exported={pre.stats['exported']} "
          f"decode_ticks={pre.stats['decode_ticks']}")
    print(f"  decode pool  node 1: adopted={dec.stats['adopted']} "
          f"decode_ticks={dec.stats['decode_ticks']} "
          f"admitted={dec.stats['admitted']}")
    print(f"  wire: {len(cd.handoff_log)} handoffs priced "
          f"({by_choice['transfer']} transfer / "
          f"{by_choice['recompute']} recompute / "
          f"{by_choice['fresh']} fresh), {priced/1e3:.1f} kB packed KV "
          f"offered")


def run_overload(args) -> None:
    """Overload-survival demo: a sustained 3× mixed-class overload on
    ONE fixed node (scale-out cannot arrive in time — degradation order
    IS the outcome), served twice.  FCFS admits in arrival order and
    collapses for everyone; the survival stack (strict-priority
    admission + per-class page quotas + page-granular preemption over
    the PackedKV wire + explicit shedding with retry-after hints) keeps
    the interactive class fast and whole while batch work is parked to
    the host tier or shed — every decision in the audit log.  The JAX
    demo fixes ``d_model`` 64; here the model is ``--arch`` at full
    width unless ``--d-model`` reduces it (the trace and every printed
    time are on the simulated clock, which does not depend on the
    width)."""
    device = resolve_device(args.device)
    cfg, params = _model(args, device)
    quotas = {"interactive": PageQuota(reserved_frac=0.25),
              "batch": PageQuota(ceiling_frac=0.6)}
    # 1 node × 2 slots at 0.002 s/tick ≈ 140 rps of real capacity
    trace = overload_trace(model="m", capacity_rps=140.0, overload=3.0,
                           duration=0.3, prompt_len=8, out_tokens=6,
                           seed=5)
    conditions = {
        "fcfs collapse": dict(admission=AdmissionPolicy()),
        "survival stack": dict(
            admission=StrictPriorityPolicy(quotas=quotas),
            preemption=True, shed_limit=4, max_park_ticks=400),
    }
    print(f"sustained 3x overload: {len(trace)} mixed-class requests "
          f"over {max(r.t_arrive for r in trace):.2f}s (simulated clock), "
          f"1 node / 2 slots, arch={cfg.arch_id} d_model={cfg.d_model}\n")
    for name, cond in conditions.items():
        lc = LiveCluster(n_nodes=1, n_slots=2, max_len=48, page_size=16,
                         device=device, **cond)
        lc.register("m", cfg, params, n_blocks=2, hot_nodes=[0])
        asc = Autoscaler(AutoscalerConfig(cooldown_up=1e9, keepalive=1e9,
                                          shed_high=0.2))
        _sync(device)
        t0 = time.perf_counter()
        log = lc.replay(trace, autoscaler=asc, tick_seconds=0.002,
                        max_ticks=500_000)
        _sync(device)
        dt = time.perf_counter() - t0
        s = log.summary()
        by = log.by_class()
        good = {c: sum(1 for m in ms if m.t_finish is not None) / len(ms)
                for c, ms in by.items()}
        print(f"{name:15s} interactive "
              f"p99={s['ttft_p99_interactive']*1e3:7.1f}ms "
              f"goodput={good.get('interactive', 1.0):.2f}   "
              f"batch goodput={good.get('batch', 1.0):.2f} (simulated "
              f"clock); {dt:.3f}s wall on {device_name(device)}")
        if "survival" in name:
            kinds = {}
            for e in lc.audit_log:
                kinds[e.kind] = kinds.get(e.kind, 0) + 1
            print(f"{'':15s} audit: " + ", ".join(
                f"{k}={n}" for k, n in sorted(kinds.items())))
            for e in lc.audit_log[:4]:
                extra = (f" retry_after={e.retry_after:.0f} ticks"
                         if e.kind == "shed" else "")
                print(f"{'':15s}   t={e.t*1e3:6.1f}ms (simulated clock) "
                      f"{e.kind:8s} req {e.req_id}: {e.detail}{extra}")
            print(f"{'':15s}   ... ({len(lc.audit_log)} audit events; "
                  f"degradation lands on the lowest class first)")


def run_coldstart(args) -> None:
    """Scale-to-zero cold-start demo: a model registered with NO
    placement at all takes a cold burst, idles through a probe-punctuated
    gap long enough for the autoscaler to park it to a block-granular SSD
    snapshot (true zero replicas — health probes are answered at the
    control plane and do not reset the keep-alive), then a second burst
    restores it.  The SAME trace is replayed through the pipelined
    multi-tier loader + persistent compile cache and through the naive
    whole-blob blocking fetch; greedy tokens are bit-equal, only the
    cold-start clock changes.  The model is the JAX demo's (``--arch``,
    6 layers, ``--d-model`` 64 unless given); the profile's fetch rates
    are the JAX demo's 2.6 MB/s scaled by the model's bytes over those of
    its fp32 ``d_model`` 64 variant, so the simulated clock reads the
    same at any width."""
    device = resolve_device(args.device)
    base = get_config(args.arch)
    cfg = reduced(base, d_model=args.d_model or 64, n_layers=6)
    params = init_params(cfg, seed=args.seed, dtype=DTYPES[args.dtype],
                         device=device)
    ref = init_params(reduced(base, d_model=64, n_layers=6), seed=args.seed,
                      device="cpu")
    bw = 2.6e6 * payload_nbytes(params) / payload_nbytes(ref)
    hw = HardwareProfile(ssd_bw=bw, host_to_gpu_bw=bw, jit_compile_s=0.3)
    n = max(args.requests, 4)
    trace = [Request(i, "m", 0.005 + 0.01 * i, 6, 5) for i in range(n)]
    trace += [Request(100 + i, "m", 3.0 + 0.01 * i, 6, 5)
              for i in range(n)]
    trace += probe_trace("m", period=0.2, duration=2.9, start=0.5)
    trace.sort(key=lambda r: r.t_arrive)

    outs = {}
    with tempfile.TemporaryDirectory() as td:
        for name, (pipe, cache) in (
                ("pipelined", (True, CompileCache(
                    os.path.join(td, "compile.json")))),
                ("naive", (False, None))):
            lc = LiveCluster(n_nodes=3, n_slots=2, max_len=48, hw=hw,
                             pipelined_loading=pipe, compile_cache=cache,
                             device=device)
            lc.register("m", cfg, params, n_blocks=6)   # fully cold
            asc = Autoscaler(AutoscalerConfig(keepalive=0.3, max_k=2,
                                              coldstart_slo=1.5), hw=hw)
            t0 = time.perf_counter()
            log = lc.replay(trace, autoscaler=asc, tick_seconds=0.002,
                            tail_seconds=0.2, max_ticks=500_000)
            _sync(device)
            dt = time.perf_counter() - t0
            # probes race the scale plan: one path may serve a probe on
            # a live engine the other answers at the control plane —
            # only real demand is held to the bit-equality bar
            demand = {r.req_id for r in trace if not r.probe}
            outs[name] = {rid: toks
                          for rid, toks in lc.results("m").items()
                          if rid in demand}
            s = log.summary()
            gaps = " + ".join(
                f"{e.tier}: fetch {e.fetch_seconds*1e3:.0f}ms "
                f"compile {e.compile_seconds*1e3:.0f}ms"
                for e in log.cold_starts)
            print(f"{name:10s} cold starts={int(s['cold_starts'])} "
                  f"({gaps}; simulated clock); {dt:.3f}s wall on "
                  f"{device_name(device)}")
            print(f"{'':10s} cold first-token gap "
                  f"p99={s['cold_first_token_gap_p99']*1e3:.0f}ms  "
                  f"slo_misses={s['cold_start_slo_miss']:.0f}"
                  f"/{s['cold_starts']:.0f}  "
                  f"probes answered at control plane: "
                  f"{lc.probe_answers['m']}")
    if outs["pipelined"] != outs["naive"]:
        raise AssertionError("loading path changed the greedy tokens")
    print(f"greedy tokens bit-equal across both loading paths "
          f"({sum(len(v) for v in outs['naive'].values())} tokens); the "
          f"second burst restored from the SSD snapshot with zero "
          f"compile under the cache")


def run_sim(args) -> None:
    """λScale against the baselines on the calibrated discrete-event
    simulator (no model runs; every time is on the simulated clock)."""
    hw = HardwareProfile()
    reqs = constant_stress(args.rps, args.duration, model=args.model,
                           out_tokens=16, seed=0)
    print(f"simulating {len(reqs)} requests on {args.nodes} nodes "
          f"({hw.name} profile, simulated clock)")
    for name in ("lambdascale", "serverlessllm", "faasnet", "nccl", "ideal"):
        res = Simulator(POLICIES[name](hw), args.nodes, hw).run(reqs)
        print(f"  {name:14s} p50={res.ttft_percentile(50):6.3f}s "
              f"p90={res.ttft_percentile(90):6.3f}s "
              f"gpu_time={res.gpu_seconds:8.1f}s (simulated clock)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching engine on a mixed-length trace "
                         "(default: one static batch through InferenceEngine)")
    ap.add_argument("--live", action="store_true",
                    help="two-model tiered live cluster (scale + serve)")
    ap.add_argument("--autoscale", action="store_true",
                    help="closed-loop trace replay: the autoscaler drives "
                         "scale-up/EWL/scale-down on the live cluster")
    ap.add_argument("--slo", action="store_true",
                    help="mixed-SLO-class demo: FCFS+independent vs "
                         "EDF+placement-arbiter on the same live trace")
    ap.add_argument("--disagg", action="store_true",
                    help="prefill/decode disaggregation demo: role-split "
                         "pools on the PackedKV wire vs unified serving")
    ap.add_argument("--overload", action="store_true",
                    help="overload-survival demo: preemption + page "
                         "quotas + shedding vs FCFS collapse under a "
                         "sustained 3x mixed-class overload")
    ap.add_argument("--coldstart", action="store_true",
                    help="scale-to-zero cold start: SSD park + pipelined "
                         "restore + persistent compile cache vs the naive "
                         "blocking fetch (greedy tokens asserted equal)")
    ap.add_argument("--sim", action="store_true",
                    help="scaling policies on the calibrated simulator "
                         "(no model runs)")
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--d-model", type=int, default=None,
                    help="reduce the model to this width (default: full)")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, required present)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nodes", type=int, default=12)
    ap.add_argument("--model", default="llama2-13b",
                    help="the simulated model of --sim")
    ap.add_argument("--rps", type=float, default=50.0)
    ap.add_argument("--duration", type=float, default=5.0)
    args = ap.parse_args(argv)
    if args.sim:
        run_sim(args)
    elif args.coldstart:
        run_coldstart(args)
    elif args.overload:
        run_overload(args)
    elif args.disagg:
        run_disagg(args)
    elif args.slo:
        run_slo(args)
    elif args.autoscale:
        run_autoscale(args)
    elif args.live:
        run_live(args)
    elif args.continuous:
        run_continuous(args)
    else:
        run_engine(args)


if __name__ == "__main__":
    main()
