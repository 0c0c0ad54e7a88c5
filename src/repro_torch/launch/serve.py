"""Serving entry point of the PyTorch port: bring up a model on the GPU
and serve a static batch through ``InferenceEngine`` (the default, as
``repro.launch.serve.run_engine`` does), replay a mixed-length burst
through the continuous-batching engine (``--continuous``), scale two
models on the live tiered cluster while it serves (``--live``), replay a
trace under the autoscaler from zero replicas (``--autoscale``), run
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
engine only.  ``--coldstart`` runs the JAX demo's
6-layer model at ``--d-model`` (default 64).  Weights are random, from
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
from repro_torch.serving import (POLICIES, Autoscaler, AutoscalerConfig,
                                 ContinuousBatchingEngine, HardwareProfile,
                                 InferenceEngine, LiveCluster, Request,
                                 Simulator, constant_stress)
from repro_torch.serving.workload import probe_trace

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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching engine on a mixed-length trace "
                         "(default: one static batch through InferenceEngine)")
    ap.add_argument("--live", action="store_true",
                    help="two-model tiered live cluster (scale + serve)")
    ap.add_argument("--autoscale", action="store_true",
                    help="closed-loop trace replay: the autoscaler drives "
                         "scale-up/EWL/scale-down on the live cluster")
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
    args = ap.parse_args()
    if args.sim:
        run_sim(args)
    elif args.coldstart:
        run_coldstart(args)
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
