#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

  python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero, with no result line):
  1. build every CUDA kernel of ``src/repro_torch/kernels/csrc`` (one nvcc
     per source, in parallel) and print the card's name and power limit;
  2. hold each kernel against its plain PyTorch version on the card, in
     fp32 (TF32 off) and bf16, at the fuzz harness's tolerances (2e-5 and
     2e-2), at the serving path's shapes and at the edge cases; time the
     kernel, its plain version and, where one exists, a PyTorch library
     call computing the same function (a yardstick the port never calls);
  3. serve full-width qwen2.5-3b (36 layers, d_model 2048, random bf16
     weights from a seed) through ``ContinuousBatchingEngine`` with prefix
     sharing on, and check that the kernels carried every attention
     layer: decode-step launches == 36 × decode ticks, flash launches ==
     36 × fresh prefills;
  4. serve a few requests in fp32 and re-run each one teacher-forced
     through ``forward`` + ``decode_step`` with the plain attention: every
     engine token must equal the reference argmax wherever the reference's
     top-2 logit margin exceeds MARGIN.
The last two lines are the kernels' JSON record and ``{"ok": true, ...}``.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # dense, per type
TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernel_fuzz.py
MARGIN = 1e-3                  # top-2 logit margin for the fp32 check
N_LAYERS = 36


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, flops: float, dtype: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ------------------------------------------------------------ phase 2
class ErrLog:
    """Largest |kernel - plain| seen per kernel and dtype."""

    def __init__(self):
        self.err = {}

    def check(self, name, dtype, out, ref, what):
        import torch
        tol = TOL[dtype]
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol, msg=lambda m: f"{what}: {m}")
        e = (out.float() - ref.float()).abs().max().item()
        key = (name, dtype)
        self.err[key] = max(self.err.get(key, 0.0), e)


def _step_inputs(gen, B, H, KVH, dh, ps, MP, lens, dtype, free=()):
    import torch
    dev = "cuda"
    P = B * MP + 1
    f = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)
    table = torch.full((B, MP), -1, dtype=torch.int32)
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(
        int(lens.sum().item())))
    used = 0
    for b in range(B):
        if b in free:
            continue
        n = -(-max(int(lens[b]), 1) // ps)
        table[b, :n] = perm[used:used + n].to(torch.int32)
        used += n
    return dict(q=f(B, H, dh), kn=f(B, KVH, dh), vn=f(B, KVH, dh),
                k=f(P, ps, KVH, dh), v=f(P, ps, KVH, dh),
                table=table.to(dev), lens=lens.to(torch.int32).to(dev))


def check_paged_step(errs, dtype_name):
    import torch
    from repro_torch.kernels import paged_decode_step
    from repro_torch.kernels.ref import paged_decode_step_ref
    dtype = getattr(torch, dtype_name)
    B, H, KVH, dh, ps, max_len = 8, 16, 2, 128, 16, 2048
    MP = max_len // ps
    gen = torch.Generator(device="cuda").manual_seed(1)
    full = MP * ps
    edge = [0, 1, ps - 1, ps, ps + 1, full, 700, 1500]
    cases = [("edge lens", torch.tensor(edge), None, ()),
             ("edge lens, window 100", torch.tensor(edge), 100, ()),
             ("FREE rows 2 and 5", torch.tensor([300, 9, 0, 47, 1024, 0, 17,
                                                 2048]), None, (2, 5)),
             ("random lens, window 512",
              torch.randint(0, full + 1, (B,), generator=torch.Generator()
                            .manual_seed(7)), 512, ())]
    for what, lens, window, free in cases:
        x = _step_inputs(gen, B, H, KVH, dh, ps, MP, lens, dtype, free)
        P = x["k"].shape[0]
        args = (x["q"], x["kn"], x["vn"])
        out, ko, vo = paged_decode_step(*args, x["k"].clone(), x["v"].clone(),
                                        x["table"], x["lens"], window=window)
        ref, kr, vr = paged_decode_step_ref(*args, x["k"].clone(),
                                            x["v"].clone(), x["table"],
                                            x["lens"], window=window)
        torch.cuda.synchronize()
        errs.check("paged_decode_step", dtype_name, out, ref,
                   f"paged_decode_step {dtype_name} {what}")
        if not (torch.equal(ko[:P - 1], kr[:P - 1])
                and torch.equal(vo[:P - 1], vr[:P - 1])):
            raise AssertionError(f"paged_decode_step {dtype_name} {what}: "
                                 f"pools differ outside the trash page")
        if what.startswith("FREE"):
            # NaN garbage in the trash page must not reach any output
            kn_, vn_ = x["k"].clone(), x["v"].clone()
            kn_[P - 1] = float("nan")
            vn_[P - 1] = float("nan")
            out2, _, _ = paged_decode_step(*args, kn_, vn_, x["table"],
                                           x["lens"], window=window)
            torch.cuda.synchronize()
            if not torch.isfinite(out2.float()).all():
                raise AssertionError("NaN trash page reached the output")
            errs.check("paged_decode_step", dtype_name, out2, ref,
                       f"paged_decode_step {dtype_name} NaN trash")


def check_flash(errs, dtype_name):
    import torch
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(2)
    for S in (1, 17, 128, 1000, 2048):
        for window in (None, 256):
            f = lambda h: torch.randn((1, h, S, 128), generator=gen,
                                      device="cuda").to(dtype)
            q, k, v = f(16), f(2), f(2)
            out = flash_attention(q, k, v, causal=True, window=window)
            ref = flash_attention_ref(q, k, v, causal=True, window=window)
            torch.cuda.synchronize()
            errs.check("flash_attention", dtype_name, out, ref,
                       f"flash_attention {dtype_name} S={S} window={window}")


def time_paged_step():
    """Kernel, plain and bound at a decode tick of the serving phase's
    shape: 8 slots mid-generation, bf16.  Eight copies of the pools are
    cycled so each launch finds its K/V outside the 50 MB L2, as the
    36-layer step does."""
    import torch
    from repro_torch.kernels import paged_decode_step
    from repro_torch.kernels.ref import paged_decode_step_ref
    B, H, KVH, dh, ps, MP = 8, 16, 2, 128, 16, 128
    g = H // KVH
    lens = torch.randint(64, 1152, (B,),
                         generator=torch.Generator().manual_seed(3))
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = _step_inputs(gen, B, H, KVH, dh, ps, MP, lens, torch.bfloat16)
    pools = [(x["k"].clone(), x["v"].clone()) for _ in range(8)]
    it = {"i": 0}

    def run(fn):
        def call():
            k, v = pools[it["i"] % len(pools)]
            it["i"] += 1
            fn(x["q"], x["kn"], x["vn"], k, v, x["table"], x["lens"])
        return call
    ms = time_ms(run(paged_decode_step))
    plain = time_ms(run(paged_decode_step_ref), iters=10)
    esz = 2
    stored = (lens - 1).clamp(min=0).sum().item()
    n_bytes = (2 * stored * KVH * dh * esz           # K and V rows read
               + 2 * B * H * dh * esz                 # q in, out
               + 4 * B * KVH * dh * esz               # new K/V in, rows out
               + sum(-(-int(n) // ps) for n in lens) * 4 + B * 4)
    flops = 4 * (stored + B) * KVH * g * dh
    b_ms, by = bound_ms(n_bytes, flops, "bfloat16")
    return {"ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": by,
            "library_ms": None,
            "shape": f"B=8 H=16 KVH=2 dh=128 ps=16 MP=128 bf16 lens="
                     f"{lens.tolist()}"}


def time_flash():
    """Kernel, plain, library call and bound at the longest prompt the
    serving phase prefills (S=1024), bf16."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    B, H, KVH, S, dh = 1, 16, 2, 1024, 128
    gen = torch.Generator(device="cuda").manual_seed(5)
    f = lambda h: torch.randn((B, h, S, dh), generator=gen,
                              device="cuda").to(torch.bfloat16)
    q, k, v = f(H), f(KVH), f(KVH)
    ms = time_ms(lambda: flash_attention(q, k, v))
    plain = time_ms(lambda: flash_attention_ref(q, k, v), iters=10)
    kr = k.repeat_interleave(H // KVH, dim=1)
    vr = v.repeat_interleave(H // KVH, dim=1)
    lib = time_ms(lambda: F.scaled_dot_product_attention(q, kr, vr,
                                                         is_causal=True))
    pairs = S * (S + 1) // 2
    flops = 4 * pairs * dh * H * B
    n_bytes = 2 * (2 * B * H * S * dh + 2 * B * KVH * S * dh)
    b_ms, by = bound_ms(n_bytes, flops, "bfloat16")
    return {"ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": by,
            "library_ms": lib,
            "shape": "B=1 H=16 KVH=2 S=1024 dh=128 causal bf16 "
                     "(library: SDPA, GQA heads expanded outside the timing)"}


# ------------------------------------------------------------ phase 3
def serving_trace(vocab: int, seed: int):
    """14 requests, prompts 64..1024 tokens, 32..128 new tokens.  Requests
    1 and 2 share request 0's prompt prefix: 600 tokens (a mid-page match,
    so the shared page forks) and 512 tokens (page-aligned)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    tok = lambda n: list(map(int, rng.integers(0, vocab, n)))
    base = tok(600)
    prompts = [base + tok(40), base + tok(90), base[:512] + tok(100)]
    prompts += [tok(int(n)) for n in rng.integers(64, 1025, 11)]
    new = [int(n) for n in rng.integers(32, 129, len(prompts))]
    return list(zip(prompts, new))


def serve_full_width(seed: int):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import (flash_attention, paged_decode_step,
                                     reset_launch_counts)
    from repro_torch.models import init_params
    from repro_torch.serving import ContinuousBatchingEngine
    cfg = get_config("qwen2.5-3b")
    assert cfg.n_layers == N_LAYERS and cfg.d_model == 2048
    params = init_params(cfg, seed=seed, dtype=torch.bfloat16, device="cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    eng = ContinuousBatchingEngine(cfg, params, n_slots=8, max_len=2048,
                                   page_size=16, prefix_sharing=True)
    trace = serving_trace(cfg.vocab_size, seed)
    for i, (p, n) in enumerate(trace):
        eng.submit(p, n, req_id=i)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_decode_step": paged_decode_step.launches,
                "flash_attention": flash_attention.launches}
    s = eng.stats
    seqs = eng.sched.finished
    fresh = sum(1 for q in seqs.values() if q.shared_tokens == 0)
    for i, (_, n) in enumerate(trace):
        toks = out[i]
        if len(toks) != n or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"request {i}: {len(toks)} tokens, want {n}")
    if launches["paged_decode_step"] != N_LAYERS * s["decode_ticks"]:
        raise AssertionError(f"decode-step launches {launches} vs "
                             f"{s['decode_ticks']} ticks")
    if launches["flash_attention"] != N_LAYERS * fresh:
        raise AssertionError(f"flash launches {launches} vs {fresh} fresh "
                             f"prefills")
    if s["shared_tokens"] <= 0 or fresh == len(trace):
        raise AssertionError("no prompt shared a prefix: the CoW fork and "
                             "suffix prefill did not run")
    gen_tok = sum(len(v) for v in out.values())
    log(f"[serve] qwen2.5-3b full width ({n_params / 1e9:.3f}B params, bf16)"
        f": {len(trace)} requests, {gen_tok} tokens in {wall:.3f} s "
        f"= {gen_tok / wall:.1f} tok/s (wall time incl. prefill); "
        f"decode_ticks={s['decode_ticks']} decode_tokens="
        f"{s['decode_tokens']} ({s['decode_tokens'] / wall:.1f} decode "
        f"tok/s over the wall time); prefills={s['prefills']} fresh={fresh} "
        f"shared_tokens={s['shared_tokens']}")
    profile_ticks(eng, cfg.vocab_size, seed)
    del eng, params
    torch.cuda.empty_cache()
    return launches


def profile_ticks(eng, vocab: int, seed: int) -> None:
    """Where a serving tick's time goes: a short burst (8 requests, 256
    prompt tokens, 24 new) under torch.profiler after the measured run;
    prints device-busy share of the wall time and the top kernels."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(seed + 7)
    for i in range(8):
        eng.submit(list(map(int, rng.integers(0, vocab, 256))), 24,
                   req_id=1000 + i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        ticks0 = eng.stats["decode_ticks"]
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ticks = eng.stats["decode_ticks"] - ticks0
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
    # device-side events only (kernels, memcpy/memset): host operators
    # carry their kernels' time too and would count it twice
    rows = [(dev(e), e.key, e.count) for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and dev(e) > 0]
    busy = sum(r[0] for r in rows) / 1e6
    log(f"[profile] 8 requests x (256 prompt, 24 new): {ticks} decode "
        f"ticks, wall {wall:.4f} s, device busy {busy:.4f} s "
        f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%")
    for t, key, count in sorted(rows, reverse=True)[:10]:
        log(f"[profile]   {t / 1e3:10.3f} ms  {count:6d}x  {key[:90]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ------------------------------------------------------------ phase 4
def check_fp32(seed: int):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import (decode_step, forward, init_paged_cache,
                                    init_params, paged_prefill_scatter,
                                    pages_for)
    from repro_torch.serving import ContinuousBatchingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("qwen2.5-3b")
    params = init_params(cfg, seed=seed, dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(seed + 1)
    tok = lambda n: list(map(int, rng.integers(0, cfg.vocab_size, n)))
    a = tok(300)
    trace = [(a, 24), (a[:200] + tok(50), 24), (tok(150), 24)]
    eng = ContinuousBatchingEngine(cfg, params, n_slots=8, max_len=2048,
                                   page_size=16, prefix_sharing=True)
    for i, (p, n) in enumerate(trace):
        eng.submit(p, n, req_id=i)
    out = eng.run()
    checked = skipped = 0
    for i, (prompt, _) in enumerate(trace):
        gen = out[i]
        total = len(prompt) + len(gen)
        npg = pages_for(total, 16)
        cache = init_paged_cache(cfg, 1, page_size=16, n_pages=npg,
                                 max_pages=npg, device="cuda")
        cache["pages"] = torch.arange(npg, dtype=torch.int32,
                                      device="cuda")[None]
        toks = torch.tensor([prompt], device="cuda")
        o = forward(cfg, params, {"tokens": toks}, build_cache=True,
                    attn_impl="plain")
        paged_prefill_scatter(cfg, cache, o["kv"], 0, cache["pages"][0])
        logits = o["logits"][0, -1]
        for j, got in enumerate(gen):
            if j:
                logits, cache = decode_step(
                    cfg, params, cache,
                    torch.tensor([gen[j - 1]], device="cuda"), cache["pos"],
                    attn_impl="plain")
                logits = logits[0]
            if not torch.isfinite(logits).all():
                raise AssertionError(f"request {i} token {j}: non-finite "
                                     f"reference logits")
            top2 = torch.topk(logits, 2)
            margin = (top2.values[0] - top2.values[1]).item()
            if margin <= MARGIN:
                skipped += 1
                continue
            checked += 1
            if int(top2.indices[0]) != got:
                raise AssertionError(
                    f"request {i} token {j}: engine {got} vs reference "
                    f"{int(top2.indices[0])} (margin {margin:.3g})")
    if checked < (checked + skipped) // 2:
        raise AssertionError(f"only {checked} tokens cleared the margin")
    log(f"[fp32] qwen2.5-3b full width fp32: {len(trace)} requests, "
        f"{checked} engine tokens equal the plain teacher-forced argmax, "
        f"{skipped} skipped (top-2 margin <= {MARGIN}); shared_tokens="
        f"{eng.stats['shared_tokens']}")
    del eng, params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}; {smi()}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] {_build.sources()} in {time.perf_counter() - t0:.2f} s")
    for name, text in sorted(_build.ptxas_log.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas {name}] {line.strip()}")

    errs = ErrLog()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for dt in ("float32", "bfloat16"):
        check_paged_step(errs, dt)
        check_flash(errs, dt)
    log(f"[kernels] all cases within tolerance; max |kernel - plain|: "
        + ", ".join(f"{n} {d} {e:.3g}" for (n, d), e in errs.err.items()))
    timing = {"paged_decode_step": time_paged_step(),
              "flash_attention": time_flash()}
    for name, t in timing.items():
        log(f"[time] {name}: kernel_ms={t['ms']:.4f} plain_ms="
            f"{t['plain_ms']:.4f} library_ms={t['library_ms']} bound_ms="
            f"{t['bound_ms']:.4f} ({t['bound_by']}) at {t['shape']}")

    launches = serve_full_width(args.seed)
    check_fp32(args.seed)

    meta = {"paged_decode_step": ("src/repro_torch/kernels/csrc/"
                                  "paged_decode_step.cu",
                                  "src/repro/kernels/paged_attention.py:227"),
            "flash_attention": ("src/repro_torch/kernels/csrc/"
                                "flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:83")}
    kernels = []
    for name, (source, replaces) in meta.items():
        t = timing[name]
        e32 = errs.err[(name, "float32")]
        e16 = errs.err[(name, "bfloat16")]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(e32, e16), "max_abs_err_fp32": e32,
            "max_abs_err_bf16": e16, "max_err": max(e32, e16),
            "ms": t["ms"], "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": t["shape"]})
        if launches[name] <= 0 or not math.isfinite(t["ms"]):
            raise AssertionError(f"{name} did not run on the main path")
    name = torch.cuda.get_device_name(0)
    log(smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
