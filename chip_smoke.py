#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

  python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero, with no result line):
  1. build every CUDA kernel of ``src/repro_torch/kernels/csrc`` (one nvcc
     per source, in parallel), print the card's name and power limit and
     each kernel's registers and spills, and count the HMMA (tensor-core)
     instructions of every kernel in ``cuobjdump -sass``: each bf16
     flash, decode-walk and mLSTM kernel must have some, their fp32
     kernels none (``MMA_KERNELS``);
  2. hold each kernel against its plain PyTorch version on the card, in
     fp32 (TF32 off) and bf16, at the test tolerances (2e-5 and 2e-2 for
     attention, 1e-4 and 5e-2 for the RG-LRU scan), at the serving paths'
     shapes and at the edge cases (for the fused step also one and two
     slots with long lens, the split walk's few-slot ticks; for flash also
     head dims the bf16 kernel pads); time the kernel on the device (CUDA
     graph replay; the per-call enqueue time of eager launches beside it),
     its plain version and, where one exists, a PyTorch library call
     computing the same function (a yardstick the port never calls);
     flash is timed in bf16 and fp32 (two kernels), the ring decode also
     at qwen2.5-3b's striped shape, mLSTM also at a 128-token prompt,
     the scan at four shapes (``SCAN_TIMED``) with its inputs cycled past
     the L2 and the chunk count each one used;
  3. serve full-width qwen2.5-3b (36 layers, d_model 2048, random bf16
     weights from a seed) through ``ContinuousBatchingEngine`` with prefix
     sharing on, then through ``InferenceEngine`` and the striped
     ``paged=False`` engine, and check that the kernels carried every
     attention layer: decode-step (paged) or ring-decode (striped)
     launches == 36 × decode steps, flash launches == 36 × fresh
     prefills;
  4. serve a few qwen2.5-3b requests in fp32 and re-run each one
     teacher-forced through ``forward`` + ``decode_step`` with the plain
     attention: every engine token must equal the reference argmax
     wherever the reference's top-2 logit margin exceeds MARGIN;
  5. serve full-width recurrentgemma-2b (26 layers: 18 RG-LRU and 8
     local-attention layers with window 2048, d_model 2560, random bf16
     weights) through ``InferenceEngine``, the striped engine (ring of
     2048 in a 3072-token pool: a 2600-token prompt keeps its last 2048
     tokens, a decode crosses 2048) and the paged engine, with the
     launches of all three kernels on the path asserted per path;
  6. the same three paths in fp32 on a few requests, each token held to
     the plain teacher-forced argmax (plain attention AND plain scan);
  7. serve full-width xlstm-1.3b (48 layers: 42 mLSTM blocks with head
     dim 1024 and 6 sLSTM blocks, d_model 2048, no attention layer,
     random bf16 weights) through ``InferenceEngine`` (4 x 1024-token
     prompts), then the paged (a page table, no pools) and the striped
     engine on one 12-request trace, which must give the same tokens;
     mlstm_chunkwise launches == 42 x prefills on every path, no attention
     kernel launches;
  8. the same three paths in fp32 on a few requests, each token held to
     the plain teacher-forced argmax (plain mLSTM chunk loop);
  9. qwen2.5-3b execute-while-load at full width (bf16, every "node" on
     cuda:0): ``pack_model`` into 4 blocks of 9 layers, multicast 1 -> 4
     with the λPipe schedule (every node's buffer equal to the source,
     node 3's unpacked weights bit-equal; the wall time and GB/s printed
     as a device-local copy rate), 8 requests on the 4-stage
     ``PipelinedEngine`` built from node 3's blocks for 6 ticks, drain,
     handoff and adopt into a paged engine run to the end (every request
     finishes once with its full budget, no adopted sequence prefilled;
     flash launches == 36 x (microbatch forwards + recomputes + fresh
     prefills), decode-step launches == 36 x local decode ticks), then a
     prefill-role engine exporting to a decode-role one (adopted pages
     byte-equal to the payloads), and the pipelined-then-adopted path in
     fp32 on 3 requests held to the plain teacher-forced argmax.
Each path is driven with every launch count set to 0 just before it and
read just after.  The last two lines are the kernels' JSON record and
``{"ok": true, ...}``.
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
SCAN_TOL = {"float32": 1e-4, "bfloat16": 5e-2}   # tests/test_kernels.py
MLSTM_TOL = {"float32": 2e-4, "bfloat16": 5e-2}  # tests/test_kernels.py
MARGIN = 1e-3                  # top-2 logit margin for the fp32 check
N_LAYERS = 36                  # qwen2.5-3b: every layer is attention
HYBRID_ATTN, HYBRID_REC = 8, 18   # recurrentgemma-2b's 26 layers
SSM_MLSTM, SSM_SLSTM = 42, 6      # xlstm-1.3b's 48 layers
PATH_LAUNCHES = {}             # path name -> {kernel: launches in that run}
# further timed shapes of a kernel, beside its main one: flash's fp32
# kernel, dh 256, the ring decode at qwen2.5-3b's shape, a short prompt
# and the scan at a short prompt, the static batch and in bf16
EXTRA = ("fp32", "dh256", "qwen", "S128", "S256", "B8", "bf16")
# the scan's timed shapes (B, S, d, dtype): one RG-LRU layer's prefill of a
# 2048-token prompt, a typical paged prompt, InferenceEngine's static batch
SCAN_TIMED = {"main": (1, 2048, 2560, "float32"),
              "S256": (1, 256, 2560, "float32"),
              "B8": (8, 1024, 2560, "float32"),
              "bf16": (1, 2048, 2560, "bfloat16")}
L2_BYTES = 50e6                # H100 SXM L2 cache


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


def graph_ms(fn, iters: int = 50, reps: int = 5) -> float:
    """Device ms of one ``fn()``: ``iters`` calls captured in one CUDA
    graph after a warm-up, the graph replayed ``reps`` times between CUDA
    events.  Launched one by one from Python, a kernel that takes less
    than its wrapper's host work is timed at the host's enqueue rate; the
    replay times the device alone."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * iters)


def bound_ms(n_bytes: float, flops: float, dtype: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def hmma_counts(source: str):
    """HMMA (tensor-core mma) instructions per kernel function in the built
    library of ``csrc/<source>.cu``, from ``cuobjdump -sass`` (the CUDA
    toolkit's, beside nvcc)."""
    from repro_torch.kernels import _build
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(_build._lib_path(source))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and "HMMA" in line:
            counts[fn] += 1
    return counts


# Kernel functions of each source whose bf16 instantiations run on the
# tensor cores (HMMA > 0) and whose fp32 ones stay on the CUDA cores (no
# HMMA): source -> {mangled-name fragment: dtype}.  A "Li0E" template
# argument is the decode kernels' fp32 walk.
MMA_KERNELS = {
    "flash_attention": {"flash_mma_kernel": "bf16",
                        "flash_attention_kernelIf": "fp32"},
    "decode_attention": {"decode_attention_kernelI13__nv_bfloat16": "bf16",
                         "decode_attention_kernelIfLi0E": "fp32"},
    "paged_decode_step": {
        "paged_decode_step_kernelI13__nv_bfloat16": "bf16",
        "paged_decode_step_kernelIfLi0E": "fp32",
        "paged_decode_attention_kernelI13__nv_bfloat16": "bf16",
        "paged_decode_attention_kernelIfLi0E": "fp32"},
    "mlstm_chunkwise": {"mlstm_scores_mma": "bf16",
                        "mlstm_chunkwise_mma": "bf16",
                        "mlstm_scores_kernelIf": "fp32",
                        "mlstm_chunkwise_kernelIf": "fp32"},
}


def check_hmma() -> None:
    """Print the HMMA count of every kernel function of MMA_KERNELS'
    sources and assert each bf16 one has some and each fp32 one none;
    every listed fragment must name at least one function."""
    for source, kinds in MMA_KERNELS.items():
        counts = hmma_counts(source)
        for frag, kind in kinds.items():
            fns = {fn: n for fn, n in counts.items() if frag in fn}
            if not fns:
                raise AssertionError(f"{source}: no kernel function named "
                                     f"like {frag} in {sorted(counts)}")
            for fn, n in sorted(fns.items()):
                log(f"[sass {source}] {n} HMMA in {fn} ({kind})")
                if (n > 0) != (kind == "bf16"):
                    raise AssertionError(
                        f"{source}: {fn} has {n} HMMA instructions; its "
                        f"{kind} kernel must have "
                        f"{'some' if kind == 'bf16' else 'none'}")


# ------------------------------------------------------------ phase 2
class ErrLog:
    """Largest |kernel - plain| seen per kernel and dtype, and the largest
    share of the tolerance used, |kernel - plain| / (tol + tol |plain|)."""

    def __init__(self):
        self.err = {}
        self.used = {}

    def check(self, name, dtype, out, ref, what, tol=None):
        import torch
        tol = tol if tol is not None else TOL[dtype]
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol, msg=lambda m: f"{what}: {m}")
        d = (out.float() - ref.float()).abs()
        key = (name, dtype)
        self.err[key] = max(self.err.get(key, 0.0), d.max().item())
        used = (d / (tol + tol * ref.float().abs())).max().item()
        self.used[key] = max(self.used.get(key, 0.0), used)

    def check_scaled(self, name, dtype, out, ref, scale, what, tol):
        """|out - ref| <= tol (1 + scale) elementwise: ``scale`` is each
        output's conditioning (``ref.mlstm_parallel_f64``).  Logged under
        the key (name, dtype + " conditioned")."""
        import torch
        d = (out.double() - ref.double()).abs()
        share = d / (tol * (1.0 + scale))
        if not torch.isfinite(out.float()).all() or share.max().item() > 1.0:
            bad = int((share > 1.0).sum().item())
            raise AssertionError(
                f"{what}: {bad} of {share.numel()} elements beyond "
                f"{tol} (1 + scale); max |out - ref| {d.max().item():.4g}, "
                f"largest share {share.max().item():.4g}")
        key = (name, dtype + " conditioned")
        self.err[key] = max(self.err.get(key, 0.0), d.max().item())
        self.used[key] = max(self.used.get(key, 0.0), share.max().item())


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
    """The fused step at qwen2.5-3b's paged shape (8 slots, 16/2 heads,
    dh 128, a 2048-token pool) and recurrentgemma-2b's (8 slots, 10/1
    heads: g = 10 query heads per CTA, more than its 8 warps; dh 256; a
    3072-token pool, window 2048 on and off), over edge lens, FREE rows
    and a NaN trash page; then one and two slots with long lens at both
    shapes (the split walk's few-slot ticks).  The pools must be byte-equal
    outside the trash page."""
    import torch
    from repro_torch.kernels import paged_decode_step
    from repro_torch.kernels.ref import paged_decode_step_ref
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(1)
    B, ps = 8, 16
    # (label, H, KVH, dh, max_len, edge lens, FREE-case lens (rows 2 and 5
    # FREE), window of the edge case, window of the FREE and random cases)
    shapes = [("qwen", 16, 2, 128, 2048, [0, 1, ps - 1, ps, ps + 1, 2048,
                                          700, 1500],
               [300, 9, 0, 47, 1024, 0, 17, 2048], 100, 512),
              ("recurrentgemma", 10, 1, 256, 3072,
               [0, 1, ps + 1, 2048, 2049, 2600, 3072, 1500],
               [2500, 9, 0, 47, 2049, 0, 17, 3072], 2048, 2048)]
    for label, H, KVH, dh, max_len, edge, free_lens, w_edge, w_rand in shapes:
        MP = max_len // ps
        full = MP * ps
        edge, free_lens = torch.tensor(edge), torch.tensor(free_lens)
        cases = [("edge lens", edge, None, ()),
                 (f"edge lens, window {w_edge}", edge, w_edge, ()),
                 ("FREE rows 2 and 5", free_lens, None, (2, 5)),
                 (f"FREE rows 2 and 5, window {w_rand}", free_lens, w_rand,
                  (2, 5)),
                 (f"random lens, window {w_rand}", torch.randint(
                     0, full + 1, (B,), generator=torch.Generator()
                     .manual_seed(7)), w_rand, ())]
        for what, lens, window, free in cases:
            what = f"{label} H={H} KVH={KVH} dh={dh} {what}"
            x = _step_inputs(gen, B, H, KVH, dh, ps, MP, lens, dtype, free)
            P = x["k"].shape[0]
            args = (x["q"], x["kn"], x["vn"])
            out, ko, vo = paged_decode_step(*args, x["k"].clone(),
                                            x["v"].clone(), x["table"],
                                            x["lens"], window=window)
            ref, kr, vr = paged_decode_step_ref(*args, x["k"].clone(),
                                                x["v"].clone(), x["table"],
                                                x["lens"], window=window)
            torch.cuda.synchronize()
            errs.check("paged_decode_step", dtype_name, out, ref,
                       f"paged_decode_step {dtype_name} {what}")
            if not (torch.equal(ko[:P - 1], kr[:P - 1])
                    and torch.equal(vo[:P - 1], vr[:P - 1])):
                raise AssertionError(f"paged_decode_step {dtype_name} {what}"
                                     f": pools differ outside the trash page")
            if free:
                # NaN garbage in the trash page must not reach any output
                kn_, vn_ = x["k"].clone(), x["v"].clone()
                kn_[P - 1] = float("nan")
                vn_[P - 1] = float("nan")
                out2, _, _ = paged_decode_step(*args, kn_, vn_, x["table"],
                                               x["lens"], window=window)
                torch.cuda.synchronize()
                if not torch.isfinite(out2.float()).all():
                    raise AssertionError(f"{what}: NaN trash page reached "
                                         f"the output")
                errs.check("paged_decode_step", dtype_name, out2, ref,
                           f"paged_decode_step {dtype_name} {what} NaN trash")
    # the few-slot ticks the split walk is for: B = 1 and 2 with long lens
    # at both model shapes (the most CTAs per (slot, KV head))
    split_cases = [("qwen", 16, 2, 128, 2048, [[2047], [2048, 1333]],
                    (None, 512)),
                   ("recurrentgemma", 10, 1, 256, 3072, [[3000],
                                                         [3072, 2049]],
                    (2048, None))]
    for label, H, KVH, dh, max_len, lens_sets, windows in split_cases:
        MP = max_len // ps
        for lens in lens_sets:
            for window in windows:
                what = (f"{label} H={H} KVH={KVH} dh={dh} split walk, B="
                        f"{len(lens)} lens={lens} window={window}")
                x = _step_inputs(gen, len(lens), H, KVH, dh, ps, MP,
                                 torch.tensor(lens), dtype)
                P = x["k"].shape[0]
                args = (x["q"], x["kn"], x["vn"])
                out, ko, vo = paged_decode_step(*args, x["k"].clone(),
                                                x["v"].clone(), x["table"],
                                                x["lens"], window=window)
                ref, kr, vr = paged_decode_step_ref(*args, x["k"].clone(),
                                                    x["v"].clone(),
                                                    x["table"], x["lens"],
                                                    window=window)
                torch.cuda.synchronize()
                errs.check("paged_decode_step", dtype_name, out, ref,
                           f"paged_decode_step {dtype_name} {what}")
                if not (torch.equal(ko[:P - 1], kr[:P - 1])
                        and torch.equal(vo[:P - 1], vr[:P - 1])):
                    raise AssertionError(f"paged_decode_step {dtype_name} "
                                         f"{what}: pools differ outside the "
                                         f"trash page")


def check_flash(errs, dtype_name):
    """qwen2.5-3b's prefill shape (H=16, KVH=2, dh=128),
    recurrentgemma-2b's (H=10, KVH=1, dh=256, window 2048), and head dims
    the bf16 kernel zero-pads to its 64 and 256 buckets (8, 24, 192)."""
    import torch
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [(16, 2, 128, S, w) for S in (1, 17, 128, 1000, 2048)
             for w in (None, 256)]
    cases += [(10, 1, 256, S, w) for S in (1, 17, 2048, 2600)
              for w in (None, 2048)]
    cases += [(10, 1, dh, S, w) for dh in (8, 24, 192) for S in (5, 100, 1000)
              for w in (None, 40)]
    for H, KVH, dh, S, window in cases:
        f = lambda h: torch.randn((1, h, S, dh), generator=gen,
                                  device="cuda").to(dtype)
        q, k, v = f(H), f(KVH), f(KVH)
        out = flash_attention(q, k, v, causal=True, window=window)
        ref = flash_attention_ref(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        errs.check("flash_attention", dtype_name, out, ref,
                   f"flash_attention {dtype_name} H={H} KVH={KVH} dh={dh} "
                   f"S={S} window={window}")


def check_paged_attention(errs, dtype_name):
    """Read-only paged attention over the decode step's edge set, whose
    lens include 0 (a row with no valid token: the uniform mean over all
    MP·ps entries) and FREE rows."""
    import torch
    from repro_torch.kernels import paged_decode_attention
    from repro_torch.kernels.ref import paged_decode_attention_ref
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(11)
    for H, KVH, dh, ps, max_len in ((16, 2, 128, 16, 2048),
                                    (10, 1, 256, 16, 3072)):
        B, MP = 8, max_len // ps
        full = MP * ps
        edge = torch.tensor([0, 1, ps - 1, ps, ps + 1, full, 700, 1500])
        cases = [("edge lens", edge, None, ()),
                 ("edge lens, window 100", edge, 100, ()),
                 ("FREE rows 2 and 5", torch.tensor(
                     [300, 9, 0, 47, 1024, 5, 17, 2048]), None, (2, 5)),
                 ("random lens, window 512", torch.randint(
                     0, full + 1, (B,), generator=torch.Generator()
                     .manual_seed(8)), 512, ())]
        for what, lens, window, free in cases:
            x = _step_inputs(gen, B, H, KVH, dh, ps, MP, lens, dtype, free)
            args = (x["q"], x["k"], x["v"], x["table"], x["lens"])
            out = paged_decode_attention(*args, window=window)
            ref = paged_decode_attention_ref(*args, window=window)
            torch.cuda.synchronize()
            errs.check("paged_decode_attention", dtype_name, out, ref,
                       f"paged_decode_attention {dtype_name} H={H} dh={dh} "
                       f"{what}")


def _ring_inputs(gen, B, H, KVH, W, dh, fills, dtype):
    """Ring caches: row b holds positions fill-W..fill-1 (all of 0..fill-1
    when fill <= W) at slots pos % W; empty slots keep random garbage."""
    import torch
    spos = torch.full((B, W), -1, dtype=torch.int32)
    for b, fill in enumerate(fills):
        t = torch.arange(max(fill - W, 0), fill)
        spos[b, t % W] = t.to(torch.int32)
    f = lambda *shape: torch.randn(shape, generator=gen,
                                   device="cuda").to(dtype)
    return (f(B, H, dh), f(B, W, KVH, dh), f(B, W, KVH, dh),
            spos.to("cuda"),
            torch.tensor([n - 1 for n in fills], dtype=torch.int32,
                         device="cuda"))


# the fuzz harness's ring buckets (tests/test_kernel_fuzz.py)
DECODE_BUCKETS = [(2, 4, 2, 32, 32, None), (2, 4, 1, 64, 16, 24),
                  (1, 8, 8, 32, 16, None), (3, 2, 2, 64, 32, 16),
                  (2, 4, 2, 64, 16, None), (1, 2, 1, 32, 64, 8)]


def check_decode(errs, dtype_name):
    """Ring decode at recurrentgemma-2b's serving shape (8 slots, 10/1
    heads, dh 256, W = window = 2048; rings filled to 1, W-1, W and
    wrapped past W), qwen2.5-3b's striped shape (16/2 heads, dh 128, a
    linear 2048 cache) and the fuzz buckets."""
    import torch
    from repro_torch.kernels import decode_attention
    from repro_torch.kernels.ref import decode_attention_ref
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(12)
    rng = torch.Generator().manual_seed(13)
    W = 2048
    serving = [1, W - 1, W, W + 1, 3000, 2 * W, 5000, 100]
    cases = [("recurrentgemma", 8, 10, 1, W, 256, serving, w)
             for w in (2048, None)]
    cases.append(("qwen", 8, 16, 2, W, 128,
                  [1, 17, 500, 1024, W - 1, W, 300, 64], None))
    for bi, (B, H, KVH, Wb, dh, window) in enumerate(DECODE_BUCKETS):
        for i in range(3):
            fills = torch.randint(1, 2 * Wb + 1, (B,), generator=rng)
            cases.append((f"fuzz bucket {bi}", B, H, KVH, Wb, dh,
                          fills.tolist(), window))
    for what, B, H, KVH, Wc, dh, fills, window in cases:
        args = _ring_inputs(gen, B, H, KVH, Wc, dh, fills, dtype)
        out = decode_attention(*args, window=window)
        ref = decode_attention_ref(*args, window=window)
        torch.cuda.synchronize()
        errs.check("decode_attention", dtype_name, out, ref,
                   f"decode_attention {dtype_name} {what} fills={fills} "
                   f"window={window}")


def check_scan(errs, dtype_name):
    """RG-LRU scan at recurrentgemma-2b's width (d 2560; S = 1, 17, 1000,
    2600; B = 1, 8; and the many-chunk S 4096 at B 1, S 1000 at B 3) and
    tests/test_kernels.py's sweep shapes."""
    import torch
    from repro_torch.kernels import rglru_scan
    from repro_torch.kernels.ref import rglru_scan_ref
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(14)
    shapes = [(B, S, 2560) for B in (1, 8) for S in (1, 17, 1000, 2600)]
    shapes += [(2, 512, 256), (1, 1024, 128), (3, 256, 384), (1, 64, 128)]
    # many chunks a chain: long prompts, a few rows
    shapes += [(1, 4096, 2560), (3, 1000, 2560)]
    for B, S, d in shapes:
        a = (0.7 + 0.299 * torch.rand((B, S, d), generator=gen,
                                      device="cuda")).to(dtype)
        b = (0.1 * torch.randn((B, S, d), generator=gen,
                               device="cuda")).to(dtype)
        h0 = torch.randn((B, d), generator=gen, device="cuda")
        out = rglru_scan(a, b, h0)
        ref = rglru_scan_ref(a, b, h0)
        torch.cuda.synchronize()
        errs.check("rglru_scan", dtype_name, out, ref,
                   f"rglru_scan {dtype_name} B={B} S={S} d={d}",
                   tol=SCAN_TOL[dtype_name])


def _mlstm_inputs(gen, B, H, S, dh, gates, dtype):
    """q, k (scaled by 1/sqrt(dh)), v in ``dtype``; fp32 gate
    pre-activations: "normal" (forget bias +3), "big_i" (input gate up to
    ~40: the stabiliser at work) or "forget" (forget gate near -30: the
    state forgets every token)."""
    import torch
    f = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa
    q, k, v = f(B, H, S, dh), f(B, H, S, dh) / math.sqrt(dh), f(B, H, S, dh)
    i_pre, f_pre = f(B, H, S), f(B, H, S) + 3.0
    if gates == "big_i":
        i_pre = i_pre * 10.0 + 20.0
    elif gates == "forget":
        f_pre = f_pre - 33.0
    return q.to(dtype), k.to(dtype), v.to(dtype), i_pre, f_pre


def check_mlstm(errs, dtype_name):
    """Chunkwise mLSTM, h and the final (C, n, m), at xlstm-1.3b's prefill
    shapes (H=4, dh=1024: B 1 and 4 at S 1024 as the engines give it; S =
    1, below the 64-token chunk, a chunk multiple, ragged) and at dh 64
    and 256 with B*H > 1, over normal and extreme gates.  h takes the
    dtype's tolerance; C, n and m are fp32 from the same inputs on both
    sides and take the fp32 one in either dtype."""
    import torch
    from repro_torch.kernels import mlstm_chunkwise
    from repro_torch.kernels.ref import (mlstm_chunkwise_ref,
                                         mlstm_parallel_f64)
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(21)
    cases = [(1, 4, S, 1024, g) for S, g in ((1, "normal"), (37, "normal"),
                                             (128, "big_i"), (1000, "normal"),
                                             (200, "forget"),
                                             (1024, "normal"))]
    cases += [(4, 4, 1024, 1024, "normal"), (2, 4, 130, 1024, "normal"),
              (2, 3, 129, 256, "normal"), (1, 8, 1024, 256, "normal"),
              (4, 2, 64, 64, "big_i"), (3, 2, 333, 64, "forget")]
    state_tol = MLSTM_TOL["float32"]
    for B, H, S, dh, gates in cases:
        args = _mlstm_inputs(gen, B, H, S, dh, gates, dtype)
        h, state = mlstm_chunkwise(*args)
        hr, state_r = mlstm_chunkwise_ref(*args)
        torch.cuda.synchronize()
        what = f"mlstm_chunkwise {dtype_name} B={B} H={H} S={S} dh={dh} {gates}"
        errs.check("mlstm_chunkwise", dtype_name, h, hr, f"{what} h",
                   tol=MLSTM_TOL[dtype_name])
        for name, a, b in zip(("C", "n", "m"), state, state_r):
            errs.check("mlstm_chunkwise", dtype_name, a, b, f"{what} {name}",
                       tol=state_tol)
        del args, h, state, hr, state_r
    # A large input gate over a long prompt leaves e^{-m} no floor under the
    # normaliser: rows whose |q.n + sum w| cancels far below its terms are
    # ill-conditioned, and any two summation orders disagree there by far
    # more than the plain tolerance.  C, n and m never pass through that
    # normaliser and take the fp32 tolerance against the plain loop; h is
    # held to the fp64 parallel form within tol (1 + scale), scale being
    # each output's conditioning.  The plain fp32 loop's share of the same
    # bound is printed beside the kernel's.
    B, H, S, dh = 1, 8, 1024, 256
    args = _mlstm_inputs(gen, B, H, S, dh, "big_i", dtype)
    h, state = mlstm_chunkwise(*args)
    hr, state_r = mlstm_chunkwise_ref(*args)
    h64, scale, _ = mlstm_parallel_f64(*args)
    torch.cuda.synchronize()
    what = f"mlstm_chunkwise {dtype_name} B={B} H={H} S={S} dh={dh} big_i"
    for name, a, b in zip(("C", "n", "m"), state, state_r):
        errs.check("mlstm_chunkwise", dtype_name, a, b, f"{what} {name}",
                   tol=state_tol)
    tol = MLSTM_TOL[dtype_name]
    errs.check_scaled("mlstm_chunkwise", dtype_name, h, h64, scale,
                      f"{what} h (conditioned)", tol)
    share = lambda x: ((x.double() - h64).abs()  # noqa: E731
                       / (tol * (1.0 + scale))).max().item()
    log(f"[kernels] {what} (ill-conditioned normaliser, max scale "
        f"{scale.max().item():.4g}): share of tol (1 + scale) used by the "
        f"kernel {share(h):.4g}, by the plain loop {share(hr):.4g}; largest "
        f"share of tol (1 + |h|) used by the kernel "
        f"{((h.double() - h64).abs() / (tol * (1 + h64.abs()))).max().item():.4g}"
        f", by the plain loop "
        f"{((hr.double() - h64).abs() / (tol * (1 + h64.abs()))).max().item():.4g}")


def time_mlstm():
    """One mLSTM layer's prefill at the serving shape: B=1, H=4, a
    1024-token prompt, dh=1024, bf16; and (``"S128"``) a 128-token prompt,
    where most serving prompts are and the 4 MiB-per-head state weighs
    more."""
    out = _time_mlstm(1024)
    out["S128"] = _time_mlstm(128)
    return out


def _time_mlstm(S):
    """The bound counts the two dh x dh products per token (q C and the
    state update), the causal q k^T and w v products inside each 64-token
    chunk and the n terms, at the bf16 peak; and each input, h and the
    final state once in memory."""
    import torch
    from repro_torch.kernels import mlstm_chunkwise
    from repro_torch.kernels.ref import MLSTM_CHUNK, mlstm_chunkwise_ref
    B, H, dh = 1, 4, 1024
    gen = torch.Generator(device="cuda").manual_seed(22)
    args = _mlstm_inputs(gen, B, H, S, dh, "normal", torch.bfloat16)
    ms = graph_ms(lambda: mlstm_chunkwise(*args), iters=10)
    enq = time_ms(lambda: mlstm_chunkwise(*args), iters=10)
    plain = time_ms(lambda: mlstm_chunkwise_ref(*args), iters=5)
    BH = B * H
    pairs = sum(n * (n + 1) // 2 for n in
                (min(MLSTM_CHUNK, S - t) for t in range(0, S, MLSTM_CHUNK)))
    flops = BH * (4 * S * dh * dh + 4 * pairs * dh + 4 * S * dh)
    n_bytes = (BH * S * dh * 2 * 4 + BH * S * 4 * 2
               + BH * (dh * dh + dh + 1) * 4)
    b_ms, by = bound_ms(n_bytes, flops, "bfloat16")
    return {"ms": ms, "enqueue_ms": enq, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
            "shape": f"B=1 H=4 S={S} dh=1024 bf16, fresh state (library: "
                     f"none, no single PyTorch call computes the chunkwise "
                     f"mLSTM recurrence)"}


def time_paged_step():
    """Kernel, plain and bound at a decode tick of the qwen2.5-3b serving
    phase's shape: 8 slots mid-generation, bf16; and (``"dh256"``) at
    recurrentgemma-2b's paged shape."""
    out = _time_paged_step(16, 2, 128, 128, None, (64, 1152), seed=3)
    out["dh256"] = _time_paged_step(10, 1, 256, 192, 2048, (64, 3000),
                                    seed=19)
    return out


def _time_paged_step(H, KVH, dh, MP, window, lens_range, seed):
    """One (B=8, ps=16, bf16) decode step; eight copies of the pools are
    cycled so each launch finds its K/V outside the 50 MB L2, as a
    many-layer step does.  The bound counts the stored rows the window
    admits, the new token's rows and the small operands."""
    import torch
    from repro_torch.kernels import paged_decode_step
    from repro_torch.kernels.ref import paged_decode_step_ref
    B, ps = 8, 16
    g = H // KVH
    lens = torch.randint(*lens_range, (B,),
                         generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    x = _step_inputs(gen, B, H, KVH, dh, ps, MP, lens, torch.bfloat16)
    pools = [(x["k"].clone(), x["v"].clone()) for _ in range(8)]
    it = {"i": 0}

    def run(fn):
        def call():
            k, v = pools[it["i"] % len(pools)]
            it["i"] += 1
            fn(x["q"], x["kn"], x["vn"], k, v, x["table"], x["lens"],
               window=window)
        return call
    ms = graph_ms(run(paged_decode_step))
    enq = time_ms(run(paged_decode_step))
    plain = time_ms(run(paged_decode_step_ref), iters=10)
    esz = 2
    stored = (lens - 1).clamp(min=0)
    if window is not None:                   # rows the window admits
        stored = stored.clamp(max=window - 1)
    stored = stored.sum().item()
    n_bytes = (2 * stored * KVH * dh * esz           # K and V rows read
               + 2 * B * H * dh * esz                 # q in, out
               + 4 * B * KVH * dh * esz               # new K/V in, rows out
               + sum(-(-int(n) // ps) for n in lens) * 4 + B * 4)
    flops = 4 * (stored + B) * KVH * g * dh
    b_ms, by = bound_ms(n_bytes, flops, "bfloat16")
    return {"ms": ms, "enqueue_ms": enq, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
            "shape": f"B=8 H={H} KVH={KVH} dh={dh} ps=16 MP={MP} window="
                     f"{window} bf16 lens={lens.tolist()} (library: none, "
                     f"no single PyTorch call appends into and attends over "
                     f"a paged pool)"}


def time_flash():
    """Kernel, plain, library call and bound at the longest prompt the
    serving phase prefills (S=1024), bf16 (the tensor-core kernel); the
    same in fp32 (``"fp32"``: the CUDA-core kernel) and bf16 at dh 256
    (``"dh256"``)."""
    out = _time_flash_qwen("bfloat16")
    out["fp32"] = _time_flash_qwen("float32")
    out["dh256"] = time_flash_dh256()
    return out


def _time_flash_qwen(dtype_name):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    B, H, KVH, S, dh = 1, 16, 2, 1024, 128
    gen = torch.Generator(device="cuda").manual_seed(5)
    f = lambda h: torch.randn((B, h, S, dh), generator=gen,
                              device="cuda").to(getattr(torch, dtype_name))
    q, k, v = f(H), f(KVH), f(KVH)
    ms = graph_ms(lambda: flash_attention(q, k, v))
    enq = time_ms(lambda: flash_attention(q, k, v))
    plain = time_ms(lambda: flash_attention_ref(q, k, v), iters=10)
    kr = k.repeat_interleave(H // KVH, dim=1)
    vr = v.repeat_interleave(H // KVH, dim=1)
    lib = graph_ms(lambda: F.scaled_dot_product_attention(q, kr, vr,
                                                          is_causal=True))
    pairs = S * (S + 1) // 2
    flops = 4 * pairs * dh * H * B
    esz = q.element_size()
    n_bytes = esz * (2 * B * H * S * dh + 2 * B * KVH * S * dh)
    b_ms, by = bound_ms(n_bytes, flops, dtype_name)
    kind = "bf16" if dtype_name == "bfloat16" else "fp32"
    return {"ms": ms, "enqueue_ms": enq, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib,
            "shape": f"B=1 H=16 KVH=2 S=1024 dh=128 causal {kind} "
                     f"(library: SDPA, GQA heads expanded outside the "
                     f"timing)"}


def time_flash_dh256():
    """recurrentgemma-2b's prefill attention: S=2048 (= its window, so
    causal), H=10, KVH=1, dh=256, bf16."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    B, H, KVH, S, dh = 1, 10, 1, 2048, 256
    gen = torch.Generator(device="cuda").manual_seed(15)
    f = lambda h: torch.randn((B, h, S, dh), generator=gen,
                              device="cuda").to(torch.bfloat16)
    q, k, v = f(H), f(KVH), f(KVH)
    ms = graph_ms(lambda: flash_attention(q, k, v, window=2048), iters=10)
    enq = time_ms(lambda: flash_attention(q, k, v, window=2048), iters=10)
    plain = time_ms(lambda: flash_attention_ref(q, k, v, window=2048),
                    iters=5)
    kr, vr = k.expand(B, H, S, dh).contiguous(), v.expand(B, H, S,
                                                          dh).contiguous()
    lib = graph_ms(lambda: F.scaled_dot_product_attention(q, kr, vr,
                                                          is_causal=True))
    flops = 4 * (S * (S + 1) // 2) * dh * H * B
    n_bytes = 2 * (2 * B * H * S * dh + 2 * B * KVH * S * dh)
    b_ms, by = bound_ms(n_bytes, flops, "bfloat16")
    return {"ms": ms, "enqueue_ms": enq, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib,
            "shape": "B=1 H=10 KVH=1 S=2048 dh=256 causal window 2048 bf16 "
                     "(library: SDPA, KV head expanded outside the timing)"}


def time_paged_attention():
    """The read-only walk at the decode step's timed shape (8 slots,
    16/2 heads, dh 128, bf16), eight pool copies cycled past the L2."""
    import torch
    from repro_torch.kernels import paged_decode_attention
    from repro_torch.kernels.ref import paged_decode_attention_ref
    B, H, KVH, dh, ps, MP = 8, 16, 2, 128, 16, 128
    g = H // KVH
    lens = torch.randint(64, 1152, (B,),
                         generator=torch.Generator().manual_seed(3))
    gen = torch.Generator(device="cuda").manual_seed(16)
    x = _step_inputs(gen, B, H, KVH, dh, ps, MP, lens, torch.bfloat16)
    pools = [(x["k"].clone(), x["v"].clone()) for _ in range(8)]
    it = {"i": 0}

    def run(fn):
        def call():
            k, v = pools[it["i"] % len(pools)]
            it["i"] += 1
            fn(x["q"], k, v, x["table"], x["lens"])
        return call
    ms = graph_ms(run(paged_decode_attention))
    enq = time_ms(run(paged_decode_attention))
    plain = time_ms(run(paged_decode_attention_ref), iters=10)
    n = lens.sum().item()
    n_bytes = (2 * n * KVH * dh * 2 + 2 * B * H * dh * 2
               + sum(-(-int(m) // ps) for m in lens) * 4 + B * 4)
    b_ms, by = bound_ms(n_bytes, 4 * n * KVH * g * dh, "bfloat16")
    return {"ms": ms, "enqueue_ms": enq, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
            "shape": f"B=8 H=16 KVH=2 dh=128 ps=16 MP=128 bf16 lens="
                     f"{lens.tolist()} (library: none, no single PyTorch "
                     f"call attends over a paged pool)"}


def time_decode():
    """A ring-decode step of recurrentgemma-2b's striped serving shape:
    8 slots with full wrapped rings of W = window = 2048, 10/1 heads,
    dh 256, bf16; and (``"qwen"``) qwen2.5-3b's striped shape: 8 slots of
    a 2048-token cache mid-generation (the paged step's timed lens), 16/2
    heads, dh 128, no window."""
    import torch
    W = 2048
    out = _time_decode(10, 1, 256, [W + 37 * b for b in range(8)], W, 17)
    lens = torch.randint(64, 1152, (8,),
                         generator=torch.Generator().manual_seed(3))
    out["qwen"] = _time_decode(16, 2, 128, lens.tolist(), None, 23)
    return out


def _time_decode(H, KVH, dh, fills, window, seed):
    """B = 8 slots, W = 2048, bf16; eight K/V copies cycled past the 50 MB
    L2.  The library yardstick is SDPA over the validity mask with the KV
    heads expanded outside the timing."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention
    from repro_torch.kernels.ref import decode_attention_ref
    B, W = 8, 2048
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, spos, pos = _ring_inputs(gen, B, H, KVH, W, dh, fills,
                                      torch.bfloat16)
    rings = [(k.clone(), v.clone()) for _ in range(8)]
    it = {"i": 0}

    def run(fn):
        def call():
            kk, vv = rings[it["i"] % len(rings)]
            it["i"] += 1
            fn(q, kk, vv, spos, pos, window=window)
        return call
    ms = graph_ms(run(decode_attention))
    enq = time_ms(run(decode_attention))
    plain = time_ms(run(decode_attention_ref), iters=10)
    sp, p2 = spos.long(), pos.long()[:, None]
    mask = (sp >= 0) & (sp <= p2)
    if window is not None:
        mask &= p2 - sp < window
    mask = mask[:, None, None, :]
    g = H // KVH
    kx = k.permute(0, 2, 1, 3).repeat_interleave(g, dim=1).contiguous()
    vx = v.permute(0, 2, 1, 3).repeat_interleave(g, dim=1).contiguous()
    lib = graph_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kx, vx, attn_mask=mask))
    n_valid = int(mask.sum().item())
    n_bytes = (2 * n_valid * KVH * dh * 2 + 2 * B * H * dh * 2
               + B * W * 4 + B * 4)
    b_ms, by = bound_ms(n_bytes, 4 * n_valid * H * dh, "bfloat16")
    return {"ms": ms, "enqueue_ms": enq, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib,
            "shape": f"B=8 H={H} KVH={KVH} W=2048 window {window} dh={dh} "
                     f"bf16, fills {fills} (library: SDPA with the boolean "
                     f"validity mask, KV heads expanded outside the "
                     f"timing)"}


def scan_copies(B, S, d, dtype_name, seed):
    """Input sets (a, b, h0) of one timed scan shape: enough copies that
    the sets one graph replay cycles through span 4x the L2, so each
    launch reads its inputs from device memory."""
    import torch
    dtype = getattr(torch, dtype_name)
    per_set = 2 * B * S * d * dtype.itemsize
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sets = []
    for _ in range(max(2, math.ceil(4 * L2_BYTES / per_set))):
        a = 0.7 + 0.299 * torch.rand((B, S, d), generator=gen, device="cuda")
        b = 0.1 * torch.randn((B, S, d), generator=gen, device="cuda")
        h0 = torch.randn((B, d), generator=gen, device="cuda")
        sets.append((a.to(dtype), b.to(dtype), h0))
    return sets


def cycling(fn, sets):
    """fn on the next input set at each call."""
    turn = {"i": -1}

    def call():
        turn["i"] = (turn["i"] + 1) % len(sets)
        return fn(*sets[turn["i"]])
    return call


def scan_times(fn, counts=(), plain=None):
    """The scan wrapper ``fn`` at each shape of SCAN_TIMED, inputs cycled
    cold: {key: {"ms" (``graph_ms``), "enqueue_ms" (eager), "plain_ms"
    (``plain`` on one input set, when given), "chunks", "forced": {n:
    ms}}}.  "chunks" is the count ``fn`` picks (None for a wrapper with
    no chunk count); ``counts`` are also timed forced, where ``fn`` takes
    a forced count."""
    import torch
    from repro_torch.kernels import _build
    out = {}
    for key, (B, S, d, dt) in SCAN_TIMED.items():
        sets = scan_copies(B, S, d, dt, 18)
        res = {"ms": graph_ms(cycling(fn, sets)),
               "enqueue_ms": time_ms(cycling(fn, sets)), "chunks": None,
               "forced": {}}
        if plain is not None:
            res["plain_ms"] = time_ms(lambda: plain(*sets[0]), iters=3,
                                      warmup=1)
        if hasattr(fn, "force_chunks"):
            from repro_torch.kernels.rglru_scan import (chunk_count,
                                                        effective_chunks)
            res["chunks"] = chunk_count(B, S, d, _build.dtype_code(
                getattr(torch, dt)), sets[0][0].device)
            for n in counts:
                fn.force_chunks = n
                try:
                    res["forced"][effective_chunks(S, n)] = graph_ms(
                        cycling(fn, sets))
                finally:
                    fn.force_chunks = None
        out[key] = res
        del sets
    return out


def time_scan():
    """The RG-LRU scan at SCAN_TIMED's shapes; a and b are fp32 on the
    model's path (the gates run in fp32), bf16 is timed beside."""
    import torch
    from repro_torch.kernels import rglru_scan
    from repro_torch.kernels.ref import rglru_scan_ref
    times = scan_times(rglru_scan, plain=rglru_scan_ref)
    out = {}
    for key, (B, S, d, dt) in SCAN_TIMED.items():
        t = times[key]
        n_bytes = 3 * B * S * d * getattr(torch, dt).itemsize + B * d * 4
        b_ms, by = bound_ms(n_bytes, 2 * B * S * d, "float32")
        out[key] = {
            "ms": t["ms"], "enqueue_ms": t["enqueue_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": b_ms, "bound_by": by,
            "library_ms": None, "chunks": t["chunks"],
            "shape": f"B={B} S={S} d={d} {dt}, {t['chunks']} chunks a "
                     f"chain, inputs cycled past the L2 (library: none, no "
                     f"single PyTorch call computes a linear recurrence)"}
    main = out.pop("main")
    main.update(out)
    return main


# ------------------------------------------------------------ phase 3
def drive(path: str, fn):
    """Run one serving path with every launch count set to 0 just before
    it and read just after; returns (fn's result, wall seconds, counts)."""
    import torch
    from repro_torch.kernels import KERNELS, reset_launch_counts
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.__name__: k.launches for k in KERNELS}
    PATH_LAUNCHES[path] = counts
    return out, wall, counts


def expect(path: str, counts, want) -> None:
    """Every kernel's launches on the path equal ``want`` (absent: 0)."""
    for name, n in counts.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{path}: {name} launched {n} times, want "
                                 f"{want.get(name, 0)} (all: {counts})")


def check_lengths(path, out, trace, vocab):
    for i, (_, n) in enumerate(trace):
        toks = out[i]
        if len(toks) != n or not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"{path} request {i}: {len(toks)} tokens, "
                                 f"want {n}")


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
    out, wall, launches = drive("qwen2.5-3b paged", eng.run)
    s = eng.stats
    seqs = eng.sched.finished
    fresh = sum(1 for q in seqs.values() if q.shared_tokens == 0)
    check_lengths("qwen2.5-3b paged", out, trace, cfg.vocab_size)
    expect("qwen2.5-3b paged", launches,
           {"paged_decode_step": N_LAYERS * s["decode_ticks"],
            "flash_attention": N_LAYERS * fresh})
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
    profile_ticks(eng, cfg.vocab_size, seed, "qwen2.5-3b paged")
    del eng
    torch.cuda.empty_cache()
    serve_striped_dense(cfg, params, seed)
    del params
    torch.cuda.empty_cache()


def serve_striped_dense(cfg, params, seed: int) -> None:
    """qwen2.5-3b through the striped ring layout: ``InferenceEngine`` (4
    prompts of 512 tokens, 32 new) and ``paged=False`` (6 requests), so
    the ring decode kernel is held at the dense shape on a serving path."""
    import numpy as np
    import torch
    from repro_torch.models import make_batch
    from repro_torch.serving import ContinuousBatchingEngine, InferenceEngine
    eng = InferenceEngine(cfg, params)
    batch = make_batch(cfg, 4, 512, seed=seed + 3, device="cuda")
    out, wall, counts = drive("qwen2.5-3b static",
                              lambda: eng.generate(batch, 32))
    if out.shape != (4, 32) or int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"static engine output {tuple(out.shape)}")
    expect("qwen2.5-3b static", counts,
           {"flash_attention": N_LAYERS,
            "decode_attention": N_LAYERS * 31})
    log(f"[serve] qwen2.5-3b InferenceEngine: 4 x (512 prompt, 32 new) = "
        f"128 tokens in {wall:.3f} s = {128 / wall:.1f} tok/s")
    rng = np.random.default_rng(seed + 4)
    trace = [(list(map(int, rng.integers(0, cfg.vocab_size, int(n)))),
              int(m)) for n, m in zip(rng.integers(64, 1025, 6),
                                      rng.integers(16, 49, 6))]
    eng = ContinuousBatchingEngine(cfg, params, n_slots=8, max_len=2048,
                                   paged=False)
    for i, (p, n) in enumerate(trace):
        eng.submit(p, n, req_id=i)
    out, wall, counts = drive("qwen2.5-3b striped", eng.run)
    s = eng.stats
    check_lengths("qwen2.5-3b striped", out, trace, cfg.vocab_size)
    expect("qwen2.5-3b striped", counts,
           {"flash_attention": N_LAYERS * s["prefills"],
            "decode_attention": N_LAYERS * s["decode_ticks"]})
    gen_tok = sum(len(v) for v in out.values())
    log(f"[serve] qwen2.5-3b striped (paged=False): {len(trace)} requests, "
        f"{gen_tok} tokens in {wall:.3f} s = {gen_tok / wall:.1f} tok/s; "
        f"decode_ticks={s['decode_ticks']} prefills={s['prefills']}")
    del eng
    torch.cuda.empty_cache()


def profile_ticks(eng, vocab: int, seed: int, label: str,
                  prompt: int = 256) -> None:
    """Where a serving tick's time goes: a short burst (8 requests,
    ``prompt`` prompt tokens, 24 new) under torch.profiler after the
    measured run; prints device-busy share of the wall time and the top
    kernels."""
    import numpy as np
    rng = np.random.default_rng(seed + 7)
    for i in range(8):
        eng.submit(list(map(int, rng.integers(0, vocab, prompt))), 24,
                   req_id=1000 + i)
    ticks0 = eng.stats["decode_ticks"]
    profile_call(eng.run, f"{label} 8 requests x ({prompt} prompt, 24 new)",
                 top=10)
    log(f"[profile] {label}: {eng.stats['decode_ticks'] - ticks0} decode "
        f"ticks in the profiled burst")


def profile_call(fn, label: str, top: int = 8) -> None:
    """One call of ``fn`` under torch.profiler: prints its wall time, the
    device-busy share and the ``top`` device kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
    # device-side events only (kernels, memcpy/memset): host operators
    # carry their kernels' time too and would count it twice
    rows = [(dev(e), e.key, e.count) for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and dev(e) > 0]
    busy = sum(r[0] for r in rows) / 1e6
    log(f"[profile] {label}: wall {wall:.4f} s, device busy {busy:.4f} s "
        f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%")
    for t, key, count in sorted(rows, reverse=True)[:top]:
        log(f"[profile] {label}  {t / 1e3:10.3f} ms  {count:6d}x  "
            f"{key[:90]}")


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
def teacher_forced(cfg, params, prompt, gen, what: str, layout: str):
    """Re-run one request teacher-forced through ``forward`` +
    ``decode_step`` with every kernel swapped for its plain version
    (``kernel_impl="plain"``: attention and the RG-LRU scan), on the paged
    or the striped cache; every engine token must equal the reference
    argmax where the top-2 margin exceeds MARGIN.  Returns (checked,
    skipped)."""
    import torch
    from repro_torch.models import (cache_from_prefill, decode_step,
                                    forward, init_paged_cache,
                                    paged_prefill_scatter, pages_for)
    total = len(prompt) + len(gen)
    toks = torch.tensor([prompt], device="cuda")
    o = forward(cfg, params, {"tokens": toks}, build_cache=True,
                kernel_impl="plain", last_only=True)
    if layout == "paged":
        npg = pages_for(total, 16)
        cache = init_paged_cache(cfg, 1, page_size=16, n_pages=npg,
                                 max_pages=npg, device="cuda")
        cache["pages"] = torch.arange(npg, dtype=torch.int32,
                                      device="cuda")[None]
        paged_prefill_scatter(cfg, cache, o["kv"], 0, cache["pages"][0],
                              len(prompt))
    else:
        cache = cache_from_prefill(cfg, o["kv"], total, len(prompt))
    logits = o["logits"][0, -1]
    checked = skipped = 0
    for j, got in enumerate(gen):
        if j:
            logits, cache = decode_step(
                cfg, params, cache, torch.tensor([gen[j - 1]], device="cuda"),
                cache["pos"], kernel_impl="plain")
            logits = logits[0]
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{what} token {j}: non-finite reference "
                                 f"logits")
        top2 = torch.topk(logits.float(), 2)
        margin = (top2.values[0] - top2.values[1]).item()
        if margin <= MARGIN:
            skipped += 1
            continue
        checked += 1
        if int(top2.indices[0]) != got:
            raise AssertionError(
                f"{what} token {j}: engine {got} vs reference "
                f"{int(top2.indices[0])} (margin {margin:.3g})")
    return checked, skipped


def check_fp32(seed: int):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
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
        c, k = teacher_forced(cfg, params, prompt, out[i],
                              f"qwen2.5-3b request {i}", "paged")
        checked, skipped = checked + c, skipped + k
    if checked < (checked + skipped) // 2:
        raise AssertionError(f"only {checked} tokens cleared the margin")
    log(f"[fp32] qwen2.5-3b full width fp32: {len(trace)} requests, "
        f"{checked} engine tokens equal the plain teacher-forced argmax, "
        f"{skipped} skipped (top-2 margin <= {MARGIN}); shared_tokens="
        f"{eng.stats['shared_tokens']}")
    del eng, params
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 5
def hybrid_trace(vocab: int, seed: int):
    """12 requests, prompts 64..2600 tokens, 32..128 new.  The 2600-token
    prompt is longer than the 2048 ring (the keep-last-W prefill), and
    2000 + 100 and 1990 + 128 cross 2048 during decode (ring wrap)."""
    import numpy as np
    rng = np.random.default_rng(seed + 20)
    lens_new = [(2600, 32), (2000, 100), (64, 128), (300, 64), (1024, 48),
                (700, 96), (1500, 32), (128, 128), (900, 80), (1990, 128),
                (400, 56), (64, 32)]
    return [(list(map(int, rng.integers(0, vocab, n))), m)
            for n, m in lens_new]


def hybrid_config():
    from repro_torch.configs import get_config
    cfg = get_config("recurrentgemma-2b")
    mixers = [cfg.layer_pattern[i % cfg.pattern_len].split(":")[0]
              for i in range(cfg.n_layers)]
    assert (cfg.d_model, cfg.n_layers, cfg.window) == (2560, 26, 2048)
    assert mixers.count("attn") == HYBRID_ATTN
    assert mixers.count("rec") == HYBRID_REC
    return cfg


def serve_hybrid(seed: int) -> None:
    """Full-width recurrentgemma-2b in bf16 on three paths in turn, with
    every kernel's launches asserted per path."""
    import torch
    from repro_torch.models import init_params, make_batch
    from repro_torch.serving import ContinuousBatchingEngine, InferenceEngine
    cfg = hybrid_config()
    params = init_params(cfg, seed=seed, dtype=torch.bfloat16, device="cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[serve] recurrentgemma-2b full width: {n_params / 1e9:.3f}B "
        f"params, bf16")

    eng = InferenceEngine(cfg, params)
    batch = make_batch(cfg, 8, 1024, seed=seed + 21, device="cuda")
    out, wall, counts = drive("recurrentgemma-2b static",
                              lambda: eng.generate(batch, 64))
    if out.shape != (8, 64) or int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"static engine output {tuple(out.shape)}")
    expect("recurrentgemma-2b static", counts,
           {"rglru_scan": HYBRID_REC, "flash_attention": HYBRID_ATTN,
            "decode_attention": HYBRID_ATTN * 63})
    log(f"[serve] recurrentgemma-2b InferenceEngine: 8 x (1024 prompt, 64 "
        f"new) = 512 tokens in {wall:.3f} s = {512 / wall:.1f} tok/s "
        f"(wall time incl. prefill); launches {counts}")
    del eng, batch, out
    torch.cuda.empty_cache()

    trace = hybrid_trace(cfg.vocab_size, seed)
    for paged in (False, True):
        path = f"recurrentgemma-2b {'paged' if paged else 'striped'}"
        eng = ContinuousBatchingEngine(cfg, params, n_slots=8, max_len=3072,
                                       page_size=16, paged=paged)
        for i, (p, n) in enumerate(trace):
            eng.submit(p, n, req_id=i)
        out, wall, counts = drive(path, eng.run)
        s = eng.stats
        check_lengths(path, out, trace, cfg.vocab_size)
        want = {"rglru_scan": HYBRID_REC * s["prefills"],
                "flash_attention": HYBRID_ATTN * s["prefills"]}
        want["paged_decode_step" if paged else "decode_attention"] = \
            HYBRID_ATTN * s["decode_ticks"]
        expect(path, counts, want)
        if eng.prefix_sharing or s["prefills"] != len(trace):
            raise AssertionError(f"{path}: prefix sharing on or a prompt "
                                 f"not prefilled once ({s})")
        gen_tok = sum(len(v) for v in out.values())
        log(f"[serve] {path}: {len(trace)} requests, {gen_tok} tokens in "
            f"{wall:.3f} s = {gen_tok / wall:.1f} tok/s (wall time incl. "
            f"prefill); decode_ticks={s['decode_ticks']} decode_tokens="
            f"{s['decode_tokens']} prefills={s['prefills']}; launches "
            f"{counts}")
        if paged:
            profile_ticks(eng, cfg.vocab_size, seed, "recurrentgemma-2b paged")
        del eng, out
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 6
def check_hybrid_fp32(seed: int) -> None:
    """recurrentgemma-2b in fp32 on the static, striped and paged paths:
    three 300-token prompts (one static batch), and on the continuous
    engines a 2100-token prompt past the window too; every token is held
    to the plain teacher-forced argmax on the striped cache."""
    import numpy as np
    import torch
    from repro_torch.models import init_params
    from repro_torch.serving import ContinuousBatchingEngine, InferenceEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = hybrid_config()
    params = init_params(cfg, seed=seed, dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(seed + 22)
    tok = lambda n: list(map(int, rng.integers(0, cfg.vocab_size, n)))
    short = [tok(300) for _ in range(3)]
    trace = [(p, 24) for p in short] + [(tok(2100), 24)]
    gen = {"static": dict(enumerate(InferenceEngine(cfg, params).generate(
        {"tokens": torch.tensor(short, device="cuda")}, 24).tolist()))}
    for paged in (False, True):
        eng = ContinuousBatchingEngine(cfg, params, n_slots=4, max_len=2200,
                                       page_size=16, paged=paged)
        for i, (p, n) in enumerate(trace):
            eng.submit(p, n, req_id=i)
        gen["paged" if paged else "striped"] = eng.run()
        del eng
    checked = skipped = 0
    for path, outs in gen.items():
        for i, toks in outs.items():
            c, k = teacher_forced(cfg, params, trace[i][0], toks,
                                  f"recurrentgemma-2b {path} request {i}",
                                  "striped")
            checked, skipped = checked + c, skipped + k
    if checked < (checked + skipped) // 2:
        raise AssertionError(f"only {checked} tokens cleared the margin")
    log(f"[fp32] recurrentgemma-2b full width fp32: static (3 requests), "
        f"striped and paged (4 requests each, one 2100-token prompt): "
        f"{checked} engine tokens equal the plain teacher-forced argmax "
        f"(plain attention and plain scan), {skipped} skipped (top-2 "
        f"margin <= {MARGIN})")
    del params
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 7
def ssm_config():
    from repro_torch.configs import get_config
    cfg = get_config("xlstm-1.3b")
    mixers = [cfg.layer_pattern[i % cfg.pattern_len].split(":")[0]
              for i in range(cfg.n_layers)]
    assert (cfg.d_model, cfg.n_layers, cfg.d_inner // cfg.n_heads) == \
        (2048, 48, 1024)
    assert mixers.count("mlstm") == SSM_MLSTM
    assert mixers.count("slstm") == SSM_SLSTM
    return cfg


def ssm_trace(vocab: int, seed: int):
    """12 requests, prompts of 64..1024 tokens (ten of them not a multiple
    of the kernel's 64-token chunk), 32..128 new tokens."""
    import numpy as np
    rng = np.random.default_rng(seed + 30)
    lens_new = [(1024, 32), (64, 128), (1000, 48), (333, 96), (777, 64),
                (129, 128), (900, 40), (500, 112), (65, 32), (1023, 80),
                (250, 56), (611, 100)]
    return [(list(map(int, rng.integers(0, vocab, n))), m)
            for n, m in lens_new]


def serve_ssm(seed: int) -> None:
    """Full-width xlstm-1.3b in bf16 on the three paths in turn: the
    kernel's launches asserted per path, no attention kernel launched, and
    the paged and striped engines give the same tokens."""
    import torch
    from repro_torch.models import init_params, make_batch
    from repro_torch.serving import ContinuousBatchingEngine, InferenceEngine
    cfg = ssm_config()
    params = init_params(cfg, seed=seed, dtype=torch.bfloat16, device="cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[serve] xlstm-1.3b full width: {n_params / 1e9:.3f}B params "
        f"(config param_count {cfg.param_count() / 1e9:.3f}B), bf16")

    eng = InferenceEngine(cfg, params)
    batch = make_batch(cfg, 4, 1024, seed=seed + 31, device="cuda")
    out, wall, counts = drive("xlstm-1.3b static",
                              lambda: eng.generate(batch, 32))
    if out.shape != (4, 32) or int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"static engine output {tuple(out.shape)}")
    expect("xlstm-1.3b static", counts, {"mlstm_chunkwise": SSM_MLSTM})
    log(f"[serve] xlstm-1.3b InferenceEngine: 4 x (1024 prompt, 32 new) = "
        f"128 tokens in {wall:.3f} s = {128 / wall:.1f} tok/s (wall time "
        f"incl. prefill); launches {counts}")
    del eng, batch, out
    torch.cuda.empty_cache()

    trace = ssm_trace(cfg.vocab_size, seed)
    tokens = {}
    for paged in (True, False):
        path = f"xlstm-1.3b {'paged' if paged else 'striped'}"
        eng = ContinuousBatchingEngine(cfg, params, n_slots=8, max_len=1152,
                                       page_size=16, paged=paged)
        for i, (p, n) in enumerate(trace):
            eng.submit(p, n, req_id=i)
        out, wall, counts = drive(path, eng.run)
        s = eng.stats
        check_lengths(path, out, trace, cfg.vocab_size)
        expect(path, counts, {"mlstm_chunkwise": SSM_MLSTM * s["prefills"]})
        if eng.prefix_sharing or s["prefills"] != len(trace):
            raise AssertionError(f"{path}: prefix sharing on or a prompt "
                                 f"not prefilled once ({s})")
        if paged and any("k" in e for e in eng.cache["layers"]):
            raise AssertionError(f"{path}: the cache holds K/V pools")
        tokens[path] = out
        tick = decode_tick_ms(cfg, params, eng.cache)
        gen_tok = sum(len(v) for v in out.values())
        log(f"[serve] {path}: {len(trace)} requests, {gen_tok} tokens in "
            f"{wall:.3f} s = {gen_tok / wall:.1f} tok/s (wall time incl. "
            f"prefill); decode_ticks={s['decode_ticks']} "
            f"({1e3 * wall / max(s['decode_ticks'], 1):.2f} ms of wall "
            f"time per tick) decode_tokens={s['decode_tokens']} "
            f"prefills={s['prefills']}; launches {counts}; a decode tick "
            f"of all 8 slots alone: {tick:.2f} ms")
        if paged:
            # 64-token prompts: the sLSTM prefill loop launches ~150
            # kernels a token, and a longer burst's trace takes minutes
            # to summarise
            profile_ticks(eng, cfg.vocab_size, seed, "xlstm-1.3b paged",
                          prompt=64)
        del eng, out
        torch.cuda.empty_cache()
    if tokens["xlstm-1.3b paged"] != tokens["xlstm-1.3b striped"]:
        raise AssertionError("xlstm-1.3b: the paged and striped engines "
                             "gave different tokens")
    log("[serve] xlstm-1.3b paged and striped engines: the same tokens for "
        "all 12 requests")
    del params
    torch.cuda.empty_cache()


def decode_tick_ms(cfg, params, cache, n: int = 10) -> float:
    """Host-clock ms of one pooled ``decode_step`` over every slot of an
    engine's cache, after its run (every slot FREE; a later prefill
    overwrites a slot's whole state), averaged over ``n`` steps."""
    import torch
    from repro_torch.models import decode_step
    tok = torch.zeros(cache["pos"].shape, dtype=torch.int64, device="cuda")
    decode_step(cfg, params, cache, tok, cache["pos"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        decode_step(cfg, params, cache, tok, cache["pos"])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


# ------------------------------------------------------------ phase 8
def check_ssm_fp32(seed: int) -> None:
    """xlstm-1.3b in fp32 on the static, striped and paged paths: three
    300-token prompts (one static batch), and on the continuous engines a
    ragged 777-token prompt too; every token is held to the plain
    teacher-forced argmax (the plain mLSTM chunk loop) on the striped
    cache."""
    import numpy as np
    import torch
    from repro_torch.models import init_params
    from repro_torch.serving import ContinuousBatchingEngine, InferenceEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ssm_config()
    params = init_params(cfg, seed=seed, dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(seed + 32)
    tok = lambda n: list(map(int, rng.integers(0, cfg.vocab_size, n)))
    short = [tok(300) for _ in range(3)]
    trace = [(p, 24) for p in short] + [(tok(777), 24)]
    gen = {"static": dict(enumerate(InferenceEngine(cfg, params).generate(
        {"tokens": torch.tensor(short, device="cuda")}, 24).tolist()))}
    for paged in (False, True):
        eng = ContinuousBatchingEngine(cfg, params, n_slots=4, max_len=832,
                                       page_size=16, paged=paged)
        for i, (p, n) in enumerate(trace):
            eng.submit(p, n, req_id=i)
        gen["paged" if paged else "striped"] = eng.run()
        del eng
    checked = skipped = 0
    for path, outs in gen.items():
        for i, toks in outs.items():
            c, k = teacher_forced(cfg, params, trace[i][0], toks,
                                  f"xlstm-1.3b {path} request {i}",
                                  "striped")
            checked, skipped = checked + c, skipped + k
    if checked < (checked + skipped) // 2:
        raise AssertionError(f"only {checked} tokens cleared the margin")
    log(f"[fp32] xlstm-1.3b full width fp32: static (3 requests), striped "
        f"and paged (4 requests each, one a ragged 777-token prompt): "
        f"{checked} engine tokens equal the plain teacher-forced argmax "
        f"(plain mLSTM chunk loop), {skipped} skipped (top-2 margin <= "
        f"{MARGIN})")
    del params
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 9
EWL_BLOCKS = 4             # 9 layers a block: block = pipeline stage
EWL_NODES = 4              # 1 source + 3 receivers, all on cuda:0


def ewl_trace(vocab: int, seed: int, n: int = 8):
    """``n`` requests, prompts 64..512 tokens, 24..48 new tokens."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [(list(map(int, rng.integers(0, vocab, int(p)))), int(m))
            for p, m in zip(rng.integers(64, 513, n),
                            rng.integers(24, 49, n))]


def multicast_blocks(cfg, params):
    """Pack qwen2.5-3b into EWL_BLOCKS blocks, multicast them 1 → EWL_NODES
    with the λPipe schedule over node buffers that all live on cuda:0, and
    check every node's bytes and node 3's unpacked weights against the
    source bit for bit.  Returns node 3's buffer and specs."""
    import torch
    from repro_torch.core.blocks import (block_assignment, flatten_params,
                                         pack_model, unpack_flat)
    from repro_torch.core.ewl import plan_scale
    from repro_torch.core.partial_exec import layer_range_of_units
    from repro_torch.distributed import multicast
    ranges = [layer_range_of_units(u)
              for u in block_assignment(cfg, EWL_BLOCKS)]
    if [hi - lo for lo, hi in ranges] != [N_LAYERS // EWL_BLOCKS] * \
            EWL_BLOCKS:
        raise AssertionError(f"blocks are not 9 layers each: {ranges}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stacked, specs = pack_model(cfg, params, EWL_BLOCKS)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    plan = plan_scale(EWL_NODES, EWL_BLOCKS, k=1)
    bufs = [stacked] + [torch.zeros_like(stacked)
                        for _ in range(EWL_NODES - 1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    multicast(bufs, plan.schedule)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = sum(len(step) for step in plan.schedule.steps)
    moved = rows * stacked.shape[1]
    for n, buf in enumerate(bufs):
        if not torch.equal(buf, stacked):
            raise AssertionError(f"multicast: node {n}'s blocks differ")
    src = flatten_params(cfg, params)
    got = unpack_flat(bufs[-1], specs)
    if sorted(got) != sorted(src) or not all(
            got[k].dtype == t.dtype and torch.equal(got[k], t)
            for k, t in src.items()):
        raise AssertionError("node 3's unpacked weights differ from the "
                             "source's")
    log(f"[ewl] pack_model: {EWL_BLOCKS} blocks x {stacked.shape[1] / 1e9:.3f}"
        f" GB padded ({sum(sp.nbytes for sp in specs) / 1e9:.3f} GB of "
        f"tensors) in {pack_s:.3f} s; multicast 1 -> {EWL_NODES} "
        f"({plan.schedule.n_steps} steps, {rows} block rows = "
        f"{moved / 1e9:.3f} GB) in {wall * 1e3:.2f} ms = "
        f"{moved / wall / 1e9:.1f} GB/s device-local copy rate (all nodes "
        f"on cuda:0, staged row copies; no network); every node's buffer "
        f"equals the source, node 3's {len(got)} tensors bit-equal")
    keep = bufs[-1]
    del bufs, stacked
    torch.cuda.empty_cache()
    return keep, specs


def serve_ewl(seed: int) -> None:
    """Full-width qwen2.5-3b bf16 execute-while-load: multicast the blocks,
    serve on the 4-stage pipelined engine built from node 3's blocks,
    drain, hand off and adopt into a paged engine on node 3's weights,
    then prefill/decode disaggregation over the PackedKV wire."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.blocks import unflatten_params, unpack_flat
    from repro_torch.distributed import PipelinedEngine, stages_from_flat
    from repro_torch.models import init_params
    cfg = get_config("qwen2.5-3b")
    params = init_params(cfg, seed=seed, dtype=torch.bfloat16, device="cuda")
    node3, specs = multicast_blocks(cfg, params)
    del params
    torch.cuda.empty_cache()
    flat = unpack_flat(node3, specs)
    stages = stages_from_flat(cfg, flat, EWL_BLOCKS, ["cuda"] * EWL_BLOCKS)
    pipe = PipelinedEngine.from_stages(cfg, stages, n_microbatches=2,
                                       n_slots=8, max_len=1024, pad_to=64,
                                       max_prefill_per_tick=1)
    trace = ewl_trace(cfg.vocab_size, seed + 40)
    pipelined_then_local(cfg, pipe, unflatten_params(cfg, flat), trace,
                         "qwen2.5-3b", "node 3's blocks", ticks=6)
    disaggregate(cfg, unflatten_params(cfg, flat),
                 ewl_trace(cfg.vocab_size, seed + 41))
    del pipe, stages, flat, node3
    torch.cuda.empty_cache()


def pipelined_then_local(cfg, pipe, params, trace, label: str, source: str,
                         ticks: int):
    """Serve ``trace`` on the pipelined engine for ``ticks`` ticks, drain,
    hand off and adopt into a paged engine that runs to the end; every
    request finishes once with its full budget, no adopted sequence is
    prefilled, and the launches match the work.  Returns the finished
    sequences by request id."""
    import torch
    from repro_torch.serving import ContinuousBatchingEngine
    for i, (p, n) in enumerate(trace):
        pipe.submit(p, n, req_id=i)
    path = f"{label} pipelined (EWL)"
    M = 2
    tick_ms = []

    def serve():
        for t in range(ticks):
            t0 = time.perf_counter()
            # the last tick, the fullest, under the profiler: where its
            # time goes (step() ends in a host read, so the clock is fair)
            if t == ticks - 1:
                profile_call(pipe.step, f"{label} pipelined tick")
            else:
                pipe.step()
            tick_ms.append(1e3 * (time.perf_counter() - t0))
    _, _, counts = drive(path, serve)
    expect(path, counts, {"flash_attention": N_LAYERS * M * ticks})
    pipe.drain()
    pairs = pipe.handoff()
    started = sum(1 for q, _ in pairs if q.generated)
    queued = len(pairs) - started
    local = ContinuousBatchingEngine(cfg, params, n_slots=8, max_len=1024,
                                     page_size=16, prefix_sharing=True)

    def switch():
        local.adopt(pairs)
        return local.run()
    path2 = f"{label} mode switch + local"
    _, wall2, counts2 = drive(path2, switch)
    s = local.stats
    fresh = sum(1 for q in local.sched.finished.values()
                if not q.shared_tokens) - started
    if s["adopted"] != started or s["prefills"] != queued or not started:
        raise AssertionError(f"{path2}: adopted {s['adopted']} of {started} "
                             f"started, {s['prefills']} prefills for "
                             f"{queued} queued")
    expect(path2, counts2,
           {"flash_attention": N_LAYERS * (started + fresh),
            "paged_decode_step": N_LAYERS * s["decode_ticks"]})
    done = dict(pipe.sched.finished)
    if set(done) & set(local.sched.finished):
        raise AssertionError(f"{label}: a request finished twice")
    done.update(local.sched.finished)
    out = {r: q.generated for r, q in done.items()}
    check_lengths(path2, out, trace, cfg.vocab_size)
    log(f"[ewl] {label} pipelined engine ({EWL_BLOCKS} stages x "
        f"{N_LAYERS // EWL_BLOCKS} layers from {source}, {M} microbatches, "
        f"{pipe.n_slots} slots, pad_to {pipe.pad_to}): {ticks} ticks, "
        f"{sum(tick_ms[:-1]) / (ticks - 1):.1f} ms a tick over the first "
        f"{ticks - 1} (wall time; each: "
        f"{', '.join(f'{t:.1f}' for t in tick_ms[:-1])} ms; the last ran "
        f"under the profiler); {pipe.stats['prefills']} prompts admitted; "
        f"mode switch: "
        f"{started} adopted (cache recomputed once each), {queued} queued "
        f"prefilled fresh, 0 re-prefills; local engine {s['decode_ticks']}"
        f" decode ticks in {wall2:.3f} s; launches {counts} then {counts2}")
    del local
    torch.cuda.empty_cache()
    return done


def disaggregate(cfg, params, trace) -> None:
    """A prefill-role engine streams each prefilled slot out
    (``export_prefilled``) and a decode-role engine adopts it; each
    adopted slot's pages, read back with ``paged_pack``, equal the
    exported payload's bytes."""
    import torch
    from repro_torch.models import paged_pack
    from repro_torch.serving import ContinuousBatchingEngine
    kw = dict(n_slots=8, max_len=1024, page_size=16, prefix_sharing=True)
    pre = ContinuousBatchingEngine(cfg, params, role="prefill",
                                   max_prefill_per_tick=8, **kw)
    dec = ContinuousBatchingEngine(cfg, params, role="decode", **kw)
    for i, (p, n) in enumerate(trace):
        pre.submit(p, n, req_id=i)
    checked = []

    def run():
        while pre.step() or pre.sched.prefilled_slots():
            pairs = pre.export_prefilled()
            dec.adopt(pairs)
            for seq, payload in pairs:
                slot = next((i for i, q in enumerate(dec.sched.slots)
                             if q is seq), None)
                if slot is None:
                    raise AssertionError(f"disagg: request {seq.req_id} "
                                         f"parked instead of adopted")
                ids = dec.pages.slot_pages(slot)
                back = paged_pack(cfg, dec.cache, slot, ids,
                                  payload.n_tokens, 16,
                                  ship=[ids[p] for p in payload.carried])
                for a, b in zip(_leaves(back.kv), _leaves(payload.kv)):
                    if not torch.equal(a, b):
                        raise AssertionError(
                            f"disagg: request {seq.req_id}'s adopted "
                            f"pages differ from the exported payload")
                checked.append(payload.nbytes)
            dec.step()
        return dec.run()
    out, wall, counts = drive("qwen2.5-3b disagg", run)
    check_lengths("qwen2.5-3b disagg", out, trace, cfg.vocab_size)
    ps, ds = pre.stats, dec.stats
    if len(checked) != len(trace) or ds["prefills"] or \
            ps["exported"] != len(trace):
        raise AssertionError(f"disagg: {len(checked)} payloads checked, "
                             f"prefill {ps}, decode {ds}")
    expect("qwen2.5-3b disagg", counts,
           {"flash_attention": N_LAYERS * ps["prefills"],
            "paged_decode_step": N_LAYERS * ds["decode_ticks"]})
    log(f"[ewl] qwen2.5-3b disaggregation: {len(trace)} prompts prefilled, "
        f"exported ({sum(checked) / 1e6:.1f} MB of PackedKV) and adopted; "
        f"every adopted slot's pages byte-equal to its payload; "
        f"{ds['decode_ticks']} decode ticks, {wall:.3f} s in all; launches "
        f"{counts}")
    del pre, dec
    torch.cuda.empty_cache()


def check_ewl_fp32(seed: int) -> None:
    """The pipelined-then-adopted path in fp32 on 3 requests (stages cut
    from the weights: no multicast), each token held to the plain
    teacher-forced argmax."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import PipelinedEngine, stage_params
    from repro_torch.models import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("qwen2.5-3b")
    params = init_params(cfg, seed=seed, dtype=torch.float32, device="cuda")
    stages = stage_params(cfg, params, EWL_BLOCKS, ["cuda"] * EWL_BLOCKS)
    pipe = PipelinedEngine.from_stages(cfg, stages, n_microbatches=2,
                                       n_slots=4, max_len=1024, pad_to=64,
                                       max_prefill_per_tick=1)
    trace = [(p, 24) for p, _ in ewl_trace(cfg.vocab_size, seed + 42, 3)]
    done = pipelined_then_local(cfg, pipe, params, trace, "qwen2.5-3b fp32",
                                "the weights", ticks=5)
    checked = skipped = 0
    for i, (prompt, _) in enumerate(trace):
        c, k = teacher_forced(cfg, params, prompt, done[i].generated,
                              f"qwen2.5-3b EWL request {i}", "paged")
        checked, skipped = checked + c, skipped + k
    if checked < (checked + skipped) // 2:
        raise AssertionError(f"only {checked} tokens cleared the margin")
    log(f"[fp32] qwen2.5-3b EWL fp32: {len(trace)} requests through the "
        f"pipelined engine and the mode switch, {checked} tokens equal the "
        f"plain teacher-forced argmax, {skipped} skipped (top-2 margin <= "
        f"{MARGIN})")
    del pipe, stages, params
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
            if ("registers" in line or "spill" in line
                    or "Function properties" in line):
                log(f"[ptxas {name}] {line.strip()}")
    check_hmma()
    log(f"[phase] 1 (build, ptxas, sass) in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    errs = ErrLog()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for dt in ("float32", "bfloat16"):
        check_paged_step(errs, dt)
        check_flash(errs, dt)
        check_paged_attention(errs, dt)
        check_decode(errs, dt)
        check_scan(errs, dt)
        check_mlstm(errs, dt)
    log(f"[kernels] all cases within tolerance; max |kernel - plain| "
        f"(largest share of the tolerance used): "
        + ", ".join(f"{n} {d} {e:.3g} ({errs.used[(n, d)]:.3g})"
                    for (n, d), e in errs.err.items()))
    timing = {"paged_decode_step": time_paged_step(),
              "flash_attention": time_flash(),
              "paged_decode_attention": time_paged_attention(),
              "decode_attention": time_decode(),
              "rglru_scan": time_scan(),
              "mlstm_chunkwise": time_mlstm()}
    log(f"[phase] 2 (kernels against their plain versions, timings) in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, t in timing.items():
        for tag, tt in [(name, t)] + [(f"{name} {x}", t[x]) for x in EXTRA
                                      if x in t]:
            if tt:
                log(f"[time] {tag}: kernel_ms={tt['ms']:.5f} enqueue_ms="
                    f"{tt['enqueue_ms']:.5f} plain_ms="
                    f"{tt['plain_ms']:.4f} library_ms={tt['library_ms']} "
                    f"bound_ms={tt['bound_ms']:.5f} ({tt['bound_by']}) at "
                    f"{tt['shape']}")
    log(f"[scan] chunks a chain: " + ", ".join(
        f"{k} {timing['rglru_scan'][k]['chunks']}" for k in SCAN_TIMED
        if k != "main") + f", main {timing['rglru_scan']['chunks']}")

    t0 = time.perf_counter()
    serve_full_width(args.seed)
    log(f"[phase] 3 (qwen2.5-3b serving) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_fp32(args.seed)
    log(f"[phase] 4 (qwen2.5-3b fp32) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serve_hybrid(args.seed)
    log(f"[phase] 5 (recurrentgemma-2b serving) in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_hybrid_fp32(args.seed)
    log(f"[phase] 6 (recurrentgemma-2b fp32) in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serve_ssm(args.seed)
    log(f"[phase] 7 (xlstm-1.3b serving) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_ssm_fp32(args.seed)
    log(f"[phase] 8 (xlstm-1.3b fp32) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serve_ewl(args.seed)
    check_ewl_fp32(args.seed)
    log(f"[phase] 9 (qwen2.5-3b execute-while-load) in "
        f"{time.perf_counter() - t0:.1f} s")

    csrc = "src/repro_torch/kernels/csrc/"
    meta = {"paged_decode_step": (csrc + "paged_decode_step.cu",
                                  "src/repro/kernels/paged_attention.py:227"),
            "flash_attention": (csrc + "flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:83"),
            "paged_decode_attention": (
                csrc + "paged_decode_step.cu",
                "src/repro/kernels/paged_attention.py:173"),
            "decode_attention": (csrc + "decode_attention.cu",
                                 "src/repro/kernels/decode_attention.py:63"),
            "rglru_scan": (csrc + "rglru_scan.cu",
                           "src/repro/kernels/rglru_scan.py:42"),
            "mlstm_chunkwise": (csrc + "mlstm_chunkwise.cu",
                                "src/repro/kernels/mlstm_chunk.py:91")}
    # paged_decode_attention lies on no serving path in either package:
    # only the phase 2 checks launch it, so its path count is 0
    off_path = {"paged_decode_attention"}
    kernels = []
    for name, (source, replaces) in meta.items():
        t = timing[name]
        e32 = errs.err[(name, "float32")]
        e16 = errs.err[(name, "bfloat16")]
        by_path = {p: c[name] for p, c in PATH_LAUNCHES.items() if c[name]}
        launches = sum(by_path.values())
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "launches_by_path": by_path, "on_serving_path":
                name not in off_path,
            "max_abs_err": max(e32, e16), "max_abs_err_fp32": e32,
            "max_abs_err_bf16": e16, "max_err": max(e32, e16),
            "ms": t["ms"], "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": t["shape"]}
        for extra in EXTRA:
            if extra in t:
                entry[extra] = t[extra]
        kernels.append(entry)
        if not math.isfinite(t["ms"]) or (launches <= 0
                                          and name not in off_path):
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
