#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

  python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero, with no result line):
  1. build every CUDA kernel of ``src/repro_torch/kernels/csrc`` (one nvcc
     per source, in parallel), print the card's name and power limit and
     each kernel's registers and spills, and count the HMMA (tensor-core)
     instructions of every kernel in ``cuobjdump -sass``: each bf16
     flash, decode-walk and mLSTM kernel and each fp32 one (3xTF32 on
     tf32 ``mma``: flash, the decode walks and the mLSTM's column
     kernel) must have some, the fp32 mLSTM's three
     passes before it (CUDA cores) none, and no fp32 tensor-core kernel
     may spill (``MMA_KERNELS``; the spills from the nvcc output kept
     beside each library);
  2. hold each kernel against its plain PyTorch version on the card, in
     fp32 (TF32 off) and bf16, at the test tolerances (2e-5 and 2e-2 for
     attention, 1e-4 and 5e-2 for the RG-LRU scan), at the serving paths'
     shapes and at the edge cases (for the fused step also one and two
     slots with long lens, the split walk's few-slot ticks; for flash also
     head dims the kernels pad; fp32 flash, the fp32 mLSTM at S 1024, the
     fp32 fused step and the fp32 ring also against an fp64 run, at most
     FP64_FACTOR times the fp32 plain version's error); time
     the kernel on the device (CUDA graph replay; the per-call enqueue
     time of eager launches beside it),
     its plain version and, where one exists, a PyTorch library call
     computing the same function (a yardstick the port never calls);
     flash is timed in bf16 and fp32 (two kernels; fp32 at every fp32
     serving shape, ``FLASH_TIMED``, beside SDPA in fp32 and the name of
     the kernel SDPA launches, read by ``torch.profiler``), the ring decode
     also at qwen2.5-3b's striped shape, mLSTM also at a 128-token prompt,
     the scan at four shapes (``SCAN_TIMED``) with its inputs cycled past
     the L2 and the chunk count each one used; the decode walks and the
     mLSTM also in fp32 at their main shapes (3xTF32), the mLSTM also at
     a 128-token prompt in fp32;
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
     wherever the reference's top-2 logit margin exceeds MARGIN (the
     launches counted and asserted on the path, as on 6 and 8);
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
     fp32 on 3 requests held to the plain teacher-forced argmax;
 10. the live cluster (``serving.cluster.LiveCluster``, every node on
     cuda:0) at full width: (a) the ``--live`` shape, qwen2.5-3b hot on
     node 0 of 8 scaling to 3 new nodes while stablelm-1.6b scales from
     a host-warm copy to 3 more, with 24 requests served through λPipe
     pipelines mid-multicast and local replicas after the mode switch
     (every node's wire bytes equal the registry, one receiver per model
     unpacked bit-equal to its source, every request finished once with
     its budget, at least one adopted and none re-prefilled per model,
     one tick with all eight engines profiled; the execution pipelines
     eager by rule, each engine's prefill graphs printed); (b) the
     ``--autoscale``
     shape, qwen2.5-3b from zero replicas under the autoscaler on the
     simulated clock, up from the host tier and down after its
     keep-alive, each scale-down freeing at least a replica's device
     bytes; (c) qwen2.5-3b, then stablelm-1.6b, in fp32 on 4 nodes:
     ``forward`` on two token batches at every multicast step, the
     serving pipeline's ``forward_fn`` at ``last=`` rows and every
     node's local forward after the scale held to the plain fp32
     forward within CLUSTER_FP32_TOL of its largest logit, and 4
     requests prefilled in the pipeline, adopted at the mode switch (at
     least 2) and held to the plain teacher-forced argmax.  decode-step
     launches == layers x every local engine's decode ticks on 10a and
     10c; flash launched on every path.  Phase 2 holds both kernels to
     their plain versions at stablelm-1.6b's shape too (32/32 heads,
     dh 64);
 11. the compiled step at full width: every ``ContinuousBatchingEngine``
     above decodes its first tick eagerly and replays a captured CUDA
     graph on every later tick (so the fp32 checks of phases 4, 6, 8 and
     10c hold graph replays to the plain forward); here qwen2.5-3b,
     recurrentgemma-2b and xlstm-1.3b, paged and striped, replay their
     graphs in fp32 against the eager ``decode_step`` on a clone of the
     same state (3 ticks, within GRAPH_TOL of the largest logit, argmax
     equal), and in bf16 the wall time of a decode tick of 8 live slots,
     eager (functional and in place) against a replay; each engine's
     capture time and graph-pool bytes are printed (also on the serving
     lines of phases 3, 5, 7 and 10a);
 12. the remaining families, random weights from the seed, one model on
     the card at a time: (a) full-width qwen2-moe-a2.7b (24 layers, 60
     experts top-4 + a shared expert) in bf16 through the paged engine
     (prefix sharing) and the striped engine on one 12-request trace and
     ``InferenceEngine`` at 4 x 512, a replayed decode tick of 8 live
     slots beside its weight-read bound (the static dispatch reads every
     expert) and the grouped prefill's ms a prompt token; (b)
     llama4-maverick at full width, depth cut to 2 layers (dense, then 128
     experts), paged on 8 requests; (c) full pixtral-12b, ``InferenceEngine``
     on 4 x (64 patch embeddings + 256 text tokens) and paged on a text
     trace; (d) whisper-large-v3, ``InferenceEngine`` on 4 x (1500 frames +
     64 tokens), 32 non-causal and 32 causal flash launches a prefill;
     launch counts asserted on every path; (e) fp32: qwen2-moe at depth
     4 (paged, striped, static; its decode graphs replayed against the
     eager step within GRAPH_TOL), pixtral at depth 2 (static with
     patches, paged, striped) and whisper (static with frames), every
     token held to the plain teacher-forced argmax; (f) the live cluster
     on qwen2-moe at depth 4 in fp32, as 10c, with 8 requests (path
     ``cluster-fp32-moe``);
 13. training and the last serve modes: (a) full-width qwen2.5-3b in fp32
     through ``Trainer`` on the Markov corpus (2 x 512 tokens a step, 8
     steps): every loss finite, the last nll below the first, ms a step,
     tokens/s and peak device GB beside the reckoned 16 B a parameter;
     (b) at the first batch the training loss (plain path, gradients)
     equals the no-grad kernel forward's (36 flash launches, path
     ``train-kernel-loss``) within 1e-5; the training steps launch no
     kernel (path ``train``); (c) 2-layer full-width qwen2.5-3b, every
     gradient leaf on the card within 1e-4 relative L2 of the CPU's; (d)
     2-layer full-width stablelm-1.6b, 3 steps of ``adamw_update``
     against ``torch.optim.AdamW`` on the same gradients (update, mu and
     nu within 1e-5); (e) a 4-layer qwen2.5-3b checkpoint round trip with
     bit-equal logits, and one qwen2-moe training step with aux > 0; (f)
     ``launch/serve.py`` --slo, --disagg and --overload at full width in
     bf16 (paths ``serve-slo``, ``serve-disagg``, ``serve-overload``,
     paged-step and flash launches nonzero), then every
     ``examples/torch_*.py`` at its defaults;
 14. the dry-run and fit stack (``launch.dryrun``, no device): (a)
     ``run_one`` (four records at a time, each in a worker process of
     its own) at full width on the 16x16 placeholder mesh for every
     arch on decode_32k and long_500k (skipped exactly where
     ``specs.applicable`` skips, as in JAX), qwen2.5-3b and qwen2-moe on
     train_4k and prefill_32k, their prefill also under ``tuned-moe``,
     and one ``dryrun_ewl`` record, each printed on a line of its own
     (any error fails); (b) the fit check: on a one-rank mesh the
     dry-run predicts the peak device memory of 13a's fp32 training step
     (2 x 512) and of a bf16 ``decode_step`` of 8 slots at max_len
     32768, each then measured on the card (``max_memory_allocated``)
     and held to the prediction within FIT_TOL; (c) the card's bf16
     matmul rate and copy bandwidth beside the dry-run's constants;
 15. the compiled prefills (every engine above already prefills through
     them: a bucket's first prefill eager, then captured, later ones
     replayed; ``graph_note`` prints each bucket's capture seconds, pool
     MiB and replays): (a) in fp32 at full width, qwen2.5-3b paged with
     prefix sharing (fresh and suffix prefills) and striped,
     recurrentgemma-2b and xlstm-1.3b paged, each through three engines
     on one trace (captured; the same padded steps eager; the unpadded
     steps): tick by tick the captured cache bitwise equal to the eager
     one and within PAD_TOL (PAD_TOL_ARCH) of the unpadded one, launch
     counts equal, first tokens equal; xlstm's state gap split by
     ``padding_gap`` (the sLSTM input product at two row counts; the
     padding held in fp64; the padded fp32 state held to the gap that
     batching the prompt gives); pixtral-12b (depth 4, with patches) and
     whisper-large-v3 (frames) on ``InferenceEngine`` (exact shapes,
     unpadded), prefill and decode captured against eager and against a
     direct ``forward``; (b) the bf16 burst of
     ``profile_ticks`` twice on a fresh paged engine of qwen2.5-3b,
     recurrentgemma-2b and xlstm-1.3b, wall, busy and idle share of
     the first (capturing) and second (replaying) pass beside the same
     burst with eager prefills (``EAGER_BURST``);
     (c) ``InferenceEngine``'s decode tick at 4 x 512 eager vs replayed;
     (d) the λPipe tick (4 stages, 2 microbatches, 8 x 512) eager vs
     replayed, logits bitwise equal; the steps still eager on the card,
     each by a stated rule, are printed (``EAGER_BY_RULE``).
Each path is driven with every launch count set to 0 just before it and
read just after; a graph replay adds the launches its capture recorded.
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
# dense, per type; "tf32x3": fp32 products as three TF32 tensor-core
# products (495 TFLOP/s), the fp32 flash kernel's
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32x3": 495e12 / 3}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernel_fuzz.py
SCAN_TOL = {"float32": 1e-4, "bfloat16": 5e-2}   # tests/test_kernels.py
MLSTM_TOL = {"float32": 2e-4, "bfloat16": 5e-2}  # tests/test_kernels.py
MARGIN = 1e-3                  # top-2 logit margin for the fp32 check
FP64_FACTOR = 4.0              # fp32 kernel vs fp64: x the plain fp32 error
N_LAYERS = 36                  # qwen2.5-3b: every layer is attention
HYBRID_ATTN, HYBRID_REC = 8, 18   # recurrentgemma-2b's 26 layers
SSM_MLSTM, SSM_SLSTM = 42, 6      # xlstm-1.3b's 48 layers
PATH_LAUNCHES = {}             # path name -> {kernel: launches in that run}
# further timed shapes of a kernel, beside its main one: each kernel in
# fp32 (flash's at every fp32 serving shape, the mLSTM's also at a short
# prompt), dh 256, the ring decode at
# qwen2.5-3b's shape, a short prompt and the scan at a short prompt, the
# static batch and in bf16; phase 12's families: qwen2-moe, pixtral and
# llama4 heads, whisper's encoder (flash, non-causal) and decoder (ring
# decode)
EXTRA = ("fp32", "fp32_dh256", "fp32_stablelm", "fp32_whisper_enc",
         "fp32_S128", "dh256", "qwen", "S128", "S256", "B8", "bf16", "moe",
         "pixtral", "llama4", "whisper_enc", "whisper")
# flash's fp32 serving shapes (H, KVH, S, dh, causal, window): qwen2.5-3b's
# longest timed prompt, recurrentgemma-2b's (window 2048 = S, so causal:
# SDPA, the yardstick, takes no window), stablelm-1.6b's in the live
# cluster, whisper's encoder over 1500 frames
FLASH_TIMED = {"qwen": (16, 2, 1024, 128, True, None),
               "dh256": (10, 1, 2048, 256, True, 2048),
               "stablelm": (32, 32, 512, 64, True, None),
               "whisper_enc": (20, 20, 1500, 64, False, None)}
# flash's bf16 timed shapes: qwen2.5-3b's longest timed prompt (the main
# entry), recurrentgemma-2b's, qwen2-moe's heads, whisper's encoder
FLASH_BF16_TIMED = {"qwen": (16, 2, 1024, 128, True, None),
                    "dh256": (10, 1, 2048, 256, True, 2048),
                    "moe": (16, 16, 1024, 128, True, None),
                    "whisper_enc": (20, 20, 1500, 64, False, None)}
# graph replays (and eager calls) a flash timing takes; 50 at other shapes
FLASH_ITERS = {"dh256": 10}
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


def _kind(dtype_name: str) -> str:
    return "bf16" if dtype_name == "bfloat16" else "fp32"


def bound_ms(n_bytes: float, flops: float, dtype: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


SASS_OPS = ("HMMA", "HGMMA", "UTMALDG")


def sass_counts(source: str):
    """{kernel function: {opcode: instructions}} for the tensor-core
    opcodes of ``SASS_OPS`` (``mma.sync`` HMMA, ``wgmma`` HGMMA, tensor-map
    TMA loads UTMALDG) in the built library of ``csrc/<source>.cu``, from
    ``cuobjdump -sass`` (the CUDA toolkit's, beside nvcc)."""
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
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn is not None:
            words = line.replace(".", " ").replace(";", " ").split()
            for op in SASS_OPS:
                if op in words:
                    counts[fn][op] += 1
    return counts


# Kernel functions of each source by how they use the tensor cores:
# "wgmma" (the bf16 flash kernel: HGMMA and UTMALDG, no HMMA), "bf16" (the
# other bf16 kernels: HMMA) and "tf32" (every fp32 product kernel as
# 3xTF32: HMMA), or not at all, "cuda" (no HMMA: the fp32 mLSTM's
# pre-pass, whose q k^T is fp32 fma chains, and its two carry passes):
# source -> {mangled-name fragment: kind}, the mLSTM's in launch order.  An
# "If" template argument is a decode kernel's fp32 walk (one instance per
# head-dim bucket).  A "tf32" or "wgmma" kernel must not spill.
MMA_KERNELS = {
    "flash_attention": {"flash_wgmma_kernel": "wgmma",
                        "flash_tf32x3_kernel": "tf32"},
    "decode_attention": {"decode_attention_kernelI13__nv_bfloat16": "bf16",
                         "decode_attention_kernelIf": "tf32"},
    "paged_decode_step": {
        "paged_decode_step_kernelI13__nv_bfloat16": "bf16",
        "paged_decode_step_kernelIf": "tf32",
        "paged_decode_attention_kernelI13__nv_bfloat16": "bf16",
        "paged_decode_attention_kernelIf": "tf32"},
    "mlstm_chunkwise": {"mlstm_scores_mma": "bf16",
                        "mlstm_chunkwise_mma": "bf16",
                        "mlstm_local_f32": "cuda",
                        "mlstm_scan_f32": "cuda",
                        "mlstm_carry_f32": "cuda",
                        "mlstm_chunkwise_tf32": "tf32"},
}
# opcodes each kind must have (> 0) and must not have
SASS_RULES = {"wgmma": (("HGMMA", "UTMALDG"), ("HMMA",)),
              "bf16": (("HMMA",), ()), "tf32": (("HMMA",), ()),
              "cuda": ((), ("HMMA",))}


def ptxas_spills(text: str):
    """{mangled kernel name: spill bytes (stores + loads)} from ``ptxas
    -v`` output: each "Function properties for NAME" line is followed by
    its "N bytes spill stores, M bytes spill loads" line."""
    out, fn = {}, None
    for line in text.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for", 1)[1].strip()
        elif fn is not None and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            out[fn] = nums[1] + nums[2]     # stack frame, stores, loads
            fn = None
    return out


def check_hmma() -> None:
    """Print the tensor-core opcode counts of every kernel function of
    MMA_KERNELS' sources and assert each kind's ``SASS_RULES`` (the bf16
    flash kernel: HGMMA and UTMALDG, no HMMA; other bf16 and tf32 ones:
    HMMA; cuda ones: none), and that no tf32 or wgmma one spills (``ptxas
    -v``); every listed fragment must name at least one function."""
    from repro_torch.kernels import _build
    for source, kinds in MMA_KERNELS.items():
        counts = sass_counts(source)
        spills = ptxas_spills(_build.ptxas_output(source))
        for frag, kind in kinds.items():
            fns = {fn: n for fn, n in counts.items() if frag in fn}
            if not fns:
                raise AssertionError(f"{source}: no kernel function named "
                                     f"like {frag} in {sorted(counts)}")
            need, forbid = SASS_RULES[kind]
            for fn, ops in sorted(fns.items()):
                spill = spills.get(fn)
                log(f"[sass {source}] "
                    + ", ".join(f"{ops[op]} {op}" for op in SASS_OPS)
                    + f" in {fn} ({kind}); spill bytes {spill}")
                if (any(ops[op] == 0 for op in need)
                        or any(ops[op] > 0 for op in forbid)):
                    raise AssertionError(
                        f"{source}: {fn} has {ops}; its {kind} kernel must "
                        f"have {' and '.join(need) or 'no tensor-core op'}"
                        + (f" and no {', '.join(forbid)}" if forbid else ""))
                if kind in ("tf32", "wgmma") and spill != 0:
                    raise AssertionError(f"{source}: {fn} spills {spill} "
                                         f"bytes (or ptxas printed none)")


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
    dh 128, a 2048-token pool), recurrentgemma-2b's (8 slots, 10/1
    heads: g = 10 query heads per CTA, more than its 8 warps; dh 256; a
    3072-token pool, window 2048 on and off), stablelm-1.6b's in the
    live cluster (8 slots, 32/32 heads: group 1; dh 64; a 1024-token
    pool, no window), qwen2-moe's (16/16, dh 128), pixtral's (32/8, dh
    128) and llama4's (40/8, dh 128, a 10240-token pool, window 8192 on
    and off), over edge lens, FREE rows and a NaN trash page;
    then one and two slots with long lens at every shape (the split
    walk's few-slot ticks).  The pools must be byte-equal outside the
    trash page."""
    import torch
    from repro_torch.kernels import paged_decode_step
    from repro_torch.kernels.ref import paged_decode_step_ref
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(1)
    B, ps = 8, 16
    # (label, H, KVH, dh, max_len, edge lens, FREE-case lens (rows 2 and 5
    # FREE), window of the edge case, window of the FREE and random cases;
    # None: the model has no window, and its windowed cases are dropped)
    shapes = [("qwen", 16, 2, 128, 2048, [0, 1, ps - 1, ps, ps + 1, 2048,
                                          700, 1500],
               [300, 9, 0, 47, 1024, 0, 17, 2048], 100, 512),
              ("recurrentgemma", 10, 1, 256, 3072,
               [0, 1, ps + 1, 2048, 2049, 2600, 3072, 1500],
               [2500, 9, 0, 47, 2049, 0, 17, 3072], 2048, 2048),
              ("stablelm", 32, 32, 64, 1024, [0, 1, ps - 1, ps, ps + 1, 1024,
                                              700, 333],
               [300, 9, 0, 47, 1024, 0, 17, 1000], None, None),
              ("qwen2-moe", 16, 16, 128, 2048, [0, 1, ps - 1, ps, ps + 1,
                                                2048, 700, 1500],
               [300, 9, 0, 47, 1024, 0, 17, 2048], None, None),
              ("pixtral", 32, 8, 128, 2048, [0, 1, ps - 1, ps, ps + 1, 2048,
                                             700, 1500],
               [300, 9, 0, 47, 1024, 0, 17, 2048], None, None),
              ("llama4", 40, 8, 128, 10240, [0, 1, ps + 1, 8191, 8192, 8193,
                                             10240, 5000],
               [9000, 9, 0, 47, 8193, 0, 17, 10240], 8192, 8192)]
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
        if w_edge is None:
            cases = [cases[0], cases[2], cases[4]]
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
                    (2048, None)),
                   ("stablelm", 32, 32, 64, 1024, [[1023], [1024, 517]],
                    (None,))]
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
    recurrentgemma-2b's (H=10, KVH=1, dh=256, window 2048),
    stablelm-1.6b's in the live cluster (H=32, KVH=32, dh=64, no window,
    prompts up to 512), head dims the bf16 kernel zero-pads to its 64
    and 256 buckets (8, 24, 192), and phase 12's: qwen2-moe (16/16, dh
    128), pixtral (32/8), llama4 (40/8, window 8192), whisper (20/20, dh
    64) non-causal over its 1500 encoder frames and causal in its
    decoder.  Then the transposed views ``layers.full_attention`` passes
    (heads of a (B,S,heads,dh) projection) at the qwen, recurrentgemma,
    whisper and llama4 shapes: the bf16 kernel reads them in place and
    writes an output with q's strides."""
    import torch
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [(16, 2, 128, S, w, True) for S in (1, 17, 128, 1000, 2048)
             for w in (None, 256)]
    cases += [(10, 1, 256, S, w, True) for S in (1, 17, 2048, 2600)
              for w in (None, 2048)]
    cases += [(32, 32, 64, S, None, True) for S in (1, 17, 64, 300, 512)]
    cases += [(10, 1, dh, S, w, True) for dh in (8, 24, 192)
              for S in (5, 100, 1000) for w in (None, 40)]
    # qwen2-moe, pixtral (64 patches + text), llama4 (window 8192)
    cases += [(16, 16, 128, S, None, True) for S in (17, 1024)]
    cases += [(32, 8, 128, S, None, True) for S in (17, 320)]
    cases += [(40, 8, 128, S, 8192, True) for S in (17, 1000)]
    # whisper: the encoder over 1500 frames (non-causal), the decoder
    cases += [(20, 20, 64, S, None, False) for S in (17, 1500)]
    cases += [(20, 20, 64, S, None, True) for S in (64, 448)]
    for H, KVH, dh, S, window, causal in cases:
        f = lambda h: torch.randn((1, h, S, dh), generator=gen,
                                  device="cuda").to(dtype)
        q, k, v = f(H), f(KVH), f(KVH)
        out = flash_attention(q, k, v, causal=causal, window=window)
        ref = flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        errs.check("flash_attention", dtype_name, out, ref,
                   f"flash_attention {dtype_name} H={H} KVH={KVH} dh={dh} "
                   f"S={S} window={window} causal={causal}")
    strided = [(16, 2, 128, S, None, True) for S in (17, 1000)]
    strided += [(10, 1, 256, 2600, 2048, True),
                (20, 20, 64, 1500, None, False),
                (40, 8, 128, 1000, 8192, True)]
    for H, KVH, dh, S, window, causal in strided:
        f = lambda h: torch.randn((2, S, h, dh), generator=gen,
                                  device="cuda").to(dtype).transpose(1, 2)
        q, k, v = f(H), f(KVH), f(KVH)
        out = flash_attention(q, k, v, causal=causal, window=window)
        ref = flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        what = (f"flash_attention {dtype_name} strided B=2 H={H} KVH={KVH} "
                f"dh={dh} S={S} window={window} causal={causal}")
        errs.check("flash_attention", dtype_name, out, ref, what)
        if dtype_name == "bfloat16" and out.stride() != q.stride():
            raise AssertionError(f"{what}: out strides {out.stride()}, q's "
                                 f"{q.stride()}")


def vs_fp64(what, got, plain, exact, floor=0.0):
    """The kernel's largest error against an fp64 run, at most FP64_FACTOR
    times the fp32 plain version's own, or than ``floor`` where that is
    larger (a quantity the plain version happens to hit to the last bit:
    the fp32 spacing at its largest value)."""
    e_kernel = (got.double() - exact).abs().max().item()
    e_plain = (plain.double() - exact).abs().max().item()
    log(f"[fp64] {what}: max |kernel - fp64| {e_kernel:.4g}, max |plain "
        f"fp32 - fp64| {e_plain:.4g} (ratio "
        f"{e_kernel / max(e_plain, 1e-300):.3g})")
    if e_kernel > FP64_FACTOR * max(e_plain, floor):
        raise AssertionError(
            f"{what}: error {e_kernel:.4g} against fp64 above {FP64_FACTOR}x "
            f"the plain version's {e_plain:.4g} (floor {floor:.3g})")


def check_flash_fp64():
    """fp32 flash at ``FLASH_TIMED``'s shapes: the kernel's largest error
    against the plain version run in fp64, at most FP64_FACTOR times
    the fp32 plain version's own (3xTF32 keeps fp32 accuracy; one TF32
    product a piece would err ~1e-3)."""
    import torch
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    gen = torch.Generator(device="cuda").manual_seed(7)
    for key, (H, KVH, S, dh, causal, window) in FLASH_TIMED.items():
        x = [torch.randn((1, h, S, dh), generator=gen, device="cuda")
             for h in (H, KVH, KVH)]
        got = flash_attention(*x, causal=causal, window=window)
        plain = flash_attention_ref(*x, causal=causal, window=window)
        exact = flash_attention_ref(*(t.double() for t in x), causal=causal,
                                    window=window)
        vs_fp64(f"flash_attention fp32 {key}", got, plain, exact)


def _attend_f64(q, k, v, valid):
    """One query token a head in fp64: q (B,H,dh), k/v (B,N,KVH,dh),
    valid (B,N) -> (B,H,dh)."""
    import torch
    from repro_torch.kernels.ref import NEG_INF
    B, H, dh = q.shape
    KVH = k.shape[2]
    qg = q.double().reshape(B, KVH, H // KVH, dh) / math.sqrt(dh)
    s = torch.einsum("bkgd,bwkd->bkgw", qg, k.double())
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    o = torch.einsum("bkgw,bwkd->bkgd", torch.softmax(s, dim=-1), v.double())
    return o.reshape(B, H, dh)


def check_fp32_fp64():
    """The other 3xTF32 kernels against fp64, each within FP64_FACTOR
    times the fp32 plain version's error: the mLSTM at the serving prefill
    (B 1, H 4, S 1024, dh 1024; h, C, n and m against
    ``mlstm_parallel_f64``), the fused step at the qwen2.5-3b and
    recurrentgemma-2b timed shapes and the recurrentgemma-2b ring (against
    the same attention over the valid tokens in fp64)."""
    import torch
    from repro_torch.kernels import (decode_attention, mlstm_chunkwise,
                                     paged_decode_step)
    from repro_torch.kernels.ref import (decode_attention_ref,
                                         mlstm_chunkwise_ref,
                                         mlstm_parallel_f64,
                                         paged_decode_step_ref)
    gen = torch.Generator(device="cuda").manual_seed(8)
    args = _mlstm_inputs(gen, 1, 4, 1024, 1024, "normal", torch.float32)
    h, state = mlstm_chunkwise(*args)
    hp, state_p = mlstm_chunkwise_ref(*args)
    h64, _, state64 = mlstm_parallel_f64(*args)
    for name, a, b, x in zip("hCnm", (h, *state), (hp, *state_p),
                             (h64, *state64)):
        ulp = torch.finfo(torch.float32).eps * x.abs().max().item()
        vs_fp64(f"mlstm_chunkwise fp32 S=1024 {name}", a, b, x, floor=ulp)
    del args, h, state, hp, state_p, h64, state64
    ps = 16
    for label, H, KVH, dh, MP, window, lens_range, seed in (
            ("qwen", 16, 2, 128, 128, None, (64, 1152), 3),
            ("recurrentgemma", 10, 1, 256, 192, 2048, (64, 3000), 19)):
        B = 8
        lens = torch.randint(*lens_range, (B,),
                             generator=torch.Generator().manual_seed(seed))
        x = _step_inputs(gen, B, H, KVH, dh, ps, MP, lens, torch.float32)
        P = x["k"].shape[0]
        step = (x["q"], x["kn"], x["vn"])
        got = paged_decode_step(*step, x["k"].clone(), x["v"].clone(),
                                x["table"], x["lens"], window=window)[0]
        plain = paged_decode_step_ref(*step, x["k"].clone(), x["v"].clone(),
                                      x["table"], x["lens"],
                                      window=window)[0]
        table = x["table"].long()
        pt = torch.where(table >= 0, table, P - 1)
        k = torch.cat([x["k"][pt].reshape(B, MP * ps, KVH, dh),
                       x["kn"][:, None]], 1)
        v = torch.cat([x["v"][pt].reshape(B, MP * ps, KVH, dh),
                       x["vn"][:, None]], 1)
        n1 = (x["lens"].long() - 1).clamp(min=0)[:, None]
        t = torch.arange(MP * ps, device="cuda")[None]
        valid = (t < n1) & (torch.repeat_interleave(table, ps, 1) >= 0)
        if window is not None:
            valid &= n1 - t < window
        valid = torch.cat([valid, torch.ones_like(valid[:, :1])], 1)
        vs_fp64(f"paged_decode_step fp32 {label}", got, plain,
                _attend_f64(x["q"], k, v, valid))
    W = 2048
    q, k, v, spos, pos = _ring_inputs(gen, 8, 10, 1, W, 256,
                                      [W + 37 * b for b in range(8)],
                                      torch.float32)
    got = decode_attention(q, k, v, spos, pos, window=W)
    plain = decode_attention_ref(q, k, v, spos, pos, window=W)
    sp, p2 = spos.long(), pos.long()[:, None]
    valid = (sp >= 0) & (sp <= p2) & (p2 - sp < W)
    vs_fp64("decode_attention fp32 recurrentgemma ring", got, plain,
            _attend_f64(q, k, v, valid))


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
    linear 2048 cache), whisper's (4 slots, 20/20 heads, dh 64, linear
    caches of 128 and 448) and the fuzz buckets."""
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
    # whisper's decoder self-attention: 20/20 heads, dh 64, the static
    # engine's cache of prompt + new tokens, and a 448-token one
    cases.append(("whisper", 4, 20, 20, 128, 64, [1, 64, 100, 128], None))
    cases.append(("whisper", 4, 20, 20, 448, 64, [1, 200, 447, 448], None))
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
    more; ``"fp32"`` and ``"fp32_S128"``: both prompts in fp32 (the three
    3xTF32 kernels)."""
    out = _time_mlstm(1024)
    out["S128"] = _time_mlstm(128)
    out["fp32"] = _time_mlstm(1024, "float32")
    out["fp32_S128"] = _time_mlstm(128, "float32")
    return out


def _time_mlstm(S, dtype_name="bfloat16"):
    """The bound counts the two dh x dh products per token (q C and the
    state update), the causal q k^T and w v products inside each 64-token
    chunk and the n terms, at the peak of the type (in fp32 the 3xTF32
    rate of the kernels' products, with the CUDA cores' beside it,
    ``bound_cuda_core_ms``); and each input, h and the final state once
    in memory."""
    import torch
    from repro_torch.kernels import mlstm_chunkwise
    from repro_torch.kernels.ref import MLSTM_CHUNK, mlstm_chunkwise_ref
    B, H, dh = 1, 4, 1024
    gen = torch.Generator(device="cuda").manual_seed(22)
    dtype = getattr(torch, dtype_name)
    args = _mlstm_inputs(gen, B, H, S, dh, "normal", dtype)
    ms = graph_ms(lambda: mlstm_chunkwise(*args), iters=10)
    enq = time_ms(lambda: mlstm_chunkwise(*args), iters=10)
    plain = time_ms(lambda: mlstm_chunkwise_ref(*args), iters=5)
    BH = B * H
    pairs = sum(n * (n + 1) // 2 for n in
                (min(MLSTM_CHUNK, S - t) for t in range(0, S, MLSTM_CHUNK)))
    flops = BH * (4 * S * dh * dh + 4 * pairs * dh + 4 * S * dh)
    esz = torch.finfo(dtype).bits // 8
    n_bytes = (BH * S * dh * esz * 4 + BH * S * 4 * 2
               + BH * (dh * dh + dh + 1) * 4)
    b_ms, by = bound_ms(n_bytes, flops, dtype_name)
    out = {"ms": ms, "enqueue_ms": enq, "plain_ms": plain,
           "bound_ms": b_ms, "bound_by": by, "library_ms": None,
           "shape": f"B=1 H=4 S={S} dh=1024 {_kind(dtype_name)}, fresh "
                    f"state (library: "
                    f"none, no single PyTorch call computes the chunkwise "
                    f"mLSTM recurrence)"}
    if dtype_name == "float32":
        out["bound_cuda_core_ms"] = b_ms
        out["bound_ms"], out["bound_by"] = bound_ms(n_bytes, flops, "tf32x3")
        out["shape"] += (f"; bound at the 3xTF32 rate, at the CUDA cores' "
                         f"{b_ms:.5f} ms")
    return out


def time_paged_step():
    """Kernel, plain and bound at a decode tick of the qwen2.5-3b serving
    phase's shape: 8 slots mid-generation, bf16; and at recurrentgemma-2b's
    (``"dh256"``), qwen2-moe's (``"moe"``, 16/16 heads), pixtral's
    (``"pixtral"``, 32/8) and llama4's (``"llama4"``, 40/8, window 8192,
    slots 4096..10240 tokens long) paged shapes; the qwen and
    recurrentgemma shapes in fp32 (``"fp32"``, ``"fp32_dh256"``: the
    3xTF32 walk)."""
    out = _time_paged_step(16, 2, 128, 128, None, (64, 1152), seed=3)
    out["fp32"] = _time_paged_step(16, 2, 128, 128, None, (64, 1152),
                                   seed=3, dtype_name="float32")
    out["fp32_dh256"] = _time_paged_step(10, 1, 256, 192, 2048, (64, 3000),
                                         seed=19, dtype_name="float32")
    out["dh256"] = _time_paged_step(10, 1, 256, 192, 2048, (64, 3000),
                                    seed=19)
    out["moe"] = _time_paged_step(16, 16, 128, 128, None, (64, 1152),
                                  seed=41)
    out["pixtral"] = _time_paged_step(32, 8, 128, 128, None, (64, 1152),
                                      seed=43)
    out["llama4"] = _time_paged_step(40, 8, 128, 640, 8192, (4096, 10240),
                                     seed=45)
    return out


def _time_paged_step(H, KVH, dh, MP, window, lens_range, seed,
                     dtype_name="bfloat16"):
    """One (B=8, ps=16) decode step; eight copies of the pools are
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
    x = _step_inputs(gen, B, H, KVH, dh, ps, MP, lens,
                     getattr(torch, dtype_name))
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
    esz = x["q"].element_size()
    stored = (lens - 1).clamp(min=0)
    if window is not None:                   # rows the window admits
        stored = stored.clamp(max=window - 1)
    stored = stored.sum().item()
    n_bytes = (2 * stored * KVH * dh * esz           # K and V rows read
               + 2 * B * H * dh * esz                 # q in, out
               + 4 * B * KVH * dh * esz               # new K/V in, rows out
               + sum(-(-int(n) // ps) for n in lens) * 4 + B * 4)
    flops = 4 * (stored + B) * KVH * g * dh
    b_ms, by = bound_ms(n_bytes, flops, dtype_name)
    return {"ms": ms, "enqueue_ms": enq, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
            "shape": f"B=8 H={H} KVH={KVH} dh={dh} ps=16 MP={MP} window="
                     f"{window} {_kind(dtype_name)} lens={lens.tolist()} "
                     f"(library: none, "
                     f"no single PyTorch call appends into and attends over "
                     f"a paged pool)"}


def time_flash():
    """Kernel, plain, library call and bound at the longest prompt the
    serving phase prefills (S=1024), bf16 (the ``wgmma`` kernel); bf16 at
    recurrentgemma-2b's dh 256 (``"dh256"``), at qwen2-moe's heads
    (``"moe"``: 16/16, S=1024) and whisper's encoder (``"whisper_enc"``:
    20/20, dh 64, 1500 frames, non-causal); fp32 (the 3xTF32 kernel) at
    every fp32 serving shape of ``FLASH_TIMED``: ``"fp32"`` (qwen),
    ``"fp32_dh256"``, ``"fp32_stablelm"``, ``"fp32_whisper_enc"``."""
    bf16 = {key: _time_flash(*shape[:4], "bfloat16", causal=shape[4],
                             window=shape[5], iters=FLASH_ITERS.get(key, 50))
            for key, shape in FLASH_BF16_TIMED.items()}
    out = bf16.pop("qwen")
    out.update(bf16)
    for key, shape in FLASH_TIMED.items():
        out["fp32" if key == "qwen" else f"fp32_{key}"] = _time_flash(
            *shape[:4], "float32", causal=shape[4], window=shape[5],
            iters=FLASH_ITERS.get(key, 50))
    return out


def cuda_kernel_names(fn):
    """Names of the CUDA kernels one ``fn()`` launches (``torch.profiler``
    after a warm-up call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events()
                   if str(e.device_type).endswith("CUDA")})


def _time_flash(H, KVH, S, dh, dtype_name, causal=True, window=None,
                iters=50):
    """``iters`` graph replays, eager calls and SDPA replays, and the
    names of the kernels SDPA launches (``library_kernels``).  Beside the
    contiguous call, ``strided_ms``: the same inputs as the transposed
    views of (B,S,heads,dh) tensors that ``layers.full_attention`` passes
    (read in place in bf16, copied in fp32).  In fp32 the bound is at the
    3xTF32 rate of the kernel's products (``bound_ms``), with the CUDA
    cores' beside it (``bound_cuda_core_ms``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    B = 1
    gen = torch.Generator(device="cuda").manual_seed(5)
    f = lambda h: torch.randn((B, h, S, dh), generator=gen,
                              device="cuda").to(getattr(torch, dtype_name))
    q, k, v = f(H), f(KVH), f(KVH)
    call = lambda: flash_attention(q, k, v, causal=causal, window=window)
    ms = graph_ms(call, iters=iters)
    enq = time_ms(call, iters=iters)
    views = [x.transpose(1, 2).contiguous().transpose(1, 2)
             for x in (q, k, v)]
    strided = graph_ms(lambda: flash_attention(*views, causal=causal,
                                               window=window), iters=iters)
    plain = time_ms(lambda: flash_attention_ref(q, k, v, causal=causal,
                                                window=window), iters=10)
    kr = k.repeat_interleave(H // KVH, dim=1)
    vr = v.repeat_interleave(H // KVH, dim=1)
    sdpa = lambda: F.scaled_dot_product_attention(q, kr, vr,
                                                  is_causal=causal)
    lib = graph_ms(sdpa, iters=iters)
    pairs = (sum(min(i + 1, window or S) for i in range(S)) if causal
             else S * S)            # (query, key) pairs the mask admits
    flops = 4 * pairs * dh * H * B
    esz = q.element_size()
    n_bytes = esz * (2 * B * H * S * dh + 2 * B * KVH * S * dh)
    b_ms, by = bound_ms(n_bytes, flops, dtype_name)
    kind = _kind(dtype_name)
    mask = ("causal" if causal else "non-causal") + (
        f" window {window}" if window is not None else "")
    lib_kernels = cuda_kernel_names(sdpa)
    out = {"ms": ms, "enqueue_ms": enq, "strided_ms": strided,
           "plain_ms": plain, "bound_ms": b_ms, "bound_by": by,
           "library_ms": lib, "library_kernels": lib_kernels,
           "shape": f"B=1 H={H} KVH={KVH} S={S} dh={dh} {mask} {kind} "
                    f"(library: SDPA, GQA heads expanded outside the "
                    f"timing; SDPA launches {lib_kernels}); strided views "
                    f"{strided:.5f} ms"}
    if kind == "fp32":
        out["bound_cuda_core_ms"] = b_ms
        out["bound_ms"], out["bound_by"] = bound_ms(n_bytes, flops, "tf32x3")
        out["shape"] += (f"; bound at the 3xTF32 rate, at the CUDA cores' "
                         f"{b_ms:.5f} ms")
    return out


def time_paged_attention():
    """The read-only walk at the decode step's timed shape (8 slots,
    16/2 heads, dh 128, bf16), eight pool copies cycled past the L2; the
    same in fp32 (``"fp32"``: the 3xTF32 walk)."""
    out = _time_paged_attention("bfloat16")
    out["fp32"] = _time_paged_attention("float32")
    return out


def _time_paged_attention(dtype_name):
    import torch
    from repro_torch.kernels import paged_decode_attention
    from repro_torch.kernels.ref import paged_decode_attention_ref
    B, H, KVH, dh, ps, MP = 8, 16, 2, 128, 16, 128
    g = H // KVH
    lens = torch.randint(64, 1152, (B,),
                         generator=torch.Generator().manual_seed(3))
    gen = torch.Generator(device="cuda").manual_seed(16)
    x = _step_inputs(gen, B, H, KVH, dh, ps, MP, lens,
                     getattr(torch, dtype_name))
    esz = x["q"].element_size()
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
    n_bytes = (2 * n * KVH * dh * esz + 2 * B * H * dh * esz
               + sum(-(-int(m) // ps) for m in lens) * 4 + B * 4)
    b_ms, by = bound_ms(n_bytes, 4 * n * KVH * g * dh, dtype_name)
    return {"ms": ms, "enqueue_ms": enq, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
            "shape": f"B=8 H=16 KVH=2 dh=128 ps=16 MP=128 "
                     f"{_kind(dtype_name)} lens="
                     f"{lens.tolist()} (library: none, no single PyTorch "
                     f"call attends over a paged pool)"}


def time_decode():
    """A ring-decode step of recurrentgemma-2b's striped serving shape:
    8 slots with full wrapped rings of W = window = 2048, 10/1 heads,
    dh 256, bf16; and (``"qwen"``) qwen2.5-3b's striped shape: 8 slots of
    a 2048-token cache mid-generation (the paged step's timed lens), 16/2
    heads, dh 128, no window; and (``"whisper"``) whisper's static engine
    at its phase-12 shape: 4 slots of a 128-token cache, 20/20 heads, dh
    64; the recurrentgemma-2b ring in fp32 (``"fp32"``: the 3xTF32
    walk)."""
    import torch
    W = 2048
    out = _time_decode(10, 1, 256, [W + 37 * b for b in range(8)], W, 17)
    lens = torch.randint(64, 1152, (8,),
                         generator=torch.Generator().manual_seed(3))
    out["qwen"] = _time_decode(16, 2, 128, lens.tolist(), None, 23)
    out["whisper"] = _time_decode(20, 20, 64, [100, 110, 120, 127], None,
                                  29, B=4, W=128)
    out["fp32"] = _time_decode(10, 1, 256, [W + 37 * b for b in range(8)], W,
                               17, dtype_name="float32")
    return out


def _time_decode(H, KVH, dh, fills, window, seed, B=8, W=2048,
                 dtype_name="bfloat16"):
    """B slots (8), a ring of W (2048) slots; eight K/V copies
    cycled past the 50 MB L2.  The library yardstick is SDPA over the
    validity mask with the KV heads expanded outside the timing."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention
    from repro_torch.kernels.ref import decode_attention_ref
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, spos, pos = _ring_inputs(gen, B, H, KVH, W, dh, fills,
                                      getattr(torch, dtype_name))
    esz = q.element_size()
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
    n_bytes = (2 * n_valid * KVH * dh * esz + 2 * B * H * dh * esz
               + B * W * 4 + B * 4)
    b_ms, by = bound_ms(n_bytes, 4 * n_valid * H * dh, dtype_name)
    return {"ms": ms, "enqueue_ms": enq, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib,
            "shape": f"B={B} H={H} KVH={KVH} W={W} window {window} dh={dh} "
                     f"{_kind(dtype_name)}, fills {fills} (library: SDPA "
                     f"with the boolean validity mask, KV heads expanded "
                     f"outside the timing)"}


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
        f"shared_tokens={s['shared_tokens']}; {graph_note(eng)}")
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
        f"128 tokens in {wall:.3f} s = {128 / wall:.1f} tok/s; "
        f"{prefill_note(eng)}")
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
        f"decode_ticks={s['decode_ticks']} prefills={s['prefills']}; "
        f"{graph_note(eng)}")
    del eng
    torch.cuda.empty_cache()


def profile_ticks(eng, vocab: int, seed: int, label: str,
                  prompt: int = 256, first_id: int = 1000):
    """Where a serving tick's time goes: a short burst (8 requests,
    ``prompt`` prompt tokens, 24 new) under torch.profiler after the
    measured run; prints device-busy share of the wall time and the top
    kernels.  Returns (wall s, device-busy s)."""
    import numpy as np
    rng = np.random.default_rng(seed + 7)
    for i in range(8):
        eng.submit(list(map(int, rng.integers(0, vocab, prompt))), 24,
                   req_id=first_id + i)
    ticks0 = eng.stats["decode_ticks"]
    out = profile_call(eng.run, f"{label} 8 requests x ({prompt} prompt, "
                       f"24 new)", top=10)
    log(f"[profile] {label}: {eng.stats['decode_ticks'] - ticks0} decode "
        f"ticks in the profiled burst")
    return out


def profile_call(fn, label: str, top: int = 8):
    """One call of ``fn`` under torch.profiler: prints its wall time, the
    device-busy share and the ``top`` device kernels.  Returns (wall s,
    device-busy s)."""
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
    return wall, busy


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
def teacher_forced(cfg, params, prompt, gen, what: str, layout: str,
                   extra=None):
    """Re-run one request teacher-forced through ``forward`` +
    ``decode_step`` with every kernel swapped for its plain version
    (``kernel_impl="plain"``: attention, the RG-LRU scan, the mLSTM chunk
    loop and the static MoE form with no drops), on the paged or the
    striped cache; ``extra`` holds the request's batch-1 "patches" or
    "frames" (striped only).  Every engine token must equal the reference
    argmax where the top-2 margin exceeds MARGIN.  Returns (checked,
    skipped)."""
    import torch
    from repro_torch.models import (cache_from_prefill, decode_step,
                                    forward, init_paged_cache, n_positions,
                                    paged_prefill_scatter, pages_for)
    toks = torch.tensor([prompt], device="cuda")
    batch = {"tokens": toks, **(extra or {})}
    total = n_positions(cfg, batch) + len(gen)
    o = forward(cfg, params, batch, build_cache=True, cache_len=total,
                moe_cf=None, kernel_impl="plain", last_only=True)
    if layout == "paged":
        npg = pages_for(total, 16)
        cache = init_paged_cache(cfg, 1, page_size=16, n_pages=npg,
                                 max_pages=npg, device="cuda")
        cache["pages"] = torch.arange(npg, dtype=torch.int32,
                                      device="cuda")[None]
        paged_prefill_scatter(cfg, cache, o["kv"], 0, cache["pages"][0],
                              len(prompt))
    else:
        cache = cache_from_prefill(cfg, o["kv"], total,
                                   n_positions(cfg, batch))
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
    path = "qwen2.5-3b fp32 paged"
    out, _, counts = drive(path, eng.run)
    fresh = sum(1 for q in eng.sched.finished.values()
                if q.shared_tokens == 0)
    expect(path, counts,
           {"paged_decode_step": N_LAYERS * eng.stats["decode_ticks"],
            "flash_attention": N_LAYERS * fresh})
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
        f"{eng.stats['shared_tokens']}; launches {counts}")
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
        f"(wall time incl. prefill); launches {counts}; "
        f"{prefill_note(eng)}")
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
            f"{counts}; {graph_note(eng)}")
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
    static = InferenceEngine(cfg, params)
    path = "recurrentgemma-2b fp32 static"
    out, _, counts = drive(path, lambda: static.generate(
        {"tokens": torch.tensor(short, device="cuda")}, 24))
    expect(path, counts, {"rglru_scan": HYBRID_REC,
                          "flash_attention": HYBRID_ATTN,
                          "decode_attention": HYBRID_ATTN * 23})
    gen = {"static": dict(enumerate(out.tolist()))}
    launches = {path: counts}
    del static
    for paged in (False, True):
        path = f"recurrentgemma-2b fp32 {'paged' if paged else 'striped'}"
        eng = ContinuousBatchingEngine(cfg, params, n_slots=4, max_len=2200,
                                       page_size=16, paged=paged)
        for i, (p, n) in enumerate(trace):
            eng.submit(p, n, req_id=i)
        out, _, counts = drive(path, eng.run)
        s = eng.stats
        want = {"rglru_scan": HYBRID_REC * s["prefills"],
                "flash_attention": HYBRID_ATTN * s["prefills"]}
        want["paged_decode_step" if paged else "decode_attention"] = \
            HYBRID_ATTN * s["decode_ticks"]
        expect(path, counts, want)
        gen["paged" if paged else "striped"] = out
        launches[path] = counts
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
        f"margin <= {MARGIN}); launches {launches}")
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
        f"incl. prefill); launches {counts}; {prefill_note(eng)}")
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
        eager, inplace, replay = tick_ms(cfg, params, eng)
        gen_tok = sum(len(v) for v in out.values())
        log(f"[serve] {path}: {len(trace)} requests, {gen_tok} tokens in "
            f"{wall:.3f} s = {gen_tok / wall:.1f} tok/s (wall time incl. "
            f"prefill); decode_ticks={s['decode_ticks']} "
            f"({1e3 * wall / max(s['decode_ticks'], 1):.2f} ms of wall "
            f"time per tick) decode_tokens={s['decode_tokens']} "
            f"prefills={s['prefills']}; launches {counts}; a decode tick "
            f"of all 8 slots alone: {eager:.2f} ms eager, {inplace:.2f} ms "
            f"eager in place, {replay:.2f} ms a graph replay; "
            f"{graph_note(eng)}")
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


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone_tree(v) for v in tree]
    return tree.clone()


def tick_ms(cfg, params, eng, n: int = 10):
    """Host-clock ms of one pooled decode tick over every slot of an
    engine, averaged over ``n`` ticks after one more: (the functional
    ``decode_step`` on a clone of the engine's cache, which writes new
    state tensors; the in-place ``decode_step_inplace`` on that clone,
    eagerly, the body the graph captures; one replay of the engine's
    captured graph, its address guard and launch bookkeeping included).
    Functional against in-place is what the state copies cost, in-place
    against replay what dispatch costs.  Each ends in a synchronise; the
    in-place ticks advance the clone and the replays the engine's own
    cache, so call this when the engine is done serving."""
    import torch
    from repro_torch.models import decode_step, decode_step_inplace
    cache = clone_tree(eng.cache)
    tok = eng._tok.clone()
    out = []
    for fn in (lambda: decode_step(cfg, params, cache, tok, cache["pos"]),
               lambda: decode_step_inplace(cfg, params, cache, tok),
               lambda: eng.decode_graph.replay(eng._graph_inputs())):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / n * 1e3)
    del cache
    return tuple(out)


def graph_note(eng) -> str:
    """The engine's decode graph (capture time, pool bytes, replays) and
    its prefill graphs (``prefill_note``)."""
    g = eng.decode_graph
    if g is None:
        raise AssertionError("the engine decoded without a captured graph")
    return (f"decode graph captured in {g.capture_s * 1e3:.1f} ms, pool "
            f"{g.pool_bytes / 2**20:.1f} MiB, {g.replays} replays; "
            f"{prefill_note(eng)}")


def prefill_note(eng) -> str:
    """An engine's prefill graphs, per key: capture seconds (an eager-run
    warm-up is not in it), the MiB its capture added to the shared pool,
    replays.  Raises when a config that captures (no MoE) prefilled with
    no graph: on the card every such prefill is a graph's warm-up or
    replay."""
    from repro_torch.models import has_moe
    graphs = eng.prefill_graphs
    if not graphs.capturing:
        return ("prefill eager by rule (MoE: host read of expert counts)"
                if has_moe(eng.cfg) else "prefill eager (no capture)")
    if getattr(eng, "stats", {}).get("prefills", 1) and not len(graphs):
        raise AssertionError("the engine prefilled without a captured graph")
    return f"{len(graphs)} prefill graphs (" + "; ".join(
        f"{_key_text(k)}: {s.capture_s:.2f} s, "
        f"{s.pool_bytes / 2**20:.1f} MiB, {s.replays} replays"
        for k, s in graphs.steps.items()) + ")"


def _key_text(key) -> str:
    """A prefill graph's key: "fresh/512" (kind/bucket) for the
    continuous engines, "2x200+8" (batch x text + cache length past the
    text) for ``InferenceEngine``."""
    if isinstance(key[0], str):
        return f"{key[0]}/{key[1]}"
    B, S = key[1][1]
    return f"{B}x{S}+{key[0] - S}"


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
    static = InferenceEngine(cfg, params)
    path = "xlstm-1.3b fp32 static"
    out, _, counts = drive(path, lambda: static.generate(
        {"tokens": torch.tensor(short, device="cuda")}, 24))
    expect(path, counts, {"mlstm_chunkwise": SSM_MLSTM})
    gen = {"static": dict(enumerate(out.tolist()))}
    launches = {path: counts}
    del static
    for paged in (False, True):
        path = f"xlstm-1.3b fp32 {'paged' if paged else 'striped'}"
        eng = ContinuousBatchingEngine(cfg, params, n_slots=4, max_len=832,
                                       page_size=16, paged=paged)
        for i, (p, n) in enumerate(trace):
            eng.submit(p, n, req_id=i)
        out, _, counts = drive(path, eng.run)
        expect(path, counts,
               {"mlstm_chunkwise": SSM_MLSTM * eng.stats["prefills"]})
        gen["paged" if paged else "striped"] = out
        launches[path] = counts
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
        f"{MARGIN}); launches {launches}")
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


# ------------------------------------------------------------ phase 10
# (name, arch, weight seed offset): qwen hot on node 0, stablelm host-warm
CLUSTER_MODELS = (("qwen", "qwen2.5-3b", 0), ("stablelm", "stablelm-1.6b", 1))
# 12f: the live cluster on MoE, depth cut: four fp32 copies on one card
# (at depth 6, 16.2 GB a copy, the fourth node's unpack ran out of memory)
CLUSTER_MOE = ("moe", "qwen2-moe-a2.7b", 2)
CLUSTER_DEPTH = {"moe": 4}
CLUSTER_BLOCKS = 4
# fp32 sub-phase: max |cluster logits - plain fp32 forward| over the
# largest |plain logit|, at every multicast step in both modes
CLUSTER_FP32_TOL = 1e-3


def _n_layers(lc, m) -> int:
    return lc.models[m].cfg.n_layers


def cluster_requests(lc, n: int, seed: int):
    """``n`` requests alternating between the registered models: prompts
    64..512 tokens, 24..64 new tokens; the first two of each model share
    a 256-token prefix.  Returns [(model, prompt, new)]."""
    import numpy as np
    rng = np.random.default_rng(seed)
    models = list(lc.models)
    tok = lambda m, k: list(map(int, rng.integers(
        0, lc.models[m].cfg.vocab_size, int(k))))
    base = {m: tok(m, 256) for m in models}
    out = []
    for i in range(n):
        m = models[i % len(models)]
        if i < 2 * len(models):
            prompt = base[m] + tok(m, rng.integers(8, 257))
        else:
            prompt = tok(m, rng.integers(64, 513))
        out.append((m, prompt, int(rng.integers(24, 65))))
    return out


def check_cluster_served(lc, want, label: str):
    """Every request finished exactly once, with its full budget, and no
    request was prefilled twice (the prefills of every instance sum to
    the requests).  Returns (adopted by model, re-prefilled)."""
    seen = {}
    prefills = 0
    adopted = {}
    for m, sv in lc.serving.items():
        scheds = ([e.sched for e in sv.locals_.values()]
                  + [e.sched for e in sv.prefills.values()]
                  + [p.engine.sched for p in sv.pipes])
        for s in scheds:
            prefills += s.stats["prefills"]
            for rid in s.finished:
                seen[rid] = seen.get(rid, 0) + 1
        adopted[m] = sum(e.stats["adopted"] for e in sv.locals_.values())
        for rid in lc._retired_results.get(m, {}):
            seen[rid] = seen.get(rid, 0) + 1
    twice = {r: c for r, c in seen.items() if c != 1}
    if twice or set(seen) != set(want):
        raise AssertionError(f"{label}: finished counts {twice}, missing "
                             f"{sorted(set(want) - set(seen))}")
    for rid, (m, n_new) in want.items():
        toks = lc.results(m)[rid]
        vocab = lc.models[m].cfg.vocab_size
        if len(toks) != n_new or not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"{label} request {rid}: {len(toks)} "
                                 f"tokens, want {n_new}")
    return adopted, prefills - len(want)


def expect_cluster_decode(lc, path: str, counts) -> None:
    """paged_decode_step launches == layers x decode ticks, summed over
    every local engine (pipelines keep no cache and launch none); flash
    launched at least once."""
    want = sum(_n_layers(lc, m) * e.stats["decode_ticks"]
               for m, sv in lc.serving.items()
               for e in list(sv.locals_.values()) + list(sv.prefills.values()))
    got = counts["paged_decode_step"]
    if got != want or counts["flash_attention"] <= 0:
        raise AssertionError(f"{path}: paged_decode_step {got} launches, "
                             f"want {want}; all {counts}")


def register_cluster_models(lc, dtype, seed: int, placement):
    """Random weights from ``seed`` for each model, packed by ``register``
    into CLUSTER_BLOCKS wire blocks; the weights are dropped afterwards
    (the registry and the node tiers hold the model).  Returns the
    seconds each registration took."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    took = {}
    for name, arch, off in CLUSTER_MODELS + (CLUSTER_MOE,):
        if name not in placement:
            continue
        cfg = get_config(arch)
        if name in CLUSTER_DEPTH:
            cfg = dataclasses.replace(cfg, n_layers=CLUSTER_DEPTH[name])
        params = init_params(cfg, seed=seed + off, dtype=dtype,
                             device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lc.register(name, cfg, params, n_blocks=CLUSTER_BLOCKS,
                    **placement[name])
        torch.cuda.synchronize()
        took[name] = time.perf_counter() - t0
        del params
        torch.cuda.empty_cache()
    return took


def check_wire_and_unpack(lc, model: str, source: int, label: str) -> None:
    """Every node's wire buffers equal the registry byte for byte; the
    last node to complete has tensors bit-equal to the source's."""
    import numpy as np
    import torch
    dep = lc.models[model]
    nodes = lc.complete_nodes(model)
    for nd in nodes:
        bufs = lc.nodes[nd].gpu_shard(model).buffers
        for b in range(dep.n_blocks):
            if not np.array_equal(bufs[b], dep.registry[b]):
                raise AssertionError(f"{label}: node {nd} block {b} wire "
                                     f"bytes differ from the registry")
    src = lc.nodes[source].gpu_shard(model).flat
    rcv = lc.nodes[nodes[-1]].gpu_shard(model).flat
    if sorted(src) != sorted(rcv) or not all(
            rcv[k].dtype == t.dtype and torch.equal(rcv[k], t)
            for k, t in src.items()):
        raise AssertionError(f"{label}: node {nodes[-1]}'s unpacked tensors "
                             f"differ from source node {source}'s")


def reckon_cluster_bytes(lc, nodes) -> float:
    """Predicted device bytes: each node's copy of its model's padded
    wire blocks plus each engine's KV pool."""
    total = 0.0
    for m, n in nodes.items():
        total += n * lc.models[m].nbytes
        for eng in lc.serving[m].locals_.values():
            total += sum(t.numel() * t.element_size()
                         for t in _leaves(eng.cache) if hasattr(t, "numel"))
    return total


def serve_cluster_live(seed: int) -> None:
    """10a: the ``--live`` shape at full width: qwen2.5-3b hot on node 0
    scales 1 -> 3 new nodes while stablelm-1.6b scales from its host-warm
    copy on node 7 to 3 new nodes; the burst is served through λPipe
    pipelines mid-multicast and local replicas after the mode switch.
    (A 1 -> 2 scale of 4 blocks completes its second node at the step
    its only pipeline becomes ready, so no pipeline would serve; and the
    hot source's 8 slots take 8 requests, so 12 a model leave 4 for the
    pipelines.)"""
    import gc
    import torch
    from repro_torch.serving import LiveCluster
    torch.cuda.reset_peak_memory_stats()
    lc = LiveCluster(n_nodes=8, n_slots=8, max_len=1024, paged=True,
                     page_size=16, prefix_sharing=True, device="cuda")
    took = register_cluster_models(
        lc, torch.bfloat16, seed,
        {"qwen": {"hot_nodes": [0]}, "stablelm": {"warm_nodes": [7]}})
    reports = {"qwen": lc.scale("qwen", 3), "stablelm": lc.scale("stablelm",
                                                                 3)}
    tiers = {m: r.source_tier for m, r in reports.items()}
    if tiers != {"qwen": "gpu", "stablelm": "host"} or \
            set(reports["qwen"].dests) & set(reports["stablelm"].dests):
        raise AssertionError(f"cluster-live: scale reports {reports}")
    # block rows the multicast steps copy host -> device (one per
    # (src, dst, block) of each schedule)
    moved = sum(len(step) * lc.models[m].block_nbytes
                for m, sc in lc.scales.items()
                for step in sc.plan.schedule.steps)
    reqs = cluster_requests(lc, 24, seed + 50)
    want = {}
    for m, prompt, n_new in reqs:
        want[lc.submit(m, prompt, n_new)] = (m, n_new)
    ticks = [0, 0]      # cluster ticks during the multicasts, after them
    tick_s, step_s = [], []

    def serve():
        while True:
            t0 = time.perf_counter()
            more = lc.step()
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            if not more:
                break
            t0 = time.perf_counter()
            lc.tick()
            tick_s.append(time.perf_counter() - t0)
            ticks[0] += 1
        # every node holds its model now: one tick with all eight
        # engines live under the profiler
        profile_call(lc.tick, "cluster-live tick, 8 engines live", top=8)
        ticks[1] += 1
        while True:
            t0 = time.perf_counter()
            busy = lc.tick()
            tick_s.append(time.perf_counter() - t0)
            if not busy:
                break
            ticks[1] += 1
        lc.drain_serving()
    _, wall, counts = drive("cluster-live", serve)
    adopted, reprefilled = check_cluster_served(lc, want, "cluster-live")
    if reprefilled or not all(adopted.values()):
        raise AssertionError(f"cluster-live: adopted {adopted}, "
                             f"re-prefilled {reprefilled}")
    expect_cluster_decode(lc, "cluster-live", counts)
    for m, r in reports.items():
        check_wire_and_unpack(lc, m, r.sources[0], f"cluster-live {m}")
    peak = torch.cuda.max_memory_allocated()
    nodes = {m: len(lc.complete_nodes(m)) for m in lc.models}
    reckoned = reckon_cluster_bytes(lc, nodes)
    n_tok = sum(n for _, n in want.values())
    log(f"[cluster] 10a live: registered "
        + ", ".join(f"{m} {lc.models[m].nbytes / 1e9:.3f} GB padded wire "
                    f"in {took[m]:.2f} s" for m in lc.models)
        + "; scale " + ", ".join(
            f"{m} {r.source_tier}-tier {r.sources} -> {list(r.dests)} first "
            f"serve {r.t_first_serve * 1e3:.2f} ms, complete "
            f"{r.t_complete * 1e3:.2f} ms" for m, r in reports.items())
        + " (simulated clock, H800 profile)")
    log(f"[cluster] 10a live: the multicast steps copied {moved / 1e9:.3f}"
        f" GB of block rows from pageable host memory to the device and "
        f"built the mode-switched engines in {sum(step_s):.3f} s "
        f"({moved / sum(step_s) / 1e9:.2f} GB/s over both; per step "
        + ", ".join(f"{t:.3f}" for t in step_s) + " s)")
    log(f"[cluster] 10a live: {len(want)} requests, {n_tok} tokens in "
        f"{wall:.3f} s wall; {ticks[0]} cluster ticks during the multicasts"
        f" + {ticks[1]} after; {sum(tick_s) / len(tick_s) * 1e3:.1f} ms "
        f"wall per tick (unprofiled); adopted {adopted}, re-prefilled "
        f"{reprefilled}; handoffs "
        f"{sum(d.chosen == 'recompute' for d in lc.handoff_log)} recompute"
        f" / {sum(d.chosen == 'transfer' for d in lc.handoff_log)} transfer;"
        f" engines' decode ticks " + ", ".join(
            f"{m} {[e.stats['decode_ticks'] for e in sv.locals_.values()]}"
            for m, sv in lc.serving.items())
        + f"; peak device memory {peak / 1e9:.2f} GB (reckoned "
        f"{reckoned / 1e9:.2f} GB of replicas and KV pools); launches "
        f"{counts}")
    graphs = [e.decode_graph for sv in lc.serving.values()
              for e in sv.locals_.values() if e.decode_graph is not None]
    log(f"[cluster] 10a live: {len(graphs)} decode graphs, captured in "
        + ", ".join(f"{g.capture_s * 1e3:.1f}" for g in graphs)
        + f" ms, pools {sum(g.pool_bytes for g in graphs) / 2**20:.1f} MiB"
        f" in all, {sum(g.replays for g in graphs)} replays")
    served = [(m, node, e) for m, sv in lc.serving.items()
              for node, e in sv.locals_.items() if e.stats["prefills"]]
    cap = sum(st.capture_s for _, _, e in served
              for st in e.prefill_graphs.steps.values())
    log(f"[cluster] 10a live: the execution pipelines ran eagerly (by "
        f"rule); prefill graphs captured in {cap:.2f} s in all (eager "
        f"warm-ups not counted) of the {wall:.3f} s: " + "; ".join(
            f"{m} node {node} {e.stats['prefills']} prefills, "
            f"{prefill_note(e)}" for m, node, e in served))
    del lc
    gc.collect()
    torch.cuda.empty_cache()


def serve_cluster_autoscale(seed: int) -> None:
    """10b: the ``--autoscale`` shape: qwen2.5-3b host-warm on node 0 with
    zero replicas; the autoscaler scales it up from the host tier for a
    16-request burst on the simulated clock and back down after its
    keep-alive, and every scale-down frees the replicas' device bytes."""
    import gc
    import numpy as np
    import torch
    from repro_torch.serving import (Autoscaler, AutoscalerConfig,
                                     LiveCluster, Request)
    torch.cuda.reset_peak_memory_stats()
    lc = LiveCluster(n_nodes=4, n_slots=8, max_len=1024, paged=True,
                     page_size=16, prefix_sharing=True, device="cuda")
    register_cluster_models(lc, torch.bfloat16, seed,
                            {"qwen": {"warm_nodes": [0]}})
    rng = np.random.default_rng(seed + 60)
    trace = [Request(i, "qwen", 0.005 + 0.002 * i, int(rng.integers(64, 513)),
                     int(rng.integers(24, 65))) for i in range(16)]
    asc = Autoscaler(AutoscalerConfig(cooldown_up=0.05, cooldown_down=0.02,
                                      keepalive=0.15, min_replicas=0,
                                      max_k=2))
    freed = []
    scale_down = lc.scale_down

    def measured_scale_down(model, nodes, park="host"):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        scale_down(model, nodes, park=park)
        torch.cuda.synchronize()
        freed.append((len(nodes), before - torch.cuda.memory_allocated()))
    lc.scale_down = measured_scale_down
    ticks = [0]
    tick = lc.tick

    def counted_tick():
        ticks[0] += 1
        return tick()
    lc.tick = counted_tick
    log_, wall, counts = drive("cluster-autoscale", lambda: lc.replay(
        trace, autoscaler=asc, tick_seconds=0.002, tail_seconds=0.5))
    s = log_.summary()
    events = [(e.kind, e.detail) for e in log_.scale_events]
    ups = [d for k, d in events if k == "up" and "tier=host" in d]
    downs = [d for k, d in events if k == "down" and "keepalive" in d]
    if s["n_finished"] != len(trace) or not ups or not downs:
        raise AssertionError(f"cluster-autoscale: {s['n_finished']} of "
                             f"{len(trace)} finished; events {events}")
    replica = lc.models["qwen"].nbytes
    if not freed or not all(b >= n * replica for n, b in freed):
        raise AssertionError(f"cluster-autoscale: scale-downs (nodes, bytes "
                             f"freed) {freed}, one replica is {replica:.0f}")
    if counts["paged_decode_step"] <= 0 or counts["flash_attention"] <= 0:
        raise AssertionError(f"cluster-autoscale: launches {counts}")
    peak = torch.cuda.max_memory_allocated()
    log(f"[cluster] 10b autoscale: {int(s['n_finished'])}/{len(trace)} "
        f"requests in {wall:.3f} s wall, {ticks[0]} cluster ticks, "
        f"{wall / ticks[0] * 1e3:.1f} ms wall per tick; TTFT p50 "
        f"{s['ttft_p50'] * 1e3:.2f} ms p99 {s['ttft_p99'] * 1e3:.2f} ms, "
        f"gpu_seconds {s['gpu_seconds']:.4f} (simulated clock, H800 "
        f"profile); scale events {events}; scale-downs freed "
        + ", ".join(f"{b / 1e9:.3f} GB for {n} node(s)" for n, b in freed)
        + f" (one replica {replica / 1e9:.3f} GB); peak device memory "
        f"{peak / 1e9:.2f} GB; launches {counts}")
    del lc
    gc.collect()
    torch.cuda.empty_cache()


def check_cluster_fp32(seed: int, model: str, n_requests: int = 4) -> None:
    """10c: ``model`` (qwen2.5-3b; stablelm-1.6b: MHA at dh 64, LayerNorm
    with partial rotary; 12f: qwen2-moe at depth 4 with 8 requests) in
    fp32, hot on node 0 of 4, scaled by 3.  At
    every multicast step ``forward`` on two token batches (local on the
    source, the pipeline while it is the best option, then local) is held
    to the plain fp32 forward on the same weights; once a serving pipeline
    is live, its own ``forward_fn`` at ``last=`` rows is held to those
    rows; after the scale every node's local forward is held to it.
    ``n_requests`` requests submitted once the pipeline is live are
    prefilled in it, handed off at the mode switch (at least 2 adopted,
    none prefilled again) and held to the plain teacher-forced argmax.
    (On 3 nodes the plan's only pipeline is ready at the step its members
    complete: no pipeline mode.)"""
    import gc
    import numpy as np
    import torch
    from repro_torch.core.blocks import unflatten_params
    from repro_torch.models import forward
    from repro_torch.serving import LiveCluster
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    lc = LiveCluster(n_nodes=4, n_slots=4, max_len=512, paged=True,
                     page_size=16, prefix_sharing=True, device="cuda")
    register_cluster_models(lc, torch.float32, seed,
                            {model: {"hot_nodes": [0]}})
    cfg = lc.models[model].cfg
    arch = dict((n, a) for n, a, _ in CLUSTER_MODELS + (CLUSTER_MOE,))[model]
    params = unflatten_params(cfg, lc.nodes[0].gpu_shard(model).flat)
    rng = np.random.default_rng(seed + 70)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)
                                ).cuda() for shape in ((2, 64), (3, 37))]
    refs = [forward(cfg, params, {"tokens": t}, kernel_impl="plain",
                    moe_cf=None)["logits"] for t in batches]
    scales = [float(r.abs().max()) for r in refs]
    last = torch.tensor([63, 20], device="cuda")
    lc.scale(model, 3)
    reqs = [(list(map(int, rng.integers(0, cfg.vocab_size,
                                        int(rng.integers(64, 257))))), 24)
            for _ in range(n_requests)]
    points, errs, want = [], [], {}

    def held(logits, b, what, rows=None):
        ref = refs[b] if rows is None else refs[b][
            torch.arange(len(rows), device="cuda"), rows]
        err = float((logits - ref).abs().max())
        errs.append(err)
        if not err <= CLUSTER_FP32_TOL * scales[b]:
            raise AssertionError(f"cluster-fp32 {arch} {what} batch {b}: "
                                 f"max |d logit| {err:.3g} > "
                                 f"{CLUSTER_FP32_TOL} x {scales[b]:.3g}")

    def compare():
        for b, t in enumerate(batches):
            r = lc.forward(model, t)
            held(r["logits"], b, f"{r['mode']} step {len(points)}")
        points.append(r["mode"])

    def serve():
        while True:
            compare()
            pipes = lc.serving[model].live_pipes()
            if not want and pipes:
                held(pipes[0].engine.forward_fn(batches[0], last), 0,
                     f"serving pipeline last={last.tolist()}", last)
                points.append("serving pipeline at last=")
                for p, n in reqs:
                    want[lc.submit(model, p, n)] = (model, n)
                # the pipeline prefills one request a tick
                for _ in reqs:
                    lc.tick()
            if not lc.step():
                break
            lc.tick()
        lc.drain_serving()
        compare()
        for nd in lc.complete_nodes(model):
            for b, t in enumerate(batches):
                held(lc._forward_local(model, nd, t), b, f"node {nd} local")
            points.append(f"node {nd} local")
    # qwen's path keeps the name it had before stablelm joined the phase
    path = "cluster-fp32" + ("" if model == "qwen" else f"-{model}")
    _, wall, counts = drive(path, serve)
    expect_cluster_decode(lc, path, counts)
    n_nodes = len(lc.complete_nodes(model))
    if "pipeline" not in points or not want or n_nodes != 4 or \
            points[-n_nodes - 1] != "local":
        raise AssertionError(f"cluster-fp32 {arch}: points {points}")
    adopted, reprefilled = check_cluster_served(lc, want,
                                                f"cluster-fp32 {arch}")
    if reprefilled or adopted[model] < 2:
        raise AssertionError(f"cluster-fp32 {arch}: adopted {adopted}, "
                             f"re-prefilled {reprefilled}")
    out = lc.results(model)
    checked = skipped = 0
    for rid, (prompt, _) in zip(want, reqs):
        c, k = teacher_forced(cfg, params, prompt, out[rid],
                              f"cluster-fp32 {arch} request {rid}", "paged")
        checked, skipped = checked + c, skipped + k
    if checked < (checked + skipped) // 2:
        raise AssertionError(f"only {checked} tokens cleared the margin")
    log(f"[fp32] {'12f' if model == 'moe' else '10c'} cluster {arch} "
        f"({cfg.n_layers} layers) fp32, 4 nodes x "
        f"{lc.models[model].nbytes / 1e9:.3f} GB: {len(points)} points "
        f"({', '.join(points)}), max |d logit| "
        + ", ".join(f"{e:.3g}" for e in errs)
        + " against the plain fp32 forward (largest |logit| "
        + ", ".join(f"{s:.3g}" for s in scales)
        + f", tolerance {CLUSTER_FP32_TOL} of it); {len(want)} requests "
        f"(adopted {adopted[model]}), {checked} tokens equal the plain "
        f"teacher-forced argmax, {skipped} skipped (top-2 margin <= "
        f"{MARGIN}); {wall:.3f} s wall; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
        f"{counts}")
    del lc, params, refs
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- main
# ------------------------------------------------------------ phase 11
# (arch, max_len): each engine's pool at phase 3, 5, 7's sizes
COMPILED = (("qwen2.5-3b", 2048), ("recurrentgemma-2b", 2048),
            ("xlstm-1.3b", 1152))
GRAPH_TOL = 1e-6     # of the largest fp32 logit; replay is expected bitwise


def compiled_engine(cfg, params, paged: bool, max_len: int, seed: int):
    """A full-width 8-slot engine with 8 requests (64..456-token prompts)
    prefilled and its first decode tick run, so its decode graph is
    captured; pages for 16 more tokens a slot.  Returns (engine, wall
    seconds of that first tick: the eager tick and the capture)."""
    import numpy as np
    import torch
    from repro_torch.serving import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(cfg, params, n_slots=8, max_len=max_len,
                                   page_size=16, paged=paged,
                                   max_prefill_per_tick=8)
    rng = np.random.default_rng(seed)
    for i in range(8):
        eng.submit(list(map(int, rng.integers(0, cfg.vocab_size,
                                              64 + 56 * i))), 64, req_id=i)
    eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    if eng.decode_graph is None or eng.stats["prefills"] != 8:
        raise AssertionError(f"{cfg.arch_id}: no decode graph after the "
                             f"first decode tick ({eng.stats})")
    if paged:
        for slot in eng.sched.live_slots():
            eng.pages.ensure(slot, eng.sched.slots[slot].pos + 16)
        eng._sync_table()
    return eng, first


def graph_vs_eager(cfg, params, eng, ticks: int) -> float:
    """Replay the engine's graph ``ticks`` times, each against the eager
    ``decode_step`` on a clone of the same state (the kernels, launched
    one by one): the argmax must be equal and the logits finite; returns
    the largest |replay - eager| over the largest |eager logit|."""
    import torch
    from repro_torch.models import decode_step
    worst = 0.0
    for _ in range(ticks):
        ref = clone_tree(eng.cache)
        want, _ = decode_step(cfg, params, ref, eng._tok.clone(), ref["pos"])
        eng.decode_graph.replay(eng._graph_inputs())
        got = eng.decode_graph.out
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{cfg.arch_id}: non-finite replay logits")
        if not torch.equal(got.argmax(-1), want.argmax(-1)):
            raise AssertionError(f"{cfg.arch_id}: replay argmax differs "
                                 f"from the eager step")
        worst = max(worst, ((got.float() - want.float()).abs().max()
                            / want.float().abs().max()).item())
        del ref
    return worst


def check_compiled(seed: int) -> None:
    """Phase 11: the compiled decode tick at full width.  In fp32 each
    family, paged and striped, replays its captured graph against the
    eager ``decode_step`` on a clone of the same state, within GRAPH_TOL
    of the largest logit; in bf16 the wall time of a decode tick, eager
    (the functional step and the in-place body) against a graph replay
    (qwen2.5-3b and xlstm-1.3b paged,
    recurrentgemma-2b paged and striped).  Each engine's capture time and
    graph-pool bytes are printed."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch, max_len in COMPILED:
        cfg = get_config(arch)
        params = init_params(cfg, seed=seed, dtype=torch.float32,
                             device="cuda")
        for paged in (True, False):
            label = f"{arch} fp32 {'paged' if paged else 'striped'}"
            eng, first = compiled_engine(cfg, params, paged, max_len,
                                         seed + 60)
            rel = graph_vs_eager(cfg, params, eng, 3)
            if rel > GRAPH_TOL:
                raise AssertionError(f"{label}: replay vs eager {rel:.3g} "
                                     f"of the largest logit")
            log(f"[compiled] {label}: 3 replays vs the eager step, max "
                f"|diff| {rel:.3g} of the largest logit (tolerance "
                f"{GRAPH_TOL}); first tick + capture {first * 1e3:.1f} ms; "
                f"{graph_note(eng)}")
            del eng
            torch.cuda.empty_cache()
        del params
        torch.cuda.empty_cache()
        params = init_params(cfg, seed=seed, dtype=torch.bfloat16,
                             device="cuda")
        layouts = (True, False) if arch == "recurrentgemma-2b" else (True,)
        for paged in layouts:
            label = f"{arch} bf16 {'paged' if paged else 'striped'}"
            eng, first = compiled_engine(cfg, params, paged, max_len,
                                         seed + 61)
            graph_vs_eager(cfg, params, eng, 1)
            eager, inplace, replay = tick_ms(cfg, params, eng)
            log(f"[compiled] {label}: a decode tick of 8 live slots "
                f"{eager:.3f} ms eager, {inplace:.3f} ms eager in place, "
                f"{replay:.3f} ms a graph replay ({eager / replay:.2f}x; "
                f"{inplace / replay:.2f}x in place); first tick + capture "
                f"{first * 1e3:.1f} ms; {graph_note(eng)}")
            del eng
            torch.cuda.empty_cache()
        del params
        torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 12
MOE_ARCH, LLAMA4_ARCH = "qwen2-moe-a2.7b", "llama4-maverick-400b-a17b"
VLM_ARCH, ENCDEC_ARCH = "pixtral-12b", "whisper-large-v3"
LLAMA4_LAYERS = 2      # 12b: one "attn:dense" + one "attn:moe" layer
MOE_FP32_LAYERS = 4    # 12e
VLM_FP32_LAYERS = 2    # 12e


def family_trace(vocab: int, seed: int, n: int = 12, new=(32, 97)):
    """``n`` requests, prompts 64..1024 tokens, ``new`` new tokens;
    requests 0 and 1 share a 512-token prefix (page-aligned)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    tok = lambda k: list(map(int, rng.integers(0, vocab, int(k))))
    base = tok(512)
    prompts = [base + tok(100), base + tok(37)]
    prompts += [tok(k) for k in rng.integers(64, 1025, n - 2)]
    return [(p, int(m)) for p, m in zip(prompts,
                                        rng.integers(*new, len(prompts)))]


def family_model(arch: str, dtype, seed: int, n_layers=None):
    """(cfg, params, parameter count, bytes a decode tick reads: every
    weight but the embedding table, whose rows a tick gathers)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    params = init_params(cfg, seed=seed, dtype=dtype, device="cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    read = sum(t.numel() * t.element_size()
               for k, v in params.items() if k != "embed"
               for t in _leaves(v))
    return cfg, params, n, read


def serve_paged_family(cfg, params, trace, label: str):
    """``trace`` through the paged engine (8 slots, 2048-token pool, page
    16, prefix sharing): flash == layers x fresh prefills and decode-step
    == layers x decode ticks; returns the engine."""
    from repro_torch.serving import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(cfg, params, n_slots=8, max_len=2048,
                                   page_size=16, prefix_sharing=True)
    for i, (p, n) in enumerate(trace):
        eng.submit(p, n, req_id=i)
    out, wall, launches = drive(label, eng.run)
    s = eng.stats
    fresh = sum(1 for q in eng.sched.finished.values()
                if q.shared_tokens == 0)
    check_lengths(label, out, trace, cfg.vocab_size)
    expect(label, launches,
           {"paged_decode_step": cfg.n_layers * s["decode_ticks"],
            "flash_attention": cfg.n_layers * fresh})
    if s["shared_tokens"] <= 0 or fresh == len(trace):
        raise AssertionError(f"{label}: no prompt shared a prefix")
    gen_tok = sum(len(v) for v in out.values())
    log(f"[serve] {label}: {len(trace)} requests, {gen_tok} tokens in "
        f"{wall:.3f} s = {gen_tok / wall:.1f} tok/s (wall time incl. "
        f"prefill); decode_ticks={s['decode_ticks']} prefills="
        f"{s['prefills']} fresh={fresh} shared_tokens="
        f"{s['shared_tokens']}; {graph_note(eng)}")
    return eng


def serve_striped_family(cfg, params, trace, label: str) -> None:
    """``trace`` through the striped engine (``paged=False``): flash ==
    layers x prefills, ring decode == layers x decode ticks."""
    import torch
    from repro_torch.serving import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(cfg, params, n_slots=8, max_len=2048,
                                   paged=False)
    for i, (p, n) in enumerate(trace):
        eng.submit(p, n, req_id=i)
    out, wall, launches = drive(label, eng.run)
    s = eng.stats
    check_lengths(label, out, trace, cfg.vocab_size)
    expect(label, launches,
           {"flash_attention": cfg.n_layers * s["prefills"],
            "decode_attention": cfg.n_layers * s["decode_ticks"]})
    gen_tok = sum(len(v) for v in out.values())
    log(f"[serve] {label}: {len(trace)} requests, {gen_tok} tokens in "
        f"{wall:.3f} s = {gen_tok / wall:.1f} tok/s; decode_ticks="
        f"{s['decode_ticks']} prefills={s['prefills']}; {graph_note(eng)}")
    del eng
    torch.cuda.empty_cache()


def serve_static_family(cfg, params, batch, n_new: int, label: str,
                        flash_per_prefill: int) -> None:
    """``InferenceEngine.generate`` on ``batch``: ``flash_per_prefill``
    flash launches (one a layer; whisper's encoder adds its own) and
    ring decode == layers x (n_new - 1)."""
    from repro_torch.serving import InferenceEngine
    eng = InferenceEngine(cfg, params)
    out, wall, counts = drive(label, lambda: eng.generate(batch, n_new))
    B = batch["tokens"].shape[0]
    if out.shape != (B, n_new) or int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"{label}: output {tuple(out.shape)}")
    expect(label, counts, {"flash_attention": flash_per_prefill,
                           "decode_attention": cfg.n_layers * (n_new - 1)})
    log(f"[serve] {label}: {B} x {n_new} new = {B * n_new} tokens in "
        f"{wall:.3f} s = {B * n_new / wall:.1f} tok/s; launches {counts}; "
        f"{prefill_note(eng)}")


def tick_vs_bound(cfg, params, read: int, label: str, seed: int) -> None:
    """A paged decode tick of 8 live slots (``compiled_engine``), eager
    and replayed, beside the time the tick's weight bytes take at the
    HBM rate."""
    import torch
    eng, first = compiled_engine(cfg, params, True, 2048, seed)
    eager, inplace, replay = tick_ms(cfg, params, eng)
    b_ms = read / HBM_BYTES_PER_S * 1e3
    log(f"[tick] {label} bf16 paged: a decode tick of 8 live slots "
        f"{eager:.3f} ms eager, {inplace:.3f} ms eager in place, "
        f"{replay:.3f} ms a graph replay, weight-read bound {b_ms:.3f} ms "
        f"({replay / b_ms:.2f}x); first tick + capture {first * 1e3:.1f} "
        f"ms; {graph_note(eng)}")
    del eng
    torch.cuda.empty_cache()


def serve_moe(seed: int) -> None:
    """12a: full-width qwen2-moe-a2.7b in bf16: the paged engine (prefix
    sharing) and the striped engine on one 12-request trace, the static
    engine at 4 x 512; a replayed decode tick of 8 live slots beside its
    weight-read bound (``tick_vs_bound``), and the grouped prefill's ms
    per prompt token."""
    import torch
    from repro_torch.models import forward, make_batch
    torch.cuda.reset_peak_memory_stats()
    cfg, params, n, read = family_model(MOE_ARCH, torch.bfloat16, seed)
    log(f"[moe] {MOE_ARCH} full width: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_experts} experts top-{cfg.top_k} + shared "
        f"{cfg.shared_expert_d_ff}, {n / 1e9:.3f}B params; a decode tick "
        f"reads {read / 1e9:.3f} GB of weights (every expert: the static "
        f"dispatch)")
    trace = family_trace(cfg.vocab_size, seed + 80)
    eng = serve_paged_family(cfg, params, trace, "qwen2-moe paged")
    del eng
    torch.cuda.empty_cache()
    tick_vs_bound(cfg, params, read, "qwen2-moe", seed + 81)
    toks = torch.randint(0, cfg.vocab_size, (1, 1024), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(seed))
    run = lambda: forward(cfg, params, {"tokens": toks}, moe_cf=None,
                          last_only=True)
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    per_tok = (time.perf_counter() - t0) / 3 / 1024 * 1e3
    log(f"[moe] grouped prefill of a 1024-token prompt: {per_tok:.4f} ms "
        f"a prompt token ({per_tok * 1024:.1f} ms; one host read of the "
        f"expert counts a layer)")
    batch = make_batch(cfg, 4, 512, seed=seed + 82, device="cuda")
    serve_static_family(cfg, params, batch, 32, "qwen2-moe static",
                        cfg.n_layers)
    serve_striped_family(cfg, params, trace, "qwen2-moe striped")
    log(f"[moe] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del params
    torch.cuda.empty_cache()


def serve_llama4(seed: int) -> None:
    """12b: llama4-maverick at full width, depth cut to 2 layers (dense,
    then 128-expert MoE; 400B parameters do not fit one card): the paged
    engine on 8 requests, and ``tick_vs_bound``."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    cfg, params, n, read = family_model(LLAMA4_ARCH, torch.bfloat16, seed,
                                        n_layers=LLAMA4_LAYERS)
    log(f"[llama4] {LLAMA4_ARCH} at full width, {cfg.n_layers} layers "
        f"{cfg.layer_pattern[:cfg.n_layers]}: {n / 1e9:.3f}B params, a "
        f"decode tick reads {read / 1e9:.3f} GB")
    trace = family_trace(cfg.vocab_size, seed + 83, n=8, new=(32, 65))
    eng = serve_paged_family(cfg, params, trace, "llama4 paged")
    del eng
    torch.cuda.empty_cache()
    tick_vs_bound(cfg, params, read, "llama4", seed + 87)
    log(f"[llama4] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del params
    torch.cuda.empty_cache()


def serve_vlm(seed: int) -> None:
    """12c: full-width pixtral-12b in bf16: the static engine on 4 x (64
    patch embeddings + 256 text tokens), then the paged engine on a
    12-request text trace, and ``tick_vs_bound``."""
    import torch
    from repro_torch.models import make_batch
    torch.cuda.reset_peak_memory_stats()
    cfg, params, n, read = family_model(VLM_ARCH, torch.bfloat16, seed)
    log(f"[vlm] {VLM_ARCH} full width: {cfg.n_layers} layers, "
        f"{n / 1e9:.3f}B params, a decode tick reads {read / 1e9:.3f} GB")
    batch = make_batch(cfg, 4, cfg.n_patches + 256, seed=seed + 84,
                       device="cuda")
    serve_static_family(cfg, params, batch, 32, "pixtral static",
                        cfg.n_layers)
    eng = serve_paged_family(cfg, params,
                             family_trace(cfg.vocab_size, seed + 85),
                             "pixtral paged")
    del eng
    torch.cuda.empty_cache()
    tick_vs_bound(cfg, params, read, "pixtral", seed + 88)
    log(f"[vlm] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del params
    torch.cuda.empty_cache()


def serve_whisper(seed: int) -> None:
    """12d: full whisper-large-v3 in bf16 (32 encoder + 32 decoder
    layers): the static engine on 4 x (1500 random frames + 64 prompt
    tokens), 64 new tokens; flash == 32 non-causal (encoder) + 32 causal
    launches for the prefill."""
    import torch
    from repro_torch.models import make_batch
    torch.cuda.reset_peak_memory_stats()
    cfg, params, n, read = family_model(ENCDEC_ARCH, torch.bfloat16, seed)
    log(f"[encdec] {ENCDEC_ARCH}: {cfg.n_enc_layers} encoder + "
        f"{cfg.n_layers} decoder layers, {n / 1e9:.3f}B params")
    batch = make_batch(cfg, 4, 64, seed=seed + 86, device="cuda")
    serve_static_family(cfg, params, batch, 64, "whisper static",
                        cfg.n_enc_layers + cfg.n_layers)
    log(f"[encdec] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del params
    torch.cuda.empty_cache()


def _fp32_engines(cfg, params, trace, label: str, layouts=(True, False)):
    """``trace`` through the paged and striped engines in fp32, every
    token held to the plain teacher-forced argmax; returns (checked,
    skipped)."""
    import torch
    from repro_torch.serving import ContinuousBatchingEngine
    checked = skipped = 0
    for paged in layouts:
        layout = "paged" if paged else "striped"
        eng = ContinuousBatchingEngine(cfg, params, n_slots=8, max_len=1024,
                                       page_size=16, paged=paged)
        for i, (p, n) in enumerate(trace):
            eng.submit(p, n, req_id=i)
        out = eng.run()
        for i, (prompt, _) in enumerate(trace):
            c, k = teacher_forced(cfg, params, prompt, out[i],
                                  f"{label} {layout} request {i}", layout)
            checked, skipped = checked + c, skipped + k
        del eng
        torch.cuda.empty_cache()
    return checked, skipped


def _fp32_static(cfg, params, batch, n_new: int, label: str, extra_key=None,
                 cache_len=None):
    """The static engine on ``batch`` in fp32, each row held to the plain
    teacher-forced argmax (with its patches or frames)."""
    from repro_torch.serving import InferenceEngine
    out = InferenceEngine(cfg, params).generate(batch, n_new,
                                                cache_len=cache_len)
    checked = skipped = 0
    for i in range(out.shape[0]):
        extra = ({extra_key: batch[extra_key][i:i + 1]} if extra_key
                 else None)
        c, k = teacher_forced(cfg, params, batch["tokens"][i].tolist(),
                              out[i].tolist(), f"{label} static row {i}",
                              "striped", extra=extra)
        checked, skipped = checked + c, skipped + k
    return checked, skipped


def check_families_fp32(seed: int) -> None:
    """12e: qwen2-moe at full width and depth 4, pixtral at depth 2 (with
    patches) and whisper at full depth (with frames), in fp32, through
    each path the JAX package serves them on; every token held to the
    plain teacher-forced argmax where the top-2 margin exceeds MARGIN,
    and the MoE engines' graph replays held to the eager decode_step on
    a clone within GRAPH_TOL."""
    import numpy as np
    import torch
    from repro_torch.models import make_batch, n_positions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(seed + 90)
    results = []
    cfg, params, _, _ = family_model(MOE_ARCH, torch.float32, seed,
                                     n_layers=MOE_FP32_LAYERS)
    tok = lambda k: list(map(int, rng.integers(0, cfg.vocab_size, k)))
    a = tok(300)
    trace = [(a, 16), (a[:200] + tok(50), 16), (tok(150), 16)]
    c, k = _fp32_engines(cfg, params, trace, "qwen2-moe")
    c2, k2 = _fp32_static(cfg, params, make_batch(
        cfg, 2, 128, seed=seed + 91, device="cuda"), 16, "qwen2-moe")
    results.append(("qwen2-moe", c + c2, k + k2))
    for paged in (True, False):
        label = f"qwen2-moe fp32 {'paged' if paged else 'striped'}"
        eng, first = compiled_engine(cfg, params, paged, 1024, seed + 92)
        rel = graph_vs_eager(cfg, params, eng, 3)
        if rel > GRAPH_TOL:
            raise AssertionError(f"{label}: replay vs eager {rel:.3g} of "
                                 f"the largest logit")
        log(f"[compiled] {label}: 3 replays vs the eager step, max |diff| "
            f"{rel:.3g} of the largest logit (tolerance {GRAPH_TOL}); "
            f"first tick + capture {first * 1e3:.1f} ms; {graph_note(eng)}")
        del eng
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    cfg, params, _, _ = family_model(VLM_ARCH, torch.float32, seed,
                                     n_layers=VLM_FP32_LAYERS)
    batch = make_batch(cfg, 2, cfg.n_patches + 96, seed=seed + 93,
                       device="cuda")
    c, k = _fp32_static(cfg, params, batch, 16, "pixtral", "patches",
                        cache_len=n_positions(cfg, batch) + 16)
    trace = [(tok(200), 16), (tok(90), 16)]
    c2, k2 = _fp32_engines(cfg, params, trace, "pixtral")
    results.append(("pixtral", c + c2, k + k2))
    del params
    torch.cuda.empty_cache()
    cfg, params, _, _ = family_model(ENCDEC_ARCH, torch.float32, seed)
    c, k = _fp32_static(cfg, params, make_batch(
        cfg, 2, 32, seed=seed + 94, device="cuda"), 24, "whisper", "frames")
    results.append(("whisper", c, k))
    del params
    torch.cuda.empty_cache()
    for label, c, k in results:
        if c < (c + k) // 2:
            raise AssertionError(f"{label}: only {c} tokens cleared the "
                                 f"margin")
    log("[fp32] 12e " + "; ".join(
        f"{label}: {c} tokens equal the plain teacher-forced argmax, {k} "
        f"skipped" for label, c, k in results)
        + f" (top-2 margin <= {MARGIN}); qwen2-moe at depth "
        f"{MOE_FP32_LAYERS} (paged, striped, static), pixtral at depth "
        f"{VLM_FP32_LAYERS} (static with patches, paged, striped), whisper "
        f"at full depth (static with frames)")


# ------------------------------------------------------------ phase 13
TRAIN_ARCH = "qwen2.5-3b"
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 512, 8
TRAIN_LOSS_TOL = 1e-5       # training loss vs the kernel forward's, relative
TRAIN_GRAD_TOL = 1e-4       # card vs CPU gradient, relative L2 a leaf
ADAMW_TOL = 1e-5            # adamw_update vs torch.optim.AdamW, relative L2
SERVE_MODES = ("slo", "disagg", "overload")


def _rel_l2(a, b) -> float:
    """||a - b|| / ||b|| in fp64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def train_full_width(seed: int) -> None:
    """13a: full-width qwen2.5-3b in fp32 through ``Trainer`` on the
    Markov corpus, B x S = 2 x 512, 8 steps: every loss finite, the last
    nll below the first; ms a step, tokens/s, peak device GB beside the
    reckoned 16 B a parameter (weights, gradients, mu, nu) plus
    activations.  13b: at the first batch, the training loss (the plain
    path with gradients) equals the loss of the no-grad kernel forward,
    which launches flash once a layer."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params
    from repro_torch.training import AdamWConfig, Trainer, data_iterator
    from repro_torch.training.train_loop import loss_terms, to_device
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(TRAIN_ARCH)
    params = init_params(cfg, seed=seed, device="cuda")
    n = sum(t.numel() for t in _leaves(params))
    it = data_iterator(cfg, TRAIN_B, TRAIN_S, seed=seed)
    batches = [next(it) for _ in range(TRAIN_STEPS)]
    first = to_device(batches[0], "cuda")
    out, _, counts = drive("train-kernel-loss", lambda: forward(
        cfg, params, first, kernel_impl="kernel"))
    expect("train-kernel-loss", counts, {"flash_attention": cfg.n_layers})
    kernel_loss = float(loss_terms(out, first["tokens"])[0])
    del out
    tr = Trainer(cfg, AdamWConfig(lr=3e-4, warmup_steps=2,
                                  total_steps=TRAIN_STEPS),
                 device="cuda", params=params)
    hist, secs = [], []

    def run():
        for b in batches:
            t0 = time.perf_counter()
            hist.append(tr.step(b))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
    _, wall, counts = drive("train", run)
    expect("train", counts, {})         # the plain path: no kernel
    if not all(math.isfinite(h[k]) for h in hist for k in ("loss", "nll")):
        raise AssertionError(f"training loss not finite: {hist}")
    if not hist[-1]["nll"] < hist[0]["nll"]:
        raise AssertionError(f"nll did not fall: {[h['nll'] for h in hist]}")
    rel = abs(hist[0]["loss"] - kernel_loss) / abs(kernel_loss)
    if rel > TRAIN_LOSS_TOL:
        raise AssertionError(f"training loss {hist[0]['loss']} vs kernel "
                             f"forward's {kernel_loss}: {rel:.3g} relative")
    peak = torch.cuda.max_memory_allocated()
    acts = (3 * TRAIN_B * TRAIN_S * cfg.vocab_size * 4
            + cfg.n_layers * TRAIN_B * TRAIN_S * cfg.d_model * 4)
    ms = sum(secs[1:]) / (len(secs) - 1) * 1e3
    log(f"[train] {TRAIN_ARCH} full width fp32 ({n / 1e9:.3f}B params), "
        f"{TRAIN_B} x {TRAIN_S} tokens a step, {TRAIN_STEPS} steps in "
        f"{wall:.2f} s: {ms:.1f} ms a step after the first "
        f"({secs[0] * 1e3:.1f} ms), {TRAIN_B * TRAIN_S / ms * 1e3:.0f} "
        f"tokens/s; nll " + " ".join(f"{h['nll']:.4f}" for h in hist)
        + f"; grad norm {hist[0]['grad_norm']:.3f} -> "
        f"{hist[-1]['grad_norm']:.3f}")
    log(f"[train] peak device memory {peak / 1e9:.2f} GB against "
        f"{16 * n / 1e9:.2f} GB reckoned (16 B a parameter: weights, "
        f"gradients, mu, nu) + {acts / 1e9:.2f} GB of activations "
        f"(fp32 logits x3, one checkpointed input a layer)")
    log(f"[train] 13b: training loss {hist[0]['loss']:.7f} vs the kernel "
        f"forward's {kernel_loss:.7f} ({cfg.n_layers} flash launches): "
        f"{rel:.3g} relative (tolerance {TRAIN_LOSS_TOL})")
    del tr, params
    torch.cuda.empty_cache()


def grads_card_vs_cpu(seed: int) -> None:
    """13c: qwen2.5-3b at full width, depth cut to 2, B x S = 1 x 128 in
    fp32: every gradient leaf on the card within TRAIN_GRAD_TOL relative
    L2 of the same step on the CPU (which the CPU tests hold to JAX); a
    leaf whose gradient is rounding only (a key bias) is held to 1e-7 of
    the whole gradient's norm instead."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.training import data_iterator
    from repro_torch.training.optimizer import tree_leaves, tree_map
    from repro_torch.training.train_loop import to_device, value_and_grad
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=2)
    card = init_params(cfg, seed=seed, device="cuda")
    cpu = tree_map(lambda t: t.cpu(), card)
    batch = next(data_iterator(cfg, 1, 128, seed=seed + 1))
    t0 = time.perf_counter()
    (loss_c, _), g_cpu = value_and_grad(cfg, cpu, to_device(batch, "cpu"))
    cpu_s = time.perf_counter() - t0
    (loss_g, _), g_card = value_and_grad(cfg, card, to_device(batch, "cuda"))
    want = tree_leaves(g_cpu)
    got = [g.cpu() for g in tree_leaves(g_card)]
    total = math.sqrt(sum(float(w.double().square().sum()) for w in want))
    worst = 0.0
    for i, (w, g) in enumerate(zip(want, got)):
        err = float((g.double() - w.double()).norm())
        if err > max(TRAIN_GRAD_TOL * float(w.double().norm()),
                     1e-7 * total):
            raise AssertionError(f"gradient leaf {i}: card vs CPU "
                                 f"{err:.3g} of {float(w.norm()):.3g}")
        worst = max(worst, _rel_l2(g, w) if float(w.norm()) > 1e-7 * total
                    else 0.0)
    rel = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    log(f"[train] 13c: {len(want)} gradient leaves of 2-layer full-width "
        f"{TRAIN_ARCH}, card vs CPU: worst {worst:.3g} relative L2 "
        f"(tolerance {TRAIN_GRAD_TOL}), loss {rel:.3g} relative; CPU step "
        f"{cpu_s:.2f} s")
    del card, g_card
    torch.cuda.empty_cache()


def adamw_vs_torch(seed: int) -> None:
    """13d: stablelm-1.6b at full width, depth 2, fp32, 3 steps: on the
    same gradients ``adamw_update`` moves every leaf as
    ``torch.optim.AdamW`` does (param groups from ``decay_mask``,
    ``clip_grad_norm_``, a ``LambdaLR`` giving ``lr_at(step + 1)``): the
    weights, mu and nu within ADAMW_TOL relative L2 a leaf (the update
    itself is printed)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.training import (AdamWConfig, adamw_update,
                                      data_iterator, init_opt_state, lr_at)
    from repro_torch.training.optimizer import decay_mask, tree_leaves
    from repro_torch.training.train_loop import to_device, value_and_grad
    cfg = dataclasses.replace(get_config("stablelm-1.6b"), n_layers=2)
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=3)
    params = init_params(cfg, seed=seed, device="cuda")
    start = [t.clone() for t in tree_leaves(params)]
    ref = [t.clone() for t in start]
    mask = tree_leaves(decay_mask(cfg, params))
    opt = torch.optim.AdamW(
        [{"params": [p for p, m in zip(ref, mask) if m],
          "weight_decay": opt_cfg.weight_decay},
         {"params": [p for p, m in zip(ref, mask) if not m],
          "weight_decay": 0.0}],
        lr=opt_cfg.lr, betas=(opt_cfg.beta1, opt_cfg.beta2),
        eps=opt_cfg.eps, foreach=False)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda s: float(lr_at(opt_cfg, s + 1)) / opt_cfg.lr)
    state = init_opt_state(params)
    decay = decay_mask(cfg, params)
    it = data_iterator(cfg, 1, 128, seed=seed + 2)
    for _ in range(3):
        _, grads = value_and_grad(cfg, params, to_device(next(it), "cuda"))
        params, state, met = adamw_update(opt_cfg, params, grads, state,
                                          decay=decay)
        for p, g in zip(ref, tree_leaves(grads)):
            p.grad = g.clone()
        torch.nn.utils.clip_grad_norm_(ref, opt_cfg.grad_clip)
        opt.step()
        sched.step()
    worst = {"params": 0.0, "mu": 0.0, "nu": 0.0, "update": 0.0}
    for p, p0, r, mu, nu in zip(tree_leaves(params), start, ref,
                                tree_leaves(state["mu"]),
                                tree_leaves(state["nu"])):
        st = opt.state[r]
        for name, a, b in (("params", p, r), ("mu", mu, st["exp_avg"]),
                           ("nu", nu, st["exp_avg_sq"]),
                           ("update", p - p0, r - p0)):
            e = _rel_l2(a, b)
            worst[name] = max(worst[name], e)
            # the update's own error is not held: it is a difference of
            # fp32 weights ~1e3 times its size (a norm scale of 1 moved
            # by ~3e-4 carries the weights' last-bit rounding)
            if e > ADAMW_TOL and name != "update":
                raise AssertionError(f"adamw_update vs torch.optim.AdamW: "
                                     f"{name} {e:.3g} relative L2")
    log(f"[train] 13d: adamw_update vs torch.optim.AdamW, 2-layer "
        f"full-width stablelm-1.6b, 3 steps ({len(ref)} leaves, "
        f"{sum(mask)} decayed; last lr {float(met['lr']):.3e}, grad norm "
        f"{float(met['grad_norm']):.3f}): worst relative L2 "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + f" (tolerance {ADAMW_TOL})")
    del params, ref, start, opt, state
    torch.cuda.empty_cache()


def checkpoint_and_moe(seed: int) -> None:
    """13e: a tensor-packed checkpoint of qwen2.5-3b at depth 4 (bf16)
    written, read back onto the card and its logits bit-equal to the
    source's; qwen2-moe-a2.7b at full width, depth 2, one fp32 training
    step: the load-balance aux is positive and the loss is nll + aux."""
    import dataclasses
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params, make_batch
    from repro_torch.training import (AdamWConfig, Trainer, data_iterator,
                                      load_checkpoint, save_checkpoint)
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=4)
    params = init_params(cfg, seed=seed, dtype=torch.bfloat16,
                         device="cuda")
    batch = make_batch(cfg, 2, 256, seed=seed + 3, device="cuda")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, cfg, params, n_blocks=4, step=1)
        loaded, step = load_checkpoint(d, cfg, device="cuda")
    ck_s = time.perf_counter() - t0
    a = forward(cfg, params, batch)["logits"]
    b = forward(cfg, loaded, batch)["logits"]
    if step != 1 or not torch.equal(a, b):
        raise AssertionError(f"checkpoint round trip: step {step}, max "
                             f"|logit diff| {float((a - b).abs().max())}")
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"[train] 13e: checkpoint of 4-layer full-width {TRAIN_ARCH} "
        f"({nbytes / 1e9:.3f} GB bf16, 4 blocks) saved and loaded in "
        f"{ck_s:.2f} s; logits bit-equal")
    del params, loaded, a, b
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=2)
    tr = Trainer(cfg, AdamWConfig(warmup_steps=1, total_steps=10),
                 seed=seed, device="cuda")
    met = tr.step(next(data_iterator(cfg, 1, 256, seed=seed + 4)))
    if not (met["aux"] > 0 and met["loss"] > met["nll"]
            and math.isfinite(met["loss"])):
        raise AssertionError(f"MoE training step: {met}")
    log(f"[train] 13e: {MOE_ARCH} full width, depth 2, one step: loss "
        f"{met['loss']:.4f} = nll {met['nll']:.4f} + aux {met['aux']:.5f}")
    del tr
    torch.cuda.empty_cache()


def serve_modes_and_examples(seed: int) -> None:
    """13f: ``launch/serve.py`` --slo, --disagg and --overload at full
    width in bf16 (their own assertions: tokens equal across policies,
    disaggregated tokens bit-equal to unified), each a counted path with
    paged-step and flash launches; then every ``examples/torch_*.py`` at
    its defaults."""
    import argparse
    import importlib.util
    import torch
    from repro_torch.launch import serve
    args = argparse.Namespace(arch=TRAIN_ARCH, d_model=None, device=None,
                              dtype="bfloat16", seed=seed, requests=8,
                              prompt=64, tokens=16, slots=4, nodes=6)
    for mode in SERVE_MODES:
        _, wall, counts = drive(f"serve-{mode}",
                                lambda m=mode: getattr(serve, f"run_{m}")(
                                    args))
        if not (counts["paged_decode_step"] and counts["flash_attention"]):
            raise AssertionError(f"--{mode}: kernels not launched: {counts}")
        log(f"[serve] --{mode} full width bf16 in {wall:.2f} s; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        torch.cuda.empty_cache()
    for path in sorted((ROOT / "examples").glob("torch_*.py")):
        spec = importlib.util.spec_from_file_location(path.stem, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        t0 = time.perf_counter()
        mod.main([])
        torch.cuda.synchronize()
        log(f"[example] {path.name} at its defaults in "
            f"{time.perf_counter() - t0:.2f} s")
        torch.cuda.empty_cache()


# ------------------------------------------------ 14: dry-run and fit check
DRYRUN_ARCHS = ("starcoder2-3b", "whisper-large-v3", "recurrentgemma-2b",
                "starcoder2-15b", "pixtral-12b", "qwen2.5-3b",
                "qwen2-moe-a2.7b", "llama4-maverick-400b-a17b",
                "stablelm-1.6b", "xlstm-1.3b", "llama2-7b")
# (arch, shape, preset) beyond every arch's decode_32k and long_500k
DRYRUN_MORE = (("qwen2.5-3b", "train_4k", None),
               ("qwen2.5-3b", "prefill_32k", None),
               ("qwen2-moe-a2.7b", "train_4k", None),
               ("qwen2-moe-a2.7b", "prefill_32k", None),
               ("qwen2.5-3b", "prefill_32k", "tuned-moe"),
               ("qwen2-moe-a2.7b", "prefill_32k", "tuned-moe"))
FIT_TOL = 0.10              # predicted vs measured peak, relative
FIT_DECODE = (8, 32_768)    # slots, max_len of the bf16 decode fit check


def _dryrun_record(combo):
    """One 14a record in a worker process: (record, trace seconds).  The
    fake process group is process-global, so each record runs alone in
    its process, as the tests run it."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    torch.set_num_threads(2)
    from repro_torch.launch.dryrun import PRESETS, run_one
    from repro_torch.launch.dryrun_ewl import run_ewl
    t0 = time.perf_counter()
    if combo is None:
        rec = run_ewl(verbose=False)
    else:
        arch, shape, preset = combo
        rec = run_one(arch, shape, verbose=False,
                      opts=PRESETS[preset] if preset else None,
                      tag=f"+{preset}" if preset else "")
    rec.pop("traceback", None)
    return rec, time.perf_counter() - t0


def dryrun_records(combos=None, workers: int = 6) -> None:
    """14a: ``launch.dryrun.run_one`` at full width on the 16x16
    placeholder mesh (no device): every arch on decode_32k and long_500k
    (skipped exactly where ``specs.applicable`` says, as in JAX), qwen2.5-3b
    and qwen2-moe on train_4k and prefill_32k, their prefill also under
    ``tuned-moe``, then one ``dryrun_ewl`` record at its defaults; the
    records are traced in ``workers`` processes at once (host CPU work,
    while the card idles; they run alone in their phase, on six of the
    card machine's eight cores: the phase was the host's slowest).  Each record
    is printed on a line of its own, in order; an error fails the run."""
    import concurrent.futures
    import multiprocessing
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.specs import applicable
    if combos is None:
        combos = [(a, s, None) for a in DRYRUN_ARCHS
                  for s in ("decode_32k", "long_500k")] + list(DRYRUN_MORE)
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        done = list(ex.map(_dryrun_record, list(combos) + [None]))
    for combo, (rec, took) in zip(combos, done):
        arch, shape, preset = combo
        log("[dryrun] " + json.dumps(rec))
        want = "ok" if applicable(get_config(arch), SHAPES[shape])[0] \
            else "skipped"
        if rec["status"] != want:
            raise AssertionError(f"dry-run {arch} x {shape} ({preset}): "
                                 f"{rec['status']} {rec.get('error')}")
        if want == "ok":
            m = rec["memory"]
            gib = (m["argument_size_in_bytes"]
                   + m["temp_size_in_bytes"]) / 2 ** 30
            log(f"[dryrun] {arch} x {shape}{rec['mesh'][8:]}: "
                f"{gib:.2f} GiB a device, flops {rec['hlo_flops']:.4g},"
                f" collectives {sum(rec['collective_bytes'].values()):.4g} B"
                f" -> {rec['bottleneck']} (trace {took:.1f} s)")
    log("[dryrun] " + json.dumps(done[-1][0]))


def fit_check(seed: int) -> None:
    """14b: the dry-run on a one-rank mesh predicts a step's peak device
    memory (argument bytes + the peak of live intermediates); the same
    step then runs on the card from a clean allocator and its
    ``max_memory_allocated`` (less what earlier phases still hold) is
    held to the prediction within FIT_TOL: phase 13a's fp32 qwen2.5-3b
    training step at 2 x 512 tokens, and a bf16 qwen2.5-3b
    ``decode_step`` of 8 slots at max_len 32768 (the kernel path)."""
    import torch
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch.dryrun import run_one
    from repro_torch.launch.mesh import placeholder_mesh
    from repro_torch.models import decode_step, init_cache, init_params
    from repro_torch.training import AdamWConfig, data_iterator, \
        init_opt_state
    from repro_torch.training.train_loop import make_train_step, to_device
    mesh = placeholder_mesh((1, 1), ("data", "model"))
    cfg = get_config(TRAIN_ARCH)
    B, L = FIT_DECODE

    def predict(shape, dtype):
        rec = run_one(TRAIN_ARCH, shape.name, mesh=mesh, shape=shape,
                      dtype=dtype, verbose=False)
        if rec["status"] != "ok":
            raise AssertionError(f"fit dry-run {shape}: {rec.get('error')}")
        m = rec["memory"]
        return m["argument_size_in_bytes"] + m["temp_size_in_bytes"], m

    def measure(run):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        torch.cuda.empty_cache()
        return peak

    def train():
        params = init_params(cfg, seed=seed, device="cuda")
        opt = init_opt_state(params)
        batch = to_device(next(data_iterator(cfg, TRAIN_B, TRAIN_S,
                                             seed=seed)), "cuda")
        make_train_step(cfg, AdamWConfig())(params, opt, batch)

    def decode():
        params = init_params(cfg, seed=seed, dtype=torch.bfloat16,
                             device="cuda")
        cache = init_cache(cfg, B, L, dtype=torch.bfloat16, device="cuda")
        pos = torch.full((B,), L // 2, dtype=torch.int32, device="cuda")
        tok = torch.zeros((B,), dtype=torch.int32, device="cuda")
        decode_step(cfg, params, cache, tok, pos)

    for what, shape, dtype, run in (
            ("train fp32 2x512", InputShape("train_fit", TRAIN_S, TRAIN_B,
                                            "train"), torch.float32, train),
            (f"decode bf16 {B} slots x {L}",
             InputShape("decode_fit", L, B, "decode"), torch.bfloat16,
             decode)):
        t0 = time.perf_counter()
        pred, m = predict(shape, dtype)
        t1 = time.perf_counter()
        got = measure(run)
        ratio = pred / got
        log(f"[fit] {TRAIN_ARCH} {what}: predicted {pred / 1e9:.3f} GB "
            f"(arguments {m['argument_size_in_bytes'] / 1e9:.3f} + temp "
            f"{m['temp_size_in_bytes'] / 1e9:.3f}; dry-run {t1 - t0:.1f} s)"
            f", measured max_memory_allocated {got / 1e9:.3f} GB: "
            f"ratio {ratio:.4f} on {smi()}")
        if abs(ratio - 1) > FIT_TOL:
            raise AssertionError(f"fit {what}: predicted {pred} vs measured "
                                 f"{got} bytes ({ratio:.4f})")
    import torch.distributed as dist
    dist.destroy_process_group()


def card_rates() -> None:
    """14c: the card's bf16 matmul rate (8192^3, CUDA events) and copy
    bandwidth (1 GiB read + 1 GiB written) beside the dry-run's
    constants (data-sheet peaks)."""
    import torch
    from repro_torch.launch.dryrun import HBM_BW, LINK_BW, PEAK_FLOPS
    n = 8192
    a = torch.randn((n, n), dtype=torch.bfloat16, device="cuda")
    b = torch.randn((n, n), dtype=torch.bfloat16, device="cuda")
    mm = time_ms(lambda: a @ b, iters=20)
    x = torch.empty(2 ** 29, dtype=torch.bfloat16, device="cuda")
    y = torch.empty_like(x)
    cp = time_ms(lambda: y.copy_(x), iters=20)
    rate = 2 * n ** 3 / (mm / 1e3)
    bw = 2 * x.numel() * 2 / (cp / 1e3)
    log(f"[rates] bf16 matmul {n}^3: {mm:.4f} ms, {rate / 1e12:.1f} TFLOP/s "
        f"(dry-run constant {PEAK_FLOPS / 1e12:.0f}); copy 1 GiB: "
        f"{cp:.4f} ms, {bw / 1e12:.3f} TB/s (constant {HBM_BW / 1e12:.2f}); "
        f"link {LINK_BW / 1e9:.0f} GB/s not measured (one card); {smi()}")
    del a, b, x, y
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 15
PAD_TOL = 1e-4       # padded vs unpadded fp32 step, of a leaf's largest |x|
# xlstm-1.3b: its sLSTM recurrence carries the rounding of every
# product before it, whose summation order changes with the row count
# (a padded prompt's or a batch's), through 300 steps and 6 sLSTM layers;
# ``padding_gap`` holds the padding in fp64 and the padded fp32 state to
# PAD_GAP_FACTOR times the gap that batching the prompt gives
PAD_TOL_ARCH = {"xlstm-1.3b": 1e-2}
PAD_TOL_FP64 = 1e-9  # padded vs exact, fp64 plain path
# ``padding_gap``: xlstm-1.3b cut to two sLSTM blocks, prompt lengths
# (one bucket), prompt seeds
PAD_GAP_LAYERS, PAD_GAP_LENGTHS, PAD_GAP_SEEDS = 16, (300, 400), (0, 1, 2)
PAD_GAP_FACTOR = 2.0
VLM_PREFILL_LAYERS = 4                 # 15a: pixtral-12b in fp32, 40 -> 4
# the same bursts with eager prefills, on an H100 80GB HBM3 at 700 W
# (PERF.md section 5): wall s, busy s (None: not kept), prompt tokens
EAGER_BURST = {"qwen2.5-3b": (1.0511, 0.3099, 256),
              "recurrentgemma-2b": (0.8025, None, 256),
              "xlstm-1.3b": (3.3520, None, 64)}
EAGER_BY_RULE = ("MoE prefill (the grouped form reads the expert counts to "
                 "the host), paged_copy_page (two index copies before a "
                 "suffix prefill), the mode-switch recompute "
                 "(core.mode_switch), the training step, the live "
                 "cluster's execution pipelines (each serves only until "
                 "its nodes mode-switch, a few ticks: a capture a bucket "
                 "would not be repaid)")


def _state_gap(a, b, paged: bool):
    """(bitwise equal, largest |a - b| over the largest |b| of any leaf)
    of two engines' caches, the pools without their trash page (padded
    rows write it in no fixed order)."""
    import torch

    def pairs(x, y):
        for name in x:
            u, v = x[name], y[name]
            if isinstance(u, dict):
                yield from pairs(u, v)
            elif paged and "k" in x:
                yield u[:-1], v[:-1]
            else:
                yield u, v
    equal, gap = True, 0.0
    for x, y in zip(a["layers"], b["layers"]):
        for u, v in pairs(x, y):
            equal &= torch.equal(u, v)
            if v.is_floating_point():
                scale = v.float().abs().max().item() or 1.0
                gap = max(gap, (u.float() - v.float()).abs().max().item()
                          / scale)
            elif not torch.equal(u, v):
                gap = float("inf")
    return equal and torch.equal(a["pos"], b["pos"]), gap


def _unpadded(cfg, params, eng):
    """``eng``'s prefill step replaced by the unpadded eager one at the
    exact length (forward, then the scatter with host ints): the
    reference a padded step is held to."""
    import torch
    from repro_torch.models import (cache_from_prefill, cache_scatter,
                                    forward, paged_prefill_scatter,
                                    paged_suffix_prefill)

    def step(kind, slot, toks):
        t = torch.tensor([list(toks)], device="cuda")
        if kind == "suffix":
            logits, _ = paged_suffix_prefill(cfg, params, eng.cache, t, slot,
                                             int(eng._start[0]))
            first = logits.argmax(-1)
        else:
            out = forward(cfg, params, {"tokens": t}, build_cache=True,
                          cache_len=eng.max_len, moe_cf=None,
                          last_only=True)
            first = out["logits"][0, -1:].argmax(-1)
            if eng.paged:
                paged_prefill_scatter(cfg, eng.cache, out["kv"], slot,
                                      eng.cache["pages"][slot], len(toks))
            else:
                cache_scatter(eng.cache, cache_from_prefill(
                    cfg, out["kv"], eng.max_len, len(toks)), slot)
        eng._tok[slot] = first[0]
        return first
    eng._prefill_step = step
    return eng


def check_prefill_engines(cfg, params, label: str, paged: bool, trace,
                          sharing: bool = False) -> None:
    """15a for a ``ContinuousBatchingEngine``: three engines on one fp32
    model (captured prefills; the same padded steps eager; the unpadded
    eager steps) serve ``trace`` (one new token a request: prefills
    only) tick by tick.  After every tick the captured engine's cache is
    bitwise equal to the eager one's and within PAD_TOL (PAD_TOL_ARCH) of
    the unpadded one's, with equal launch counts on all three; the first
    tokens are equal."""
    import torch
    from repro_torch.kernels import KERNELS, graph, reset_launch_counts
    from repro_torch.serving import ContinuousBatchingEngine
    kw = dict(n_slots=4, max_len=1024, paged=paged, page_size=16,
              prefix_sharing=sharing, max_prefill_per_tick=2)
    engines = [ContinuousBatchingEngine(cfg, params, **kw) for _ in range(3)]
    g, e, x = engines
    e.prefill_graphs = graph.StepGraphs("cuda", capturing=False)
    _unpadded(cfg, params, x)
    for eng in engines:
        for i, (p, n) in enumerate(trace):
            eng.submit(p, n, req_id=i)
    gap, ticks, total = 0.0, 0, {}
    tol = PAD_TOL_ARCH.get(cfg.arch_id, PAD_TOL)
    while True:
        counts, ran = [], []
        for eng in engines:
            reset_launch_counts()
            ran.append(eng.step())
            torch.cuda.synchronize()
            counts.append({k.__name__: k.launches for k in KERNELS
                           if k.launches})
        if len(set(ran)) != 1 or counts[1:] != counts[:2]:
            raise AssertionError(f"{label}: tick {ticks} launch counts "
                                 f"differ: {counts}")
        if not ran[0]:
            break
        ticks += 1
        for k, n in counts[0].items():
            total[k] = total.get(k, 0) + n
        same, _ = _state_gap(g.cache, e.cache, paged)
        if not same or not torch.equal(g._tok, e._tok):
            raise AssertionError(f"{label}: tick {ticks}: the replayed "
                                 f"prefill is not bitwise the eager one")
        gap = max(gap, _state_gap(g.cache, x.cache, paged)[1])
        if gap > tol:
            raise AssertionError(f"{label}: tick {ticks}: padded vs "
                                 f"unpadded cache {gap:.3g} of the largest "
                                 f"value (tolerance {tol})")
    firsts = [{r: q.generated[0] for r, q in eng.sched.finished.items()}
              for eng in engines]
    if firsts[0] != firsts[1] or firsts[0] != firsts[2]:
        raise AssertionError(f"{label}: first tokens differ: {firsts}")
    kinds = {k[0] for k, st in g.prefill_graphs.steps.items() if st.replays}
    if "fresh" not in kinds or (sharing and "suffix" not in kinds):
        raise AssertionError(f"{label}: no replayed prefill ({kinds})")
    log(f"[prefill] {label} fp32: {len(trace)} prompts "
        f"({', '.join(str(len(p)) for p, _ in trace)} tokens) in {ticks} "
        f"ticks; replays bitwise equal to the eager padded steps, launch "
        f"counts equal on all three paths, tick by tick ({total} in all), "
        f"first tokens equal to the unpadded steps', cache within "
        f"{gap:.3g} of theirs (tolerance {tol}); shared tokens "
        f"{g.stats['shared_tokens']}; {prefill_note(g)}")


def padding_gap(cfg, params, seed: int) -> None:
    """What the padded xlstm prefill's gap to the exact one is made of
    (xlstm-1.3b cut to PAD_GAP_LAYERS layers: two sLSTM blocks), for
    prompts of each of PAD_GAP_LENGTHS tokens from each of
    PAD_GAP_SEEDS, all padded to one bucket:
    (1) the sLSTM input product (``xlstm._slstm_pre``, the first sLSTM
    layer's weights) on a random (1, n, d) input, at n rows and as the
    first n of the bucket's rows: how many outputs differ and by how much
    (of the largest), beside each one's error to the fp64 product;
    (2) per prompt, each cache's gap (largest |diff| of a leaf over its
    largest |value|, with its layer and leaf) to the exact-length fp64
    prefill on the plain path (the same weights in fp64): fp32 exact;
    fp32 exact in a batch with a second prompt of the same length (its
    row 0: batching changes every product's row count, as padding
    does); fp32 padded; fp64 padded, which must lie within PAD_TOL_FP64
    (the padding is exact).  Then padded vs exact and batched vs exact,
    fp32 against fp32: the largest padded gap is held to PAD_GAP_FACTOR
    times the largest batched one."""
    import numpy as np
    import torch
    from repro_torch.models import forward
    from repro_torch.models.xlstm import _slstm_pre
    from repro_torch.serving.engine import prefill_bucket
    p64 = _map_tree(lambda t: t.double(), params)
    sl = next(lp["slstm"] for lp in params["layers"] if "slstm" in lp)
    sl64 = _map_tree(lambda t: t.double(), sl)
    Sb = prefill_bucket(max(PAD_GAP_LENGTHS), 1024)
    rng = np.random.default_rng(seed + 153)

    def rel(a, b):
        return (a.double() - b.double()).abs().max().item() / (
            b.double().abs().max().item() or 1.0)
    prods = []
    for n in PAD_GAP_LENGTHS:
        for _ in PAD_GAP_SEEDS:
            x = torch.from_numpy(rng.standard_normal(
                (1, Sb, cfg.d_model), dtype=np.float32)).cuda()
            at_n = _slstm_pre(sl, x[:, :n])
            in_b = _slstm_pre(sl, x)[:, :, :n]
            want = _slstm_pre(sl64, x[:, :n].double())
            prods.append((n, (at_n != in_b).float().mean().item(),
                          rel(in_b, at_n), rel(at_n, want), rel(in_b, want)))
    log(f"[prefill] {cfg.arch_id} sLSTM input product at n rows vs the "
        f"first n of {Sb} rows, fp32 (share of outputs that differ, "
        f"largest diff of the largest output; each one's error to fp64): "
        + "; ".join(f"n {n}: {100 * share:.1f}% differ by up to {d:.3g} "
                    f"(errors {e1:.3g} at n rows, {e2:.3g} in {Sb})"
                    for n, share, d, e1, e2 in prods))

    def run(p, t, **kw):
        return forward(cfg, p, {"tokens": t}, build_cache=True,
                       moe_cf=None, last_only=True, **kw)["kv"]

    def gap(kv, ref):
        return max((rel(a[leaf], b[leaf]), i, leaf)
                   for i, (a, b) in enumerate(zip(kv, ref)) for leaf in b)
    pairs = []
    for n in PAD_GAP_LENGTHS:
        for s in PAD_GAP_SEEDS:
            r = np.random.default_rng(seed + 154 + s)
            toks = torch.from_numpy(r.integers(0, cfg.vocab_size,
                                               (2, n))).cuda()
            pad = torch.zeros((1, Sb), dtype=torch.int64, device="cuda")
            pad[:, :n] = toks[:1]
            length = torch.tensor([n]).cuda()
            ref = run(p64, toks[:1], kernel_impl="plain")
            exact = run(params, toks[:1])
            runs = {"fp32 exact": exact,
                    "fp32 exact batched": [{k: v[:1] for k, v in st.items()}
                                           for st in run(params, toks)],
                    f"fp32 padded to {Sb}": run(params, pad, length=length),
                    f"fp64 padded to {Sb} plain": run(p64, pad,
                                                      length=length,
                                                      kernel_impl="plain")}
            gaps = {k: gap(kv, ref) for k, kv in runs.items()}
            if gaps[f"fp64 padded to {Sb} plain"][0] > PAD_TOL_FP64:
                raise AssertionError(f"{cfg.arch_id}: the fp64 padded "
                                     f"prefill is not the exact one")
            pairs.append((gap(runs[f"fp32 padded to {Sb}"], exact)[0],
                          gap(runs["fp32 exact batched"], exact)[0]))
            log(f"[prefill] {cfg.arch_id} depth {cfg.n_layers}, seed {s}, "
                f"{n}-token prompt, state gap to the exact-length fp64 "
                f"prefill: " + ", ".join(
                    f"{k} {g:.3g} (layer {i} {leaf})"
                    for k, (g, i, leaf) in gaps.items())
                + f"; to the fp32 exact prefill: padded {pairs[-1][0]:.3g}"
                f", batched {pairs[-1][1]:.3g}")
    padded, batched = max(a for a, _ in pairs), max(b for _, b in pairs)
    log(f"[prefill] {cfg.arch_id}: fp32 vs fp32 exact over "
        f"{len(pairs)} prompts, padded {min(a for a, _ in pairs):.3g}.."
        f"{padded:.3g}, batched {min(b for _, b in pairs):.3g}.."
        f"{batched:.3g} (padded held to {PAD_GAP_FACTOR} x the batched)")
    if padded > PAD_GAP_FACTOR * batched:
        raise AssertionError(f"{cfg.arch_id}: padding moves the fp32 "
                             f"state further than batching does")
    del p64


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def check_static_prefill(cfg, params, batches, n_new: int, label: str):
    """15a for ``InferenceEngine``: captured (prefill and decode) against
    the same engine eager, ``generate`` on each batch (all of one shape:
    the second call replays both); tokens and the engine's cache bitwise
    equal and launch counts equal.  The engine pads nothing: its
    replayed prefill's first token equals a direct ``forward``'s at the
    same shape, its cache within PAD_TOL (printed: bitwise or not)."""
    import torch
    from repro_torch.kernels import KERNELS, graph, reset_launch_counts
    from repro_torch.models import cache_from_prefill, forward, n_positions
    from repro_torch.serving import InferenceEngine
    g, e = InferenceEngine(cfg, params), InferenceEngine(cfg, params)
    e.prefill_graphs = graph.StepGraphs("cuda", capturing=False)
    e.decode_graphs = graph.StepGraphs("cuda", capturing=False)
    for batch in batches:
        out, counts = [], []
        for eng in (g, e):
            reset_launch_counts()
            out.append(eng.generate(batch, n_new))
            torch.cuda.synchronize()
            counts.append({k.__name__: k.launches for k in KERNELS
                           if k.launches})
        if not torch.equal(*out) or counts[0] != counts[1]:
            raise AssertionError(f"{label}: replays differ from eager "
                                 f"({counts})")
        for x, y in zip(g._shapes.values(), e._shapes.values()):
            if not _state_gap(x["cache"], y["cache"], False)[0]:
                raise AssertionError(f"{label}: replayed cache differs")
    batch = batches[-1]
    cache_len = batch["tokens"].shape[1] + n_new
    logits, cache = g.prefill(batch, cache_len=cache_len)
    ref = forward(cfg, params, batch, build_cache=True, cache_len=cache_len,
                  moe_cf=None, last_only=True)
    want = cache_from_prefill(cfg, ref["kv"], cache_len,
                              n_positions(cfg, batch))
    same, gap = _state_gap(cache, want, False)
    if not torch.equal(logits.argmax(-1), ref["logits"][:, -1].argmax(-1)) \
            or gap > PAD_TOL:
        raise AssertionError(f"{label}: replayed prefill vs forward: first "
                             f"tokens or cache ({gap:.3g})")
    dec = next(iter(g.decode_graphs.steps.values()))
    log(f"[prefill] {label} fp32 InferenceEngine: {len(batches)} x "
        f"generate({tuple(batch['tokens'].shape)}, {n_new} new) captured "
        f"vs eager: tokens, cache and launch counts equal ({counts[0]}); "
        f"replayed prefill vs a direct forward: first tokens equal, cache "
        f"{'bitwise equal' if same else f'within {gap:.3g}'}; "
        f"{prefill_note(g)}; decode graph {dec.capture_s:.2f} "
        f"s, {dec.pool_bytes / 2**20:.1f} MiB, {dec.replays} replays")


def prefill_fp32(seed: int) -> None:
    """15a: each captured step in fp32 at full width (pixtral cut to
    VLM_PREFILL_LAYERS layers): qwen2.5-3b paged with prefix sharing
    (fresh and suffix prefills) and striped, recurrentgemma-2b and
    xlstm-1.3b paged, pixtral-12b (patches) and whisper-large-v3
    (frames) on ``InferenceEngine``."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import rglru_scan
    from repro_torch.models import init_params, make_batch
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(seed + 150)
    tok = lambda n: list(map(int, rng.integers(0, 32000, n)))  # noqa: E731
    base = tok(300)
    dense = [(base + tok(20), 1), (tok(400), 1), (base[:200] + tok(50), 1),
             (tok(290), 1), (base[:150] + tok(40), 1),
             (base[:250] + tok(30), 1)]
    recurrent = [(tok(n), 1) for n in (300, 400, 290, 100, 120)]
    for arch, trace, layouts in (
            ("qwen2.5-3b", dense, (True, False)),
            ("recurrentgemma-2b", recurrent, (True,)),
            ("xlstm-1.3b", recurrent, (True,))):
        cfg = get_config(arch)
        params = init_params(cfg, seed=seed, dtype=torch.float32,
                             device="cuda")
        # the RG-LRU scan's look-back adds carries in the order its chunks
        # arrive, so two runs may differ in the last bits: one chunk a
        # chain (the plain walk) sums in one order, run after run
        rglru_scan.force_chunks = 1 if arch == "recurrentgemma-2b" else None
        for paged in layouts:
            check_prefill_engines(
                cfg, params, f"{arch} {'paged' if paged else 'striped'}"
                + (" (one scan chunk a chain)"
                   if rglru_scan.force_chunks else ""),
                paged, trace, sharing=paged and arch == "qwen2.5-3b")
            torch.cuda.empty_cache()
        if arch in PAD_TOL_ARCH:
            padding_gap(dataclasses.replace(cfg, n_layers=PAD_GAP_LAYERS),
                        dict(params,
                             layers=params["layers"][:PAD_GAP_LAYERS]),
                        seed)
        rglru_scan.force_chunks = None
        del params
        torch.cuda.empty_cache()
    for arch, layers, n_text in ((VLM_ARCH, VLM_PREFILL_LAYERS, 200),
                                 (ENCDEC_ARCH, None, 40)):
        cfg, params, _, _ = family_model(arch, torch.float32, seed,
                                         n_layers=layers)
        batches = [make_batch(cfg, 2, n_text + (cfg.n_patches or 0),
                              seed=seed + 151 + i, device="cuda")
                   for i in range(2)]
        check_static_prefill(cfg, params, batches, 8,
                             f"{arch}" + (f" depth {layers}" if layers
                                          else ""))
        del params, batches
        torch.cuda.empty_cache()


def burst_passes(seed: int) -> None:
    """15b: the bf16 burst of ``profile_ticks`` (8 requests x 24 new
    tokens, the prompt length of ``EAGER_BURST``) twice on a fresh paged
    engine of each of qwen2.5-3b, recurrentgemma-2b and xlstm-1.3b: the
    first pass captures (prefill bucket and decode), the second replays;
    wall time, device-busy time and idle share of each beside the eager
    prefills'."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import ContinuousBatchingEngine
    for arch, (wall0, busy0, prompt) in EAGER_BURST.items():
        cfg = get_config(arch)
        params = init_params(cfg, seed=seed, dtype=torch.bfloat16,
                             device="cuda")
        eng = ContinuousBatchingEngine(cfg, params, n_slots=8,
                                       max_len=2048, page_size=16)
        # each pass its own prompts: a repeated prompt would be a cached
        # prefix, and its prefill a suffix prefill
        passes = [profile_ticks(eng, cfg.vocab_size, seed + i, f"{arch} "
                                f"burst pass {i + 1}", prompt=prompt,
                                first_id=1000 * (i + 1))
                  for i in range(2)]
        log(f"[burst] {arch} paged bf16, 8 x ({prompt} prompt, 24 new): "
            + "; ".join(f"pass {i + 1} wall {w:.4f} s, busy {b:.4f} s, "
                        f"idle {100 * (1 - b / w):.1f}%"
                        for i, (w, b) in enumerate(passes))
            + f"; with eager prefills: wall {wall0:.4f} s"
            + (f", busy {busy0:.4f} s" if busy0 else "") + "; "
            + graph_note(eng))
        del eng, params
        torch.cuda.empty_cache()


def static_decode_tick(seed: int) -> None:
    """15c: ``InferenceEngine``'s decode tick at phase 3's 4 x 512
    (qwen2.5-3b bf16): the same step eager and replayed, host-clock ms
    a tick over 20 ticks ending in a synchronise."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import graph
    from repro_torch.models import init_params, make_batch
    from repro_torch.serving import InferenceEngine
    cfg = get_config("qwen2.5-3b")
    params = init_params(cfg, seed=seed, dtype=torch.bfloat16, device="cuda")
    batch = make_batch(cfg, 4, 512, seed=seed + 3, device="cuda")
    ms = {}
    for mode in ("eager", "replay"):
        eng = InferenceEngine(cfg, params)
        if mode == "eager":
            eng.decode_graphs = graph.StepGraphs("cuda", capturing=False)
        out = eng.generate(batch, 32)
        tok = out[:, -1].clone()
        key = next(iter(eng._shapes))
        eng._decode(key, tok)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            eng._decode(key, tok)
        torch.cuda.synchronize()
        ms[mode] = (time.perf_counter() - t0) / 20 * 1e3
        note = prefill_note(eng)
        del eng
    log(f"[static] qwen2.5-3b InferenceEngine decode tick, 4 x 512 bf16: "
        f"{ms['eager']:.3f} ms eager, {ms['replay']:.3f} ms replayed "
        f"({ms['eager'] / ms['replay']:.2f}x); {note}")
    del params
    torch.cuda.empty_cache()


def pipe_tick(seed: int) -> None:
    """15d: the λPipe tick at phase 9's shape (qwen2.5-3b bf16, 4 stages
    of 9 layers on cuda:0, 2 microbatches, 8 slots) at a 512-token
    bucket, the head at one row a slot: eager ``pipelined_forward``
    against its stage graphs' replays, host-clock ms a tick (each ends in
    a synchronise, as a tick ends in a host read), and logits equal."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import (PipelinedEngine, pipelined_forward,
                                         stage_params)
    from repro_torch.models import init_params
    cfg = get_config("qwen2.5-3b")
    params = init_params(cfg, seed=seed, dtype=torch.bfloat16, device="cuda")
    stages = stage_params(cfg, params, EWL_BLOCKS, ["cuda"] * EWL_BLOCKS)
    pipe = PipelinedEngine.from_stages(cfg, stages, n_microbatches=2,
                                       n_slots=8, max_len=1024, pad_to=64)
    rng = np.random.default_rng(seed + 152)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (8, 512))).cuda()
    last = torch.from_numpy(rng.integers(300, 512, 8)).cuda()
    ticks = {"eager": lambda: pipelined_forward(
                 cfg, stages, {"tokens": tokens}, 2, last=last),
             "replay": lambda: pipe.forward_fn(tokens, last)}
    ms, out = {}, {}
    for mode, fn in ticks.items():
        out[mode] = fn()                       # replay: warm-up + capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
            torch.cuda.synchronize()
        ms[mode] = (time.perf_counter() - t0) / 5 * 1e3
    again = pipe.forward_fn(tokens, last)
    if not torch.equal(again, out["eager"]):
        raise AssertionError("λPipe tick: replay differs from eager")
    n_graphs = len(pipe.graphs)
    pools = sum(s.pool_bytes for g in pipe.graphs.graphs.values()
                for s in g.steps.values())
    cap = sum(s.capture_s for g in pipe.graphs.graphs.values()
              for s in g.steps.values())
    log(f"[pipe] qwen2.5-3b λPipe tick, 4 stages x 9 layers, 2 "
        f"microbatches, 8 x 512 bf16: {ms['eager']:.2f} ms eager, "
        f"{ms['replay']:.2f} ms replayed ({ms['eager'] / ms['replay']:.2f}"
        f"x); "
        f"{n_graphs} graphs (4 stages + head) captured in {cap:.2f} s, "
        f"pool {pools / 2**20:.1f} MiB; logits bitwise equal to eager")
    del pipe, stages, params
    torch.cuda.empty_cache()


def compiled_prefill(seed: int) -> None:
    """Phase 15: the compiled prefills, the λPipe tick and
    ``InferenceEngine`` (15a-15d; 15e, the graphs, on every line)."""
    prefill_fp32(seed)
    burst_passes(seed)
    static_decode_tick(seed)
    pipe_tick(seed)
    log(f"[graphs] eager on the card by rule: {EAGER_BY_RULE}; every other "
        f"serving step replays a graph after its first use")


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
    for name in _build.sources():
        for line in _build.ptxas_output(name).splitlines():
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
        if dt == "float32":
            check_flash_fp64()
            check_fp32_fp64()
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
    t0 = time.perf_counter()
    serve_cluster_live(args.seed)
    serve_cluster_autoscale(args.seed)
    for model, _, _ in CLUSTER_MODELS:
        check_cluster_fp32(args.seed, model)
    log(f"[phase] 10 (live cluster: qwen2.5-3b + stablelm-1.6b) in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_compiled(args.seed)
    log(f"[phase] 11 (compiled step) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serve_moe(args.seed)
    serve_llama4(args.seed)
    serve_vlm(args.seed)
    serve_whisper(args.seed)
    check_families_fp32(args.seed)
    check_cluster_fp32(args.seed, "moe", n_requests=8)
    log(f"[phase] 12 (qwen2-moe, llama4, pixtral, whisper) in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_full_width(args.seed)
    grads_card_vs_cpu(args.seed)
    adamw_vs_torch(args.seed)
    checkpoint_and_moe(args.seed)
    serve_modes_and_examples(args.seed)
    log(f"[phase] 13 (training, --slo/--disagg/--overload, examples) in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dryrun_records()
    fit_check(args.seed)
    card_rates()
    log(f"[phase] 14 (dry-run on placeholder ranks, fit check, card rates) "
        f"in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    compiled_prefill(args.seed)
    log(f"[phase] 15 (compiled prefills, InferenceEngine, λPipe tick) in "
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
    # the kernel functions a call launches, per storage type, where a call
    # launches more than one ("launches" counts calls)
    mlstm = MMA_KERNELS["mlstm_chunkwise"]
    functions = {"mlstm_chunkwise": {
        "float32": [f for f, kind in mlstm.items() if kind != "bf16"],
        "bfloat16": [f for f, kind in mlstm.items() if kind == "bf16"]}}
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
        if name in functions:
            entry["functions"] = functions[name]
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
