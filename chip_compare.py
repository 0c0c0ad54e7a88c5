#!/usr/bin/env python3
"""Measurements on one GPU that ``chip_smoke.py`` does not make.

  python3 chip_compare.py merge-share [--tree DIR]
      the decode kernels' in-launch merge of their split partials: each
      decode entry point at its timed bf16 shape, built as it is and with
      the merge skipped, timed in turns; DIR is the checkout whose
      ``src/repro_torch`` is measured (default: this one).
  python3 chip_compare.py split-share [--tree DIR]
      the fp32 flash kernel's 3xTF32 split of its K and V fragments:
      ``flash_attention`` in fp32 at ``chip_smoke.py``'s fp32 serving
      shapes, built as it is and with those fragments fed to the mma
      unsplit (wrong results; a timing only), in turns.
  python3 chip_compare.py serving DIR [--phases 3,5,7]
      ``chip_smoke.py``'s bf16 serving phases (3 qwen2.5-3b, 5
      recurrentgemma-2b, 7 xlstm-1.3b), each checkout's own, run from DIR
      and from this checkout in fresh processes in the order DIR, this,
      this, DIR (phase 7 once each); prints every path's tok/s side by
      side and whether the two checkouts gave the same tokens.
  python3 chip_compare.py scan [--tree DIR] [--chunks 1,2,...]
      the RG-LRU scan at ``chip_smoke.py``'s timed shapes (``SCAN_TIMED``,
      inputs cycled past the L2), checkout DIR's and this one's in fresh
      processes in the order DIR, this, this, DIR (this, this without
      DIR); with --chunks, this checkout's scan also at each forced chunk
      count.
  python3 chip_compare.py prefill DIR [-n 16]
      xlstm-1.3b's bf16 prefill (phase 7's weights, n prompts of 1024
      tokens) in DIR and in this checkout, each held to an fp32 reference
      of the same weights: last-position logit error and argmax agreement
      of the kernel path and of the bf16 plain path.

  python3 chip_compare.py flash [--tree DIR]
      ``flash_attention`` in fp32 and bf16 at ``chip_smoke.py``'s fp32
      serving shapes (``FLASH_TIMED``: qwen2.5-3b, recurrentgemma-2b,
      stablelm-1.6b, whisper's encoder), by graph replay, checkout DIR's
      and this one's in fresh processes in the order DIR, this, this, DIR
      (this, this without DIR), with SDPA in fp32 and bf16 timed in each,
      and bf16 also on the transposed views ``layers.full_attention``
      passes.

  python3 chip_compare.py flash-ablate [--tree DIR]
      bf16 ``flash_attention`` at ``chip_smoke.py``'s bf16 timed shapes
      (``FLASH_BF16_TIMED``) as it is and under each ablation of its
      design (``FLASH_ABLATIONS``: no head pairs, no split pairs, 2-stage
      rings, no exponent), in turns in one process.

  python3 chip_compare.py fp32-kernels [--tree DIR]
      the fp32 kernels on the tensor cores as 3xTF32: fp32
      ``mlstm_chunkwise`` (B 1, H 4, dh 1024, S 1024 and 128) and the
      fp32 decode walks (the fused step at qwen2.5-3b's and
      recurrentgemma-2b's timed shapes, the read-only paged form, the
      recurrentgemma-2b ring), with the bf16 kernels at the same shapes
      beside them, by graph replay (``chip_smoke.py``'s timings), checkout
      DIR's and this one's in fresh processes in the order DIR, this,
      this, DIR (this, this without DIR).

  python3 chip_compare.py cluster DIR
      ``chip_smoke.py``'s live cluster of phase 10a (qwen2.5-3b and
      stablelm-1.6b at full width and depth, bf16, 24 requests), each
      checkout's own, run from DIR and from this checkout in fresh
      processes in the order DIR, this, this, DIR; prints each run's wall
      time and wall ms per cluster tick, and this checkout's prefill
      graphs.

All need a CUDA device and build the kernels from each checkout's
sources.  The helpers (inputs, timing) are this checkout's
``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Text patches that skip the decode kernels' merge: the last CTA of each
# (slot, KV head) resets its arrival counter and returns.  The first two
# are the in-launch merges (the shared walk's and a step that merges
# itself), the last two the separate combine kernels of trees that
# launched one after the walk; a tree has one form or the other.
SKIP_MERGE = [
    ("  if (!is_last) return false;\n",
     "  if (!is_last) return false;\n  if (threadIdx.x == 0) *counter = 0;\n"
     "  return false;\n"),
    ("  if (!is_last) return;\n",
     "  if (!is_last) return;\n  if (tid == 0) arrived[pair] = 0;\n"
     "  return;\n"),
    ("  decode_attention_combine<T><<<",
     "  if (0) decode_attention_combine<T><<<"),
    ("  paged_decode_attention_combine<T><<<",
     "  if (0) paged_decode_attention_combine<T><<<"),
]
DECODE_SOURCES = ("decode_attention", "paged_decode_step")


def skip_merge_sources(csrc: Path, dest: Path) -> None:
    """Copy ``csrc`` to ``dest`` with ``SKIP_MERGE`` applied; raises if a
    decode source, its headers included, is left as it was."""
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(csrc, dest)
    changed = set()
    for path in list(dest.glob("*.cu")) + list(dest.glob("*.cuh")):
        text = old = path.read_text()
        for a, b in SKIP_MERGE:
            text = text.replace(a, b)
        if text != old:
            path.write_text(text)
            changed.add(path.name)
    headers = {p.name for p in dest.glob("*.cuh")}
    for name in DECODE_SOURCES:
        if not changed & ({f"{name}.cu"} | headers):
            raise RuntimeError(f"SKIP_MERGE changed neither {name}.cu nor a "
                               f"header: the merge was not found")


# The patch that feeds the fp32 flash kernel's K and V fragments to the
# mma unsplit (the fp32 value as both big and small part): what the split
# of the fragments each warp reads costs.  It rewrites every split into a
# B fragment (b_big*, b_small*); Q's (a_*) and P's (p_*) splits stay.
SKIP_SPLIT = (re.compile(r"split_tf32\(([^;]+), (b_big\w*), (b_small\w*)\);"),
              r"\2 = \3 = __float_as_uint(\1);")


def skip_split_sources(csrc: Path, dest: Path) -> None:
    """Copy ``csrc`` to ``dest`` with ``SKIP_SPLIT`` applied to
    ``flash_attention.cu``; raises if it finds no split to skip."""
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(csrc, dest)
    path = dest / "flash_attention.cu"
    text, n = SKIP_SPLIT[0].subn(SKIP_SPLIT[1], path.read_text())
    if n == 0:
        raise RuntimeError("SKIP_SPLIT: no K or V split found in "
                           "flash_attention.cu")
    path.write_text(text)


def import_port(tree: Path):
    """Put this checkout's ``chip_smoke.py`` and ``tree``'s ``src`` first on
    the path; raises unless ``repro_torch`` then comes from ``tree``."""
    sys.path[:0] = [str(ROOT), str(tree / "src")]
    from repro_torch.kernels import _build
    if Path(_build.__file__).resolve().parents[3] != tree.resolve():
        raise RuntimeError(f"repro_torch imported from {_build.__file__}, "
                           f"not from {tree}")


def patched_times(cases, patch, name: str, iters: int, swap=None) -> dict:
    """Each case's device ms (``chip_smoke.graph_ms``) built from the
    sources as they are and from a copy that ``patch(csrc, dest)`` made
    under ``name`` in the build directory, in turns (as is, patched,
    patched, as is), ``swap(patched)`` called before each turn where
    given: {case: (as-is mean, patched mean, as-is runs, patched runs)}."""
    import chip_smoke as c
    from repro_torch.kernels import _build
    csrc = _build.CSRC
    dest = _build.BUILD_DIR / name
    patch(csrc, dest)
    runs = {k: ([], []) for k in cases}
    try:
        for patched in (False, True, True, False):
            _build.CSRC = dest if patched else csrc
            _build._libs.clear()
            _build.n_split.cache_clear()
            if swap:
                swap(patched)
            for k, fn in cases.items():
                runs[k][patched].append(c.graph_ms(fn, iters=iters))
    finally:
        _build.CSRC = csrc
        _build._libs.clear()
        _build.n_split.cache_clear()
        if swap:
            swap(False)
    return {k: (sum(a) / 2, sum(b) / 2, a, b) for k, (a, b) in runs.items()}


# Ablations of the bf16 flash kernel's design that ``flash-ablate`` times
# against the kernel as it is: text patches (old, new) of
# csrc/flash_attention.cu, and a function of the wrapper's module replaced
# (name, stand-in).  "no-exp" computes no exponent (wrong results, a
# timing only: the softmax's exponent cost).
FLASH_ABLATIONS = {
    "head-pairs-off": ((), ("use_head_pairs", lambda bucket, g: False)),
    "split-off": ((), ("split_plan", lambda *args: (0, 1))),
    "two-stages": ((("launch_wgmma<64, key_tile(64), 3>",
                     "launch_wgmma<64, key_tile(64), 2>"),
                    ("launch_wgmma<128, key_tile(128), 3>",
                     "launch_wgmma<128, key_tile(128), 2>")), None),
    "no-exp": ((('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
                 "y = fmaf(x, 0.f, 1.f);"),), None),
}


def ablated_sources(patches, csrc: Path, dest: Path) -> None:
    """Copy ``csrc`` to ``dest`` with each (old, new) of ``patches``
    applied to flash_attention.cu; raises where a patch finds nothing."""
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(csrc, dest)
    path = dest / "flash_attention.cu"
    text = path.read_text()
    for old, new in patches:
        if old not in text:
            raise RuntimeError(f"flash ablation: {old!r} was not found in "
                               f"{path.name}")
        text = text.replace(old, new)
    path.write_text(text)


def flash_ablate(tree: Path) -> None:
    """bf16 flash at ``chip_smoke.FLASH_BF16_TIMED`` as it is and under
    each of ``FLASH_ABLATIONS``, in turns."""
    import_port(tree)
    import torch
    import chip_smoke as c
    fa = sys.modules["repro_torch.kernels.flash_attention"]
    cases = {}
    for key, (H, KVH, S, dh, causal, window) in c.FLASH_BF16_TIMED.items():
        gen = torch.Generator(device="cuda").manual_seed(5)
        q, k, v = (torch.randn((1, h, S, dh), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for h in (H, KVH, KVH))
        cases[key] = (lambda q=q, k=k, v=v, causal=causal, window=window:
                      fa.flash_attention(q, k, v, causal=causal,
                                         window=window))
    for name, (patches, attr) in FLASH_ABLATIONS.items():
        kept = getattr(fa, attr[0]) if attr else None

        def swap(patched, attr=attr, kept=kept):
            if attr:
                setattr(fa, attr[0], attr[1] if patched else kept)
        times = patched_times(
            cases, lambda csrc, dest, patches=patches: ablated_sources(
                patches, csrc, dest),
            f"csrc_{name}", 20, swap)
        for k, (ms, abl, a, b) in times.items():
            print(f"[ablate] bf16 flash {k} {c.FLASH_BF16_TIMED[k]} {name}: "
                  f"{ms:.5f} ms as is, {abl:.5f} ms ablated ({abl / ms:.3f}x;"
                  f" runs {[round(x, 5) for x in a]} / "
                  f"{[round(x, 5) for x in b]})", flush=True)
    print(c.smi(), flush=True)


def split_share(tree: Path) -> None:
    """fp32 flash at each ``FLASH_TIMED`` shape built as it is and with the
    K/V splits skipped; the splits' share is the difference of the
    means."""
    import_port(tree)
    import torch
    import chip_smoke as c
    from repro_torch.kernels import flash_attention
    cases = {}
    for key, (H, KVH, S, dh, causal, window) in c.FLASH_TIMED.items():
        gen = torch.Generator(device="cuda").manual_seed(5)
        q, k, v = (torch.randn((1, h, S, dh), generator=gen, device="cuda")
                   for h in (H, KVH, KVH))
        cases[key] = (lambda q=q, k=k, v=v, causal=causal, window=window:
                      flash_attention(q, k, v, causal=causal, window=window))
    times = patched_times(cases, skip_split_sources, "csrc_skip_split", 10)
    for k, (ms, bare, a, b) in times.items():
        print(f"[split] flash fp32 {k} {c.FLASH_TIMED[k]}: {ms:.5f} ms, K/V "
              f"splits skipped {bare:.5f} ms, splits {ms - bare:.5f} ms = "
              f"{100 * (ms - bare) / ms:.1f}% (runs {a} / {b})", flush=True)
    print(c.smi(), flush=True)


def merge_share(tree: Path) -> dict:
    """Each decode entry point built as it is and with the merge skipped;
    the merge's time is the difference of the means.  Beside it the eager
    per-call time of the as-is build (``chip_smoke.time_ms``), the host's
    enqueue rate for kernels this short."""
    import_port(tree)
    import torch
    import chip_smoke as c
    from repro_torch.kernels import (decode_attention,
                                     paged_decode_attention,
                                     paged_decode_step)
    gen = torch.Generator(device="cuda").manual_seed(17)
    W = 2048
    ring = c._ring_inputs(gen, 8, 10, 1, W, 256,
                          [W + 37 * b for b in range(8)], torch.bfloat16)
    rings = [(ring[1].clone(), ring[2].clone()) for _ in range(8)]

    def paged(H, KVH, dh, MP, lens_range, seed):
        lens = torch.randint(*lens_range, (8,),
                             generator=torch.Generator().manual_seed(seed))
        g = torch.Generator(device="cuda").manual_seed(seed + 1)
        x = c._step_inputs(g, 8, H, KVH, dh, 16, MP, lens, torch.bfloat16)
        return x, [(x["k"].clone(), x["v"].clone()) for _ in range(8)]
    it = {"i": 0}

    def nxt(pools):
        it["i"] += 1
        return pools[it["i"] % len(pools)]
    step_q, pools_q = paged(16, 2, 128, 128, (64, 1152), 3)
    step_r, pools_r = paged(10, 1, 256, 192, (64, 3000), 19)
    ro, pools_ro = paged(16, 2, 128, 128, (64, 1152), 3)
    cases = {
        "decode_attention recurrentgemma ring": lambda: decode_attention(
            ring[0], *nxt(rings), ring[3], ring[4], window=W),
        "paged_decode_step qwen": lambda: paged_decode_step(
            step_q["q"], step_q["kn"], step_q["vn"], *nxt(pools_q),
            step_q["table"], step_q["lens"]),
        "paged_decode_step recurrentgemma": lambda: paged_decode_step(
            step_r["q"], step_r["kn"], step_r["vn"], *nxt(pools_r),
            step_r["table"], step_r["lens"], window=2048),
        "paged_decode_attention qwen": lambda: paged_decode_attention(
            ro["q"], *nxt(pools_ro), ro["table"], ro["lens"])}
    times = patched_times(cases, skip_merge_sources, "csrc_skip_merge", 100)
    enqueue = {k: c.time_ms(fn, iters=200) for k, fn in cases.items()}
    out = {}
    for k, (ms, bare, a, b) in times.items():
        out[k] = {"ms": ms, "no_merge_ms": bare, "merge_ms": ms - bare,
                  "share": (ms - bare) / ms, "enqueue_ms": enqueue[k]}
        print(f"[merge] {k}: {ms:.5f} ms, merge skipped {bare:.5f} ms, "
              f"merge {ms - bare:.5f} ms = {100 * (ms - bare) / ms:.1f}%; "
              f"eager {enqueue[k]:.5f} ms a call (runs {a} / {b})",
              flush=True)
    print(c.smi(), flush=True)
    return out


# Runs one checkout's serving phases in a fresh process, from that
# checkout's root: its own chip_smoke.py and src/repro_torch; every
# path's generated tokens are written to the JSON file named by argv[1].
SERVE = r"""
import json, sys
out_path, phases = sys.argv[1], sys.argv[2:]
sys.argv = ["chip_smoke.py"]
sys.path[:0] = [".", "src"]
import torch
import chip_smoke as c
from repro_torch.kernels import _build
_build.build_all()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
tokens = {}
drive = c.drive
def keep(path, fn):
    out, wall, counts = drive(path, fn)
    tokens[path] = ({str(k): list(map(int, v)) for k, v in out.items()}
                    if isinstance(out, dict) else out.tolist())
    return out, wall, counts
c.drive = keep
run = {"3": c.serve_full_width, "5": c.serve_hybrid, "7": c.serve_ssm}
for p in phases:
    run[p](0)
json.dump({"tokens": tokens, "launches": c.PATH_LAUNCHES},
          open(out_path, "w"))
"""
# One checkout's xlstm-1.3b bf16 prefill (chip_smoke's phase 7 weights and
# static batch) against an fp32 reference: the same weights cast to fp32
# through the plain mLSTM chunk loop.  Last-position logits of the kernel
# path and of the bf16 plain path, each against the reference; written as
# JSON to argv[1].
PREFILL = r"""
import json, sys
out_path, n = sys.argv[1], int(sys.argv[2])
sys.path[:0] = [".", "src"]
import torch
import chip_smoke as c
from repro_torch.kernels import _build
from repro_torch.models import forward, init_params, make_batch
_build.build_all(["mlstm_chunkwise"])
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
def cast(t):
    if isinstance(t, dict):
        return {k: cast(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(cast(v) for v in t)
    return t.float() if torch.is_tensor(t) and t.is_floating_point() else t
cfg = c.ssm_config()
params = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
batch = make_batch(cfg, n, 1024, seed=31, device="cuda")
def last(p, impl):
    with torch.no_grad():
        return forward(cfg, p, batch, kernel_impl=impl,
                       last_only=True)["logits"][:, -1].float()
got = {"kernel": last(params, "kernel"), "plain": last(params, "plain")}
ref = last(cast(params), "plain")
top2 = torch.topk(ref, 2)
res = {"margin": (top2.values[:, 0] - top2.values[:, 1]).tolist(),
       "ref_argmax": top2.indices[:, 0].tolist(),
       "ref_std": ref.std().item()}
for k, x in got.items():
    d = x - ref
    res[k] = {"max_abs": d.abs().max().item(),
              "rel_l2": (d.norm() / ref.norm()).item(),
              "argmax": x.argmax(-1).tolist()}
json.dump(res, open(out_path, "w"))
"""
# One checkout's scan times (chip_smoke.scan_times of THIS checkout, the
# scan wrapper of the checkout in the working directory), as JSON to
# argv[1]; argv[2] is this checkout's root, argv[3] the forced counts.
SCAN = r"""
import json, sys
from pathlib import Path
out_path, root, counts = sys.argv[1], sys.argv[2], sys.argv[3]
sys.path[:0] = [root, "src"]
import chip_smoke as c
from repro_torch.kernels import _build, rglru_scan
if Path(_build.__file__).resolve().parents[3] != Path.cwd().resolve():
    raise RuntimeError(f"repro_torch imported from {_build.__file__}")
_build.build_all(["rglru_scan"])
res = c.scan_times(rglru_scan, [int(x) for x in counts.split(",") if x])
json.dump(res, open(out_path, "w"))
"""
# One checkout's flash times at FLASH_TIMED (chip_smoke._time_flash of
# THIS checkout, the flash wrapper of the checkout in the working
# directory): {shape: {"float32", "bfloat16", "bfloat16_strided",
# "sdpa_fp32", "sdpa_bf16": ms}}, as JSON
# to argv[1]; argv[2] is this checkout's root.
FLASH = r"""
import json, sys
from pathlib import Path
out_path, root = sys.argv[1], sys.argv[2]
sys.path[:0] = [root, "src"]
import torch
import chip_smoke as c
from repro_torch.kernels import _build
if Path(_build.__file__).resolve().parents[3] != Path.cwd().resolve():
    raise RuntimeError(f"repro_torch imported from {_build.__file__}")
_build.build_all(["flash_attention"])
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
res = {}
for key, (H, KVH, S, dh, causal, window) in c.FLASH_TIMED.items():
    t = {dt: c._time_flash(H, KVH, S, dh, dt, causal=causal, window=window,
                           iters=c.FLASH_ITERS.get(key, 50))
         for dt in ("float32", "bfloat16")}
    res[key] = {"float32": t["float32"]["ms"], "bfloat16": t["bfloat16"]["ms"],
                "bfloat16_strided": t["bfloat16"]["strided_ms"],
                "sdpa_fp32": t["float32"]["library_ms"],
                "sdpa_bf16": t["bfloat16"]["library_ms"]}
json.dump(res, open(out_path, "w"))
"""
# One checkout's fp32 and bf16 mLSTM and decode-walk times (chip_smoke's
# timings of THIS checkout, the wrappers of the checkout in the working
# directory): {row: ms} for every row of FP32_ROWS, as JSON to argv[1];
# argv[2] is this checkout's root.
FP32K = r"""
import json, sys
from pathlib import Path
out_path, root = sys.argv[1], sys.argv[2]
sys.path[:0] = [root, "src"]
import torch
import chip_smoke as c
from repro_torch.kernels import _build
if Path(_build.__file__).resolve().parents[3] != Path.cwd().resolve():
    raise RuntimeError(f"repro_torch imported from {_build.__file__}")
_build.build_all(["mlstm_chunkwise", "paged_decode_step", "decode_attention"])
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
W = 2048
ring = [W + 37 * b for b in range(8)]
res = {}
for dt in ("float32", "bfloat16"):
    kind = "fp32" if dt == "float32" else "bf16"
    for S in (1024, 128):
        res[f"mlstm {kind} S={S}"] = c._time_mlstm(S, dt)["ms"]
    res[f"step {kind} qwen"] = c._time_paged_step(
        16, 2, 128, 128, None, (64, 1152), seed=3, dtype_name=dt)["ms"]
    res[f"step {kind} recurrentgemma"] = c._time_paged_step(
        10, 1, 256, 192, 2048, (64, 3000), seed=19, dtype_name=dt)["ms"]
    res[f"paged {kind} qwen"] = c._time_paged_attention(dt)["ms"]
    res[f"ring {kind} recurrentgemma"] = c._time_decode(
        10, 1, 256, ring, W, 17, dtype_name=dt)["ms"]
json.dump(res, open(out_path, "w"))
"""
# the rows FP32K times, in the order they are printed
FP32_ROWS = [f"{k} {kind} {shape}" for kind in ("fp32", "bf16")
             for k, shape in (("mlstm", "S=1024"), ("mlstm", "S=128"),
                              ("step", "qwen"), ("step", "recurrentgemma"),
                              ("paged", "qwen"), ("ring", "recurrentgemma"))]
TOKS = re.compile(r"^\[serve\] ([^:]+):.*?= ([0-9.]+) tok/s")
LOGDIR = ROOT / "chiprun_out" / "compare"


def fresh(script: str, tree: Path, label: str, *argv):
    """Run ``script`` in a fresh Python process from ``tree``'s root, with
    argv[1] the path of a JSON file for its result and ``argv`` after it;
    its output goes to ``LOGDIR/<label>.log``.  Returns (its standard
    output, its JSON result or None); raises if it failed."""
    LOGDIR.mkdir(parents=True, exist_ok=True)
    out_path = LOGDIR / f"{label}.json"
    out_path.unlink(missing_ok=True)
    proc = subprocess.run([sys.executable, "-c", script, str(out_path),
                           *map(str, argv)], cwd=tree, capture_output=True,
                          text=True)
    (LOGDIR / f"{label}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"{label} failed (rc {proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    return proc.stdout, (json.loads(out_path.read_text())
                         if out_path.exists() else None)


def in_turns(other, once) -> dict:
    """``once(tree, label)`` for checkout ``other`` and this one in the
    order other, this, this, other (this, this where ``other`` is None),
    so that the spread of one checkout's two runs stands beside the
    difference: {"other": [result, result], "this": [...]}."""
    order = [("this", ROOT), ("this", ROOT)]
    if other is not None:
        order = [("other", other)] + order + [("other", other)]
    runs = {}
    for label, tree in order:
        rs = runs.setdefault(label, [])
        rs.append(once(tree, f"{label}_{len(rs) + 1}"))
    return runs


def print_means(head: str, runs: dict, pick, unit: str = "ms") -> dict:
    """One line: each checkout's ``pick(result)`` of every run and their
    mean; returns {label: mean}."""
    line, means = f"{head}:", {}
    for label, rs in runs.items():
        xs = [pick(r) for r in rs]
        means[label] = sum(xs) / len(xs)
        line += (f" {label} {[round(x, 5) for x in xs]} mean "
                 f"{means[label]:.5f} {unit};")
    print(line, flush=True)
    return means


def serve_once(tree: Path, phases, label: str) -> dict:
    """One fresh process of ``tree``'s serving phases: {"tok_s": {path:
    tok/s}, "tokens": ..., "launches": ...}."""
    stdout, res = fresh(SERVE, tree, label, *phases)
    res["tok_s"] = {m.group(1): float(m.group(2))
                    for m in map(TOKS.match, stdout.splitlines()) if m}
    print(f"[serving] {label}: " + "; ".join(
        f"{k} {v}" for k, v in res["tok_s"].items()), flush=True)
    return res


def serving(other: Path, phases) -> None:
    again = [p for p in phases if p != "7"]
    a1 = serve_once(other, phases, "other_1")
    b1 = serve_once(ROOT, phases, "this_1")
    b2 = serve_once(ROOT, again, "this_2") if again else b1
    a2 = serve_once(other, again, "other_2") if again else a1
    for path in a1["tok_s"]:
        ta = [r["tok_s"][path] for r in (a1, a2) if path in r["tok_s"]]
        tb = [r["tok_s"][path] for r in (b1, b2) if path in r["tok_s"]]
        print(f"[serving] {path}: {other.name} {ta} mean "
              f"{sum(ta) / len(ta):.2f}; this {tb} mean "
              f"{sum(tb) / len(tb):.2f} tok/s", flush=True)
    for path, ta in a1["tokens"].items():
        tb = b1["tokens"][path]
        if isinstance(ta, dict):
            same = sum(ta[k] == tb[k] for k in ta)
            equal = [sum(x == y for x, y in zip(ta[k], tb[k]))
                     for k in ta]
            what = (f"{same} of {len(ta)} requests equal; equal tokens "
                    f"per request {equal}")
        else:
            same = sum(x == y for x, y in zip(ta, tb))
            what = f"{same} of {len(ta)} rows equal"
        counts = b1["launches"][path]
        same = "equal" if a1["launches"][path] == counts else "DIFFER"
        print(f"[tokens] {path}: {what}; launches {same} {counts}",
              flush=True)
    if "7" in phases:
        print("[serving] phase 7 ran once per checkout", flush=True)


def scan_once(tree: Path, counts: str, label: str) -> dict:
    _, res = fresh(SCAN, tree, f"scan_{label}", ROOT, counts)
    print(f"[scan] {label}: " + "; ".join(
        f"{k} {v['ms']:.5f} ms (eager {v['enqueue_ms']:.5f}; "
        f"{v['chunks']} chunks)" for k, v in res.items()), flush=True)
    for k, v in res.items():
        if v["forced"]:
            print(f"[scan] {label} {k} forced: " + ", ".join(
                f"{n} chunks {ms:.5f}" for n, ms in v["forced"].items()),
                flush=True)
    return res


def scan(other, counts: str) -> None:
    """Each checkout's scan by graph replay, in turns in fresh processes;
    the forced chunk counts in this checkout's first run."""
    import chip_smoke as c
    runs = in_turns(other, lambda tree, label: scan_once(
        tree, counts if label == "this_1" else "", label))
    for key, (B, S, d, dt) in c.SCAN_TIMED.items():
        print_means(f"[scan] B={B} S={S} d={d} {dt}", runs,
                    lambda r: r[key]["ms"])
    print(c.smi(), flush=True)


def flash_once(tree: Path, label: str) -> dict:
    _, res = fresh(FLASH, tree, f"flash_{label}", ROOT)
    print(f"[flash] {label}: " + "; ".join(
        f"{k} fp32 {v['float32']:.5f} bf16 {v['bfloat16']:.5f} (strided "
        f"views {v['bfloat16_strided']:.5f}) SDPA fp32 {v['sdpa_fp32']:.5f} "
        f"bf16 {v['sdpa_bf16']:.5f} ms" for k, v in res.items()),
        flush=True)
    return res


def flash(other) -> None:
    """Each checkout's flash by graph replay, in turns in fresh
    processes."""
    import chip_smoke as c
    runs = in_turns(other, flash_once)
    for key, shape in c.FLASH_TIMED.items():
        for what in ("float32", "bfloat16", "bfloat16_strided", "sdpa_fp32",
                     "sdpa_bf16"):
            print_means(f"[flash] {key} {shape} {what}", runs,
                        lambda r: r[key][what])
    print(c.smi(), flush=True)


def fp32_kernels_once(tree: Path, label: str) -> dict:
    _, res = fresh(FP32K, tree, f"fp32k_{label}", ROOT)
    print(f"[fp32-kernels] {label}: " + "; ".join(
        f"{k} {v:.5f}" for k, v in res.items()) + " ms", flush=True)
    return res


def fp32_kernels(other) -> None:
    """Each checkout's fp32 (and bf16) mLSTM and decode walks by graph
    replay, in turns in fresh processes; per row the runs and means, and
    this checkout's mean over the other's."""
    import chip_smoke as c
    runs = in_turns(other, fp32_kernels_once)
    for row in FP32_ROWS:
        mean = print_means(f"[fp32-kernels] {row}", runs, lambda r: r[row])
        if "other" in mean:
            print(f"[fp32-kernels] {row}: this / other = "
                  f"{mean['this'] / mean['other']:.3f}", flush=True)
    print(c.smi(), flush=True)


def prefill(other: Path, n: int) -> None:
    res = {}
    for label, tree in (("other", other), ("this", ROOT)):
        r = res[label] = fresh(PREFILL, tree, f"prefill_{label}", n)[1]
        for k in ("kernel", "plain"):
            agree = sum(a == b for a, b in zip(r[k]["argmax"],
                                               r["ref_argmax"]))
            print(f"[prefill] {label} bf16 {k}: max |logit - fp32| "
                  f"{r[k]['max_abs']:.4g}, relative L2 {r[k]['rel_l2']:.4g},"
                  f" argmax equal to fp32's in {agree} of {n}", flush=True)
        print(f"[prefill] {label} fp32 reference: logit std "
              f"{r['ref_std']:.4g}; top-2 margins "
              f"{[round(m, 4) for m in r['margin']]}", flush=True)
    same = sum(a == b for a, b in zip(res["other"]["kernel"]["argmax"],
                                      res["this"]["kernel"]["argmax"]))
    print(f"[prefill] kernel argmax equal between the checkouts in {same} "
          f"of {n}", flush=True)


# One checkout's live cluster: its own chip_smoke.py's phase 10a, run
# from the checkout (the working directory); the log goes to stdout.
CLUSTER = r"""
import sys
sys.path[:0] = [".", "src"]
import chip_smoke as c
from repro_torch.kernels import _build
_build.build_all(["paged_decode_step", "flash_attention"])
c.serve_cluster_live(0)
"""
TICK = re.compile(r"^\[cluster\] 10a live: \d+ requests, \d+ tokens in "
                  r"([0-9.]+) s wall;.*; ([0-9.]+) ms wall per tick")


def cluster_once(tree: Path, label: str):
    """One fresh process of ``tree``'s phase 10a: (wall s, ms a tick)."""
    stdout, _ = fresh(CLUSTER, tree, f"cluster_{label}")
    m = next(filter(None, map(TICK.match, stdout.splitlines())))
    wall, tick = float(m.group(1)), float(m.group(2))
    print(f"[cluster] {label}: {wall} s wall, {tick} ms a tick", flush=True)
    for line in stdout.splitlines():
        if "prefill graphs captured" in line:
            print(f"[cluster] {label}: {line}", flush=True)
    return wall, tick


def cluster(other: Path) -> None:
    import chip_smoke as c
    runs = in_turns(other, cluster_once)
    print_means(f"[cluster] wall ({other.name} as other)", runs,
                lambda r: r[0], "s")
    print_means("[cluster] a tick", runs, lambda r: r[1])
    print(c.smi(), flush=True)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    m = sub.add_parser("merge-share")
    m.add_argument("--tree", type=Path, default=ROOT)
    sp = sub.add_parser("split-share")
    sp.add_argument("--tree", type=Path, default=ROOT)
    s = sub.add_parser("serving")
    s.add_argument("other", type=Path)
    s.add_argument("--phases", default="3,5,7")
    c = sub.add_parser("scan")
    c.add_argument("--tree", type=Path, default=None)
    c.add_argument("--chunks", default="")
    fl = sub.add_parser("flash")
    fl.add_argument("--tree", type=Path, default=None)
    fa = sub.add_parser("flash-ablate")
    fa.add_argument("--tree", type=Path, default=ROOT)
    fk = sub.add_parser("fp32-kernels")
    fk.add_argument("--tree", type=Path, default=None)
    k = sub.add_parser("cluster")
    k.add_argument("other", type=Path)
    f = sub.add_parser("prefill")
    f.add_argument("other", type=Path)
    f.add_argument("-n", type=int, default=16)
    return ap


def main() -> int:
    args = parser().parse_args()
    if not (ROOT / "chip_smoke.py").is_file():
        print("chip_compare.py: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_compare.py: no CUDA device", file=sys.stderr)
        return 1
    if args.cmd == "merge-share":
        merge_share(args.tree)
    elif args.cmd == "split-share":
        split_share(args.tree)
    elif args.cmd == "scan":
        sys.path.insert(0, str(ROOT))
        scan(args.tree and args.tree.resolve(), args.chunks)
    elif args.cmd == "serving":
        serving(args.other.resolve(), args.phases.split(","))
    elif args.cmd == "flash":
        sys.path.insert(0, str(ROOT))
        flash(args.tree and args.tree.resolve())
    elif args.cmd == "flash-ablate":
        flash_ablate(args.tree.resolve())
    elif args.cmd == "fp32-kernels":
        sys.path.insert(0, str(ROOT))
        fp32_kernels(args.tree and args.tree.resolve())
    elif args.cmd == "cluster":
        sys.path.insert(0, str(ROOT))
        cluster(args.other.resolve())
    else:
        prefill(args.other.resolve(), args.n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
