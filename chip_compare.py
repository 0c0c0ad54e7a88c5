#!/usr/bin/env python3
"""Measurements on one GPU that ``chip_smoke.py`` does not make.

  python3 chip_compare.py merge-share [--tree DIR]
      the decode kernels' in-launch merge of their split partials: each
      decode entry point at its timed bf16 shape, built as it is and with
      the merge skipped, timed in turns; DIR is the checkout whose
      ``src/repro_torch`` is measured (default: this one).
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


def merge_share(tree: Path) -> dict:
    """Each entry point's device time (``chip_smoke.graph_ms``) built as it
    is and with the merge skipped, in turns (as is, skipped, skipped, as
    is); the merge's time is the difference of the means.  Beside it the
    eager per-call time of the as-is build (``chip_smoke.time_ms``), the
    host's enqueue rate for kernels this short."""
    sys.path[:0] = [str(ROOT), str(tree / "src")]
    import torch
    import chip_smoke as c
    from repro_torch.kernels import (_build, decode_attention,
                                     paged_decode_attention,
                                     paged_decode_step)
    if Path(_build.__file__).resolve().parents[3] != tree.resolve():
        raise RuntimeError(f"repro_torch imported from {_build.__file__}, "
                           f"not from {tree}")
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
    csrc = _build.CSRC
    skip = _build.BUILD_DIR / "csrc_skip_merge"
    skip_merge_sources(csrc, skip)
    times = {k: {"ms": [], "no_merge_ms": []} for k in cases}
    try:
        for variant in ("ms", "no_merge_ms", "no_merge_ms", "ms"):
            _build.CSRC = csrc if variant == "ms" else skip
            _build._libs.clear()
            _build.n_split.cache_clear()
            for k, fn in cases.items():
                times[k][variant].append(c.graph_ms(fn, iters=100))
        enqueue = {k: c.time_ms(fn, iters=200) for k, fn in cases.items()}
    finally:
        _build.CSRC = csrc
        _build._libs.clear()
        _build.n_split.cache_clear()
    out = {}
    for k, t in times.items():
        ms = sum(t["ms"]) / 2
        bare = sum(t["no_merge_ms"]) / 2
        out[k] = {"ms": ms, "no_merge_ms": bare, "merge_ms": ms - bare,
                  "share": (ms - bare) / ms, "enqueue_ms": enqueue[k]}
        print(f"[merge] {k}: {ms:.5f} ms, merge skipped {bare:.5f} ms, "
              f"merge {ms - bare:.5f} ms = {100 * (ms - bare) / ms:.1f}%; "
              f"eager {enqueue[k]:.5f} ms a call (runs {t['ms']} / "
              f"{t['no_merge_ms']})", flush=True)
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
TOKS = re.compile(r"^\[serve\] ([^:]+):.*?= ([0-9.]+) tok/s")


def serve_once(tree: Path, phases, label: str, logdir: Path) -> dict:
    """One fresh process of ``tree``'s serving phases: {"tok_s": {path:
    tok/s}, "tokens": ..., "launches": ...}; its output goes to
    ``logdir/<label>.log`` and its tokens to ``logdir/<label>.json``."""
    out_path = logdir / f"{label}.json"
    proc = subprocess.run([sys.executable, "-c", SERVE, str(out_path),
                           *phases], cwd=tree, capture_output=True, text=True)
    (logdir / f"{label}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"{label}: serving phases {phases} failed (rc "
                           f"{proc.returncode}):\n{proc.stderr[-4000:]}")
    res = json.loads(out_path.read_text())
    res["tok_s"] = {m.group(1): float(m.group(2))
                    for m in map(TOKS.match, proc.stdout.splitlines()) if m}
    print(f"[serving] {label}: " + "; ".join(
        f"{k} {v}" for k, v in res["tok_s"].items()), flush=True)
    return res


def serving(other: Path, phases) -> None:
    logdir = ROOT / "chiprun_out" / "compare"
    logdir.mkdir(parents=True, exist_ok=True)
    again = [p for p in phases if p != "7"]
    a1 = serve_once(other, phases, "other_1", logdir)
    b1 = serve_once(ROOT, phases, "this_1", logdir)
    b2 = serve_once(ROOT, again, "this_2", logdir) if again else b1
    a2 = serve_once(other, again, "other_2", logdir) if again else a1
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


def scan_once(tree: Path, counts: str, label: str, logdir: Path) -> dict:
    out_path = logdir / f"scan_{label}.json"
    proc = subprocess.run([sys.executable, "-c", SCAN, str(out_path),
                           str(ROOT), counts], cwd=tree, capture_output=True,
                          text=True)
    (logdir / f"scan_{label}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"{label}: scan timing failed (rc "
                           f"{proc.returncode}):\n{proc.stderr[-4000:]}")
    res = json.loads(out_path.read_text())
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
    """Each checkout's scan by graph replay, in turns in fresh processes:
    the spread of one checkout's two runs beside the difference."""
    import chip_smoke as c
    logdir = ROOT / "chiprun_out" / "compare"
    logdir.mkdir(parents=True, exist_ok=True)
    runs = {"this": []}
    if other is not None:
        runs["other"] = [scan_once(other, "", "other_1", logdir)]
    runs["this"].append(scan_once(ROOT, counts, "this_1", logdir))
    runs["this"].append(scan_once(ROOT, "", "this_2", logdir))
    if other is not None:
        runs["other"].append(scan_once(other, "", "other_2", logdir))
    for key, (B, S, d, dt) in c.SCAN_TIMED.items():
        line = f"[scan] B={B} S={S} d={d} {dt}:"
        for label, rs in runs.items():
            ms = [r[key]["ms"] for r in rs]
            line += (f" {label} {[round(x, 5) for x in ms]} mean "
                     f"{sum(ms) / len(ms):.5f} ms;")
        print(line, flush=True)
    print(c.smi(), flush=True)


def prefill(other: Path, n: int) -> None:
    logdir = ROOT / "chiprun_out" / "compare"
    logdir.mkdir(parents=True, exist_ok=True)
    res = {}
    for label, tree in (("other", other), ("this", ROOT)):
        out_path = logdir / f"prefill_{label}.json"
        proc = subprocess.run([sys.executable, "-c", PREFILL, str(out_path),
                               str(n)], cwd=tree, capture_output=True,
                              text=True)
        (logdir / f"prefill_{label}.log").write_text(proc.stdout
                                                     + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"{label}: prefill failed (rc "
                               f"{proc.returncode}):\n{proc.stderr[-4000:]}")
        r = res[label] = json.loads(out_path.read_text())
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


def cluster_once(tree: Path, label: str, logdir: Path):
    """One fresh process of ``tree``'s phase 10a: (wall s, ms a tick)."""
    proc = subprocess.run([sys.executable, "-c", CLUSTER], cwd=tree,
                          capture_output=True, text=True)
    (logdir / f"cluster_{label}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"{label}: phase 10a failed (rc "
                           f"{proc.returncode}):\n{proc.stderr[-4000:]}")
    m = next(filter(None, map(TICK.match, proc.stdout.splitlines())))
    wall, tick = float(m.group(1)), float(m.group(2))
    print(f"[cluster] {label}: {wall} s wall, {tick} ms a tick", flush=True)
    for line in proc.stdout.splitlines():
        if "prefill graphs captured" in line:
            print(f"[cluster] {label}: {line}", flush=True)
    return wall, tick


def cluster(other: Path) -> None:
    import chip_smoke as c
    logdir = ROOT / "chiprun_out" / "compare"
    logdir.mkdir(parents=True, exist_ok=True)
    runs = {"other": [], "this": []}
    for label, tree in (("other", other), ("this", ROOT), ("this", ROOT),
                        ("other", other)):
        runs[label].append(cluster_once(tree, f"{label}_"
                                        f"{len(runs[label]) + 1}", logdir))
    for label, rs in runs.items():
        print(f"[cluster] {label} ({other.name if label == 'other' else 'this'}"
              f"): wall {[w for w, _ in rs]} s, ms a tick "
              f"{[t for _, t in rs]}, mean {sum(t for _, t in rs) / 2:.1f}",
              flush=True)
    print(c.smi(), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    m = sub.add_parser("merge-share")
    m.add_argument("--tree", type=Path, default=ROOT)
    s = sub.add_parser("serving")
    s.add_argument("other", type=Path)
    s.add_argument("--phases", default="3,5,7")
    c = sub.add_parser("scan")
    c.add_argument("--tree", type=Path, default=None)
    c.add_argument("--chunks", default="")
    k = sub.add_parser("cluster")
    k.add_argument("other", type=Path)
    f = sub.add_parser("prefill")
    f.add_argument("other", type=Path)
    f.add_argument("-n", type=int, default=16)
    args = ap.parse_args()
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
    elif args.cmd == "scan":
        sys.path.insert(0, str(ROOT))
        scan(args.tree and args.tree.resolve(), args.chunks)
    elif args.cmd == "serving":
        serving(args.other.resolve(), args.phases.split(","))
    elif args.cmd == "cluster":
        sys.path.insert(0, str(ROOT))
        cluster(args.other.resolve())
    else:
        prefill(args.other.resolve(), args.n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
