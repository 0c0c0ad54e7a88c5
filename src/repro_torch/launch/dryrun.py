"""Multi-pod dry-run on placeholder ranks: trace every (architecture ×
input shape) on the production meshes and derive roofline terms from
what the trace dispatches.

The counterpart of ``repro.launch.dryrun``, for H100s.  The mesh is a
fake process group in one process (``launch.mesh``); the arguments are
DTensors of fake tensors (``launch.specs``); ``launch.op_cost.OpCost``
counts rank 0's ops as the step runs.  No device is used:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \
      --shape train_4k [--multi-pod] [--out results/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Per combination this prints/records JAX's keys:
  * memory per device — argument and output bytes (rank 0's shards),
    temp bytes (the peak of live intermediates while the step ran; a
    prefill's includes the plain attention's S×S scores, as XLA's
    attention materialises them, so it bounds the card's flash prefill
    from above)
  * hlo_flops / hlo_bytes — the counter's per-device FLOPs and bytes
    (the names are JAX's, so one reader takes both packages' files)
  * collective bytes and counts by type
  * the three roofline terms (compute / memory / collective, seconds)
  * lower_s is the trace's time; compile_s is 0 (nothing is compiled)
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_cost import OpCost
from repro_torch.launch.specs import applicable, build_dryrun, fake_mode_of

# ------------------------------ hardware constants (one H100 SXM5 80 GB) ---
# NVIDIA's H100 data sheet, SXM part, 700 W, dense rates without sparsity
PEAK_FLOPS = 989e12        # bf16 tensor-core FLOP/s a card
HBM_BW = 3.35e12           # HBM3 bytes/s a card
# One link's rate: a 16-wide "model" axis spans two 8-GPU nodes, so its
# collectives cross the inter-node network, whose per-GPU link (one
# 400 Gb/s NDR InfiniBand port a GPU, as in a DGX H100) is the slowest on
# the ring: 50 GB/s each way.  NVLink inside a node (450 GB/s each way)
# is 9x faster, so this bounds every collective from above.
LINK_BW = 50e9             # bytes/s a GPU, inter-node

# the JAX package's tuned presets, with the same knobs
PRESETS = {
    "tuned-moe": {"prefill_moe_cf": 2.0, "moe_ep": True,
                  "pad_heads": True},
    "tuned-decode": {"cache_shard": "seq", "fsdp": False},
    "tuned-train": {"tp_pairs": True},
}


def _local_bytes(tree) -> int:
    """Bytes of rank 0's shards of every tensor in ``tree``."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves

    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t._local_tensor
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def trace(fn, args):
    """Run ``fn(*args)`` (from ``specs.build_dryrun``) under its fake mode
    and an ``OpCost``; returns (outputs, cost, seconds)."""
    t0 = time.time()
    with fake_mode_of(args), OpCost() as cost:
        out = fn(*args)
    return out, cost, time.time() - t0


def roofline(rec: dict, cost: OpCost) -> dict:
    """``rec`` updated with the counter's totals, the three terms and the
    bottleneck, as the JAX dry-run computes them."""
    coll = {k: float(v) for k, v in cost.collective_bytes.items()}
    rec.update(
        hlo_flops=float(cost.flops), hlo_bytes=float(cost.bytes),
        xla_cost_flops=float(cost.flops),
        collective_bytes=coll,
        collective_counts=dict(cost.collective_counts),
        t_compute=cost.flops / PEAK_FLOPS,
        t_memory=cost.bytes / HBM_BW,
        t_collective=sum(coll.values()) / LINK_BW)
    terms = {"compute": rec["t_compute"], "memory": rec["t_memory"],
             "collective": rec["t_collective"]}
    rec["bottleneck"] = max(terms, key=terms.get)
    return rec


def _write(rec: dict, out_dir: str | None) -> None:
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    fname = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}.json".replace(
        "/", "-")
    rec_out = dict(rec)
    rec_out.pop("traceback", None)
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(rec_out, f, indent=1)


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            fsdp: bool = True, out_dir: str | None = None,
            verbose: bool = True, opts: dict | None = None,
            tag: str = "", mesh=None, cfg=None, shape=None,
            dtype=torch.bfloat16) -> dict:
    """One record.  ``mesh``, ``cfg`` and ``shape`` override the
    production mesh, ``get_config(arch)`` and ``SHAPES[shape_name]``
    (a reduced run or a fit check; the record keeps the names given);
    ``dtype`` is the weights' and activations' (JAX's bf16 default)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    mesh_tag = ("pod2x16x16" if multi_pod else "pod16x16") + tag
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
           "status": "ok"}
    ok, why = applicable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        if verbose:
            print(f"[skip] {arch} × {shape_name}: {why}")
        _write(rec, out_dir)
        return rec
    try:
        mesh = mesh or make_production_mesh(multi_pod=multi_pod)
        n_chips = mesh.size()
        fn, args = build_dryrun(cfg, shape, mesh, dtype=dtype,
                                fsdp=(opts or {}).get("fsdp", fsdp),
                                opts=opts)
        out, cost, t_lower = trace(fn, args)
        n_act = float(cfg.active_param_count())
        if shape.kind == "train":
            model_flops = 6.0 * n_act * shape.global_batch * shape.seq_len
        elif shape.kind == "prefill":
            model_flops = 2.0 * n_act * shape.global_batch * shape.seq_len
        else:
            model_flops = 2.0 * n_act * shape.global_batch
        rec.update(
            n_chips=n_chips, lower_s=round(t_lower, 2), compile_s=0.0,
            memory={"argument_size_in_bytes": _local_bytes(args),
                    "output_size_in_bytes": _local_bytes(out),
                    "temp_size_in_bytes": int(cost.peak_bytes),
                    "generated_code_size_in_bytes": 0})
        del out, args
        roofline(rec, cost)
        rec["model_flops"] = model_flops
        flops = rec["hlo_flops"]
        rec["useful_flops_ratio"] = (model_flops / n_chips / flops
                                     if flops else 0.0)
        if verbose:
            coll_total = sum(rec["collective_bytes"].values())
            print(f"[ok] {arch} × {shape_name} × {mesh_tag}: "
                  f"trace {t_lower:.1f}s | "
                  f"flops/dev {flops:.3e} bytes/dev {rec['hlo_bytes']:.3e} "
                  f"coll {coll_total:.3e} | "
                  f"compute {rec['t_compute']*1e3:.2f}ms "
                  f"memory {rec['t_memory']*1e3:.2f}ms "
                  f"collective {rec['t_collective']*1e3:.2f}ms "
                  f"-> {rec['bottleneck']}")
            m = rec["memory"]
            print(f"     memory: args {m['argument_size_in_bytes']/2**30:.2f}"
                  f" GiB out {m['output_size_in_bytes']/2**30:.2f}"
                  f" GiB temp {m['temp_size_in_bytes']/2**30:.2f} GiB")
    except Exception as e:                                  # noqa: BLE001
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[ERR] {arch} × {shape_name} × {mesh_tag}: {e}")
    _write(rec, out_dir)
    return rec


def table(out_dir: str) -> str:
    """The records under ``out_dir`` as a markdown table, a row an (arch,
    shape) and a column a mesh: per device GiB (arguments + temp),
    FLOPs, collective bytes and the bottleneck, or the status."""
    recs, meshes = {}, []
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".json"):
            with open(os.path.join(out_dir, name)) as f:
                r = json.load(f)
            recs[(r["arch"], r["shape"], r["mesh"])] = r
            if r["mesh"] not in meshes:
                meshes.append(r["mesh"])

    def cell(r):
        if r is None:
            return ""
        if r["status"] != "ok":
            return f"{r['status']}: {r.get('reason') or r.get('error')}"
        m = r["memory"]
        gib = (m["argument_size_in_bytes"] + m["temp_size_in_bytes"]) / 2**30
        return (f"{gib:.2f} GiB, {r['hlo_flops']:.3g} FLOP, "
                f"{sum(r['collective_bytes'].values()):.3g} B, "
                f"{r['bottleneck']}")

    rows = ["| arch | shape | " + " | ".join(meshes) + " |",
            "|---|---|" + "---|" * len(meshes)]
    for arch, shape in sorted({k[:2] for k in recs}):
        rows.append(f"| {arch} | {shape} | " + " | ".join(
            cell(recs.get((arch, shape, m))) for m in meshes) + " |")
    return "\n".join(rows)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="architecture id (see repro_torch.configs)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="run every (arch × shape) combination")
    ap.add_argument("--multi-pod", action="store_true",
                    help="2×16×16 (512 ranks) instead of 16×16")
    ap.add_argument("--no-fsdp", action="store_true",
                    help="replicate params over data axis (baseline DP)")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--preset", default=None, choices=list(PRESETS),
                    help="tuned sharding/capacity presets")
    ap.add_argument("--table", action="store_true",
                    help="print the records under --out as a table, run "
                         "nothing")
    args = ap.parse_args()
    if args.table:
        print(table(args.out))
        return

    combos = []
    if args.all:
        for a in list_archs():
            for s in SHAPES:
                combos.append((a, s))
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        combos = [(args.arch, args.shape)]

    opts = PRESETS[args.preset] if args.preset else None
    tag = f"+{args.preset}" if args.preset else ""
    results = []
    for a, s in combos:
        results.append(run_one(a, s, multi_pod=args.multi_pod,
                               fsdp=not args.no_fsdp, out_dir=args.out,
                               opts=opts, tag=tag))
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\n== dry-run summary: {n_ok} ok, {n_skip} skipped "
          f"(documented), {n_err} errors ==")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
