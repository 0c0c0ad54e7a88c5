"""Dry-run of λPipe's execute-while-load EXECUTION path on the production
mesh, on placeholder ranks: the port's GPipe-style pipeline
(``distributed.pipeline.pipelined_forward``) with the trunk cut into 16
stages over the "data" axis (one stage per receiving node group), each
stage's weights tensor-parallel on "model" — the paper's Case 2 (§4.3:
cross-node pipelines for multi-GPU models).  The counterpart of
``repro.launch.dryrun_ewl``:

  PYTHONPATH=src python -m repro_torch.launch.dryrun_ewl [--arch llama2-7b]
                                                        [--batch 64 --seq 1024]

The port's schedule runs in one process: stage s is rank 0's group on
"model" (``mesh["model"]``) holding stage s's weights as DTensors, and
``OpCost`` counts every stage's work.  The record is per device: the
schedule's totals over the 16 stages (the stages are equal; the
embedding and the head are shared out with them).  A stage computes its
M microbatches, where the JAX package's SPMD body computes on every one
of the M + N − 1 ticks, replicated over "model" (its ``shard_map`` names
"data" only).  Each stage but the last hands M activations to the next:
those are the record's ``collective-permute`` bytes.
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch.configs import get_config
from repro_torch.launch.dryrun import roofline, trace
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import batch_specs, spmd_patches


def spec_of(key: str, leaf, model_n: int):
    """The JAX ``spec_of`` rule on the port's flat stage leaves: a trunk
    layer leaf of two or more dims (a stacked JAX leaf of three or more)
    splits its last dim over "model" where it divides; everything else
    is replicated.  Returns JAX-style spec entries."""
    spec = [None] * leaf.ndim
    if key.startswith("@layer") and leaf.ndim >= 2 \
            and leaf.shape[-1] % model_n == 0:
        spec[-1] = "model"
    return tuple(spec)


def build_ewl(cfg, mesh, *, batch: int, seq: int, microbatches: int,
              axis: str = "data", dtype=torch.bfloat16):
    """(fn, args, handoff_bytes): ``fn(stages, batch)`` runs the port's
    ``pipelined_forward`` over ``mesh.size(axis)`` stages whose weights
    are DTensors on ``mesh["model"]`` placed by ``spec_of``;
    ``handoff_bytes`` is what every stage but the last sends."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed.pipeline import (pipelined_forward,
                                                  stage_params)
    from repro_torch.distributed.sharding import placements, to_dtensors
    from repro_torch.models import init_params

    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    assert cfg.pattern_len == 1 and cfg.n_layers % n_stages == 0, \
        f"EWL dry-run needs a uniform trunk divisible into {n_stages} " \
        "stages"
    sub = mesh["model"]
    fake = FakeTensorMode()
    with fake:
        params = init_params(cfg, 0, dtype, device="cpu")
        stages = stage_params(cfg, params, n_stages, ["cpu"] * n_stages)
        del params
        for st in stages:
            place = {k: placements(spec_of(k, v, sub.size()), sub)
                     for k, v in st.flat.items()}
            st.flat = to_dtensors(sub, st.flat, place)
        b = batch_specs(cfg, batch, seq, dtype, fake)

    def ewl_forward(stages, b):
        return pipelined_forward(cfg, stages, b, microbatches,
                                 kernel_impl="plain")

    mb = batch // microbatches
    handoff = microbatches * mb * seq * cfg.d_model * \
        torch.empty((), dtype=dtype).element_size()
    return spmd_patches(sub, ewl_forward), (stages, b), handoff


def run_ewl(arch: str = "llama2-7b", *, batch: int = 64, seq: int = 1024,
            microbatches: int = 4, mesh=None, cfg=None,
            verbose: bool = True) -> dict:
    cfg = cfg or get_config(arch)
    mesh = mesh or make_production_mesh()      # ("data","model") = 16×16
    fn, args, handoff = build_ewl(cfg, mesh, batch=batch, seq=seq,
                                  microbatches=microbatches)
    out, cost, t_trace = trace(fn, args)
    del out
    n = len(args[0])
    for _ in range(microbatches * (n - 1)):
        cost.add_collective("collective-permute", handoff / microbatches)
    # the schedule's totals shared out over its n stage devices
    cost.flops /= n
    cost.bytes /= n
    for k in cost.collective_bytes:
        cost.collective_bytes[k] /= n
        cost.collective_counts[k] = round(cost.collective_counts[k] / n)
    rec = {"arch": arch, "shape": f"ewl_b{batch}_s{seq}",
           "mesh": "pod16x16+ewl-pipeline", "status": "ok",
           "n_chips": mesh.size(), "lower_s": round(t_trace, 2),
           "compile_s": 0.0,
           "memory": {"argument_size_in_bytes": 0, "output_size_in_bytes": 0,
                      "temp_size_in_bytes": int(cost.peak_bytes)},
           "model_flops": 2.0 * cfg.active_param_count() * batch * seq}
    roofline(rec, cost)
    if verbose:
        print(f"[ok] EWL pipeline {arch} b{batch} s{seq}: "
              f"trace {t_trace:.1f}s | compute {rec['t_compute']*1e3:.1f}ms "
              f"memory {rec['t_memory']*1e3:.1f}ms "
              f"collective {rec['t_collective']*1e3:.1f}ms | "
              f"temp {cost.peak_bytes/2**30:.2f} GiB")
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b",
                    help="uniform-trunk arch with n_layers %% 16 == 0")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args()
    rec = run_ewl(args.arch, batch=args.batch, seq=args.seq,
                  microbatches=args.microbatches)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(
            args.out, f"{args.arch}_ewl_pipeline.json"), "w") as f:
        json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
