"""Execute-while-load demo of the PyTorch port.

Runs the λPipe mechanics end to end:
  1. pack a model into blocks on node 0 (tensor packing, §5),
  2. multicast the blocks with the binomial-pipeline schedule (§4.2),
  3. form an execution pipeline of stages that jointly hold the full
     model and serve a batch with a GPipe-style pipelined forward (§4.3),
  4. after completion, unpack on the last node and mode-switch to local
     execution (§4.4) — logits must match bit for bit.

On one device (one card, or ``--device cpu``) every node's buffer and
every stage lives on that device, as ``chip_smoke.py`` phase 9 runs the
multicast, and ``distributed.multicast`` moves the rows.  With more than
one card each card is a node: one process a card runs its side of the
schedule with ``distributed.multicast_group`` over NCCL, and the
pipeline's stages are spread over the cards.  (The JAX original,
``examples/multicast_demo.py``, forces 8 host devices; nothing here
stands in for those.)

Run:  PYTHONPATH=src python examples/torch_multicast_demo.py [--device cpu]
"""
import argparse
import dataclasses
import os
import pickle
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.core import pack_model, plan_scale, unpack_model
from repro_torch.distributed import (multicast, pipelined_forward,
                                     stage_params)
from repro_torch.models import forward, init_params, make_batch

N_NODES, N_BLOCKS = 8, 8
# one card's side of the multicast: argv rank, world, port, directory;
# node 0 holds the source blocks (src.npy), the last node writes what it
# received (node.npy)
RANK = r"""
import datetime, pickle, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.distributed import multicast_group

rank, world, port, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
torch.cuda.set_device(rank)
dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank,
                        timeout=datetime.timedelta(seconds=120))
src = np.load(f"{d}/src.npy")
with open(f"{d}/schedule.pkl", "rb") as f:
    schedule = pickle.load(f)
buf = torch.from_numpy(src if rank == 0 else np.zeros_like(src)).cuda()
multicast_group(buf, schedule, rank)
if rank == world - 1:
    np.save(f"{d}/node.npy", buf.cpu().numpy())
dist.barrier()
dist.destroy_process_group()
print("RANK-OK", rank)
"""


def multicast_across_cards(stacked: torch.Tensor, schedule, cards: int
                           ) -> torch.Tensor:
    """Run ``schedule`` with one process a card; returns the last node's
    buffer on cuda:``cards - 1``."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    with tempfile.TemporaryDirectory() as d:
        np.save(os.path.join(d, "src.npy"), stacked.cpu().numpy())
        with open(os.path.join(d, "schedule.pkl"), "wb") as f:
            pickle.dump(schedule, f)
        env = dict(os.environ,
                   PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
        procs = [subprocess.Popen(
            [sys.executable, "-c", RANK, str(r), str(cards), port, d],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(cards)]
        try:
            outs = [p.communicate(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, (out, err)) in enumerate(zip(procs, outs)):
            if p.returncode != 0 or f"RANK-OK {r}" not in out:
                raise RuntimeError(f"multicast rank {r} failed:\n"
                                   f"{err[-3000:]}")
        node = np.load(os.path.join(d, "node.npy"))
    return torch.from_numpy(node).to(f"cuda:{cards - 1}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, required present)")
    ap.add_argument("--d-model", type=int, default=256)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 1

    cfg = dataclasses.replace(
        reduced(get_config("qwen2.5-3b"), d_model=args.d_model), n_layers=8)
    params = init_params(cfg, seed=0, device=device)
    batch = make_batch(cfg, 4, 32, device=device)
    ref = forward(cfg, params, batch)["logits"]

    # 1. tensor packing
    stacked, specs = pack_model(cfg, params, N_BLOCKS)
    print(f"packed {cfg.param_count()/1e6:.1f}M params into {N_BLOCKS} "
          f"blocks × {stacked.shape[1]/2**20:.2f} MiB")

    # 2. binomial-pipeline multicast, 1 → every node
    n_nodes = cards if cards > 1 else N_NODES
    plan = plan_scale(n_nodes, N_BLOCKS, k=1)
    print(f"1→{n_nodes} multicast: {plan.total_steps} steps "
          f"(= b + log2 N - 1 = "
          f"{N_BLOCKS + int(np.log2(n_nodes)) - 1})")
    if cards > 1:
        print(f"  one node a card: {cards} processes, multicast_group "
              f"over NCCL")
        received = multicast_across_cards(stacked, plan.schedule, cards)
    else:
        print(f"  every node's buffer on {device}")
        bufs = [stacked] + [torch.zeros_like(stacked)
                            for _ in range(n_nodes - 1)]
        received = multicast(bufs, plan.schedule)[-1]

    # 3. execute-while-load: pipeline-parallel forward over the stages
    n_stages = cards if cards > 1 else N_NODES
    devices = ([f"cuda:{i}" for i in range(cards)] if cards > 1
               else [device] * n_stages)
    stages = stage_params(cfg, params, n_stages, devices)
    pl_logits = pipelined_forward(cfg, stages, batch, n_microbatches=4)
    err = float((pl_logits.to(device) - ref).abs().max())
    print(f"pipelined (execute-while-load) forward over {n_stages} stages "
          f"vs dense: max|Δ| = {err:.2e}")

    # 4. mode switch: the last node unpacks its received blocks, serves
    params_n = unpack_model(cfg, received.to(device), specs)
    local = forward(cfg, params_n, batch)["logits"]
    diff = float((local - ref).abs().max())
    print(f"node {n_nodes - 1} local-mode logits vs source: max|Δ| = "
          f"{diff:.2e} (bit-exact)")
    assert diff == 0.0, "the multicast changed the weights"


if __name__ == "__main__":
    main()
