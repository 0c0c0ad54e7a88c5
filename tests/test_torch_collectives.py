"""The port's multicast paths against the numpy oracle.

``multicast`` (one process, per-node buffers) runs the JAX package's
multicast cases (``tests/test_multidevice.py``: 1→8 binomial, 2→8 and
3→8 k-way) and a sweep of schedules; ``multicast_group`` runs 1→4
binomial and 2→4 k-way schedules on four gloo ranks, each a process of
its own started here with a bounded wait, so a hang fails this test and
never stalls the suite.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.ewl import plan_scale
from repro_torch.core.multicast import binomial_schedule, kway_schedule
from repro_torch.distributed import multicast, multicast_reference

SRC = Path(__file__).resolve().parents[1] / "src"


def _run(n, b, k, P=384, seed=0):
    """Sources 0..k-1 hold the blocks, the rest zeros; returns the source
    blocks and the node buffers after ``multicast`` and the oracle."""
    src = np.random.default_rng(seed).integers(0, 255, (b, P),
                                               dtype=np.uint8)
    blocks = np.zeros((n, b, P), np.uint8)
    blocks[:k] = src
    sched = binomial_schedule(n, b) if k == 1 else kway_schedule(n, b, k)
    sched.validate({s: range(b) for s in range(k)})
    bufs = multicast([torch.from_numpy(blocks[i].copy()) for i in range(n)],
                     sched)
    return src, bufs, multicast_reference(blocks, sched)


@pytest.mark.parametrize("n,b,k", [(8, 6, 1), (8, 6, 2), (8, 6, 3),
                                   (4, 4, 1), (4, 4, 2), (5, 7, 1),
                                   (12, 9, 3), (16, 5, 4)])
def test_multicast_equals_reference(n, b, k):
    src, bufs, ref = _run(n, b, k)
    for node, buf in enumerate(bufs):
        np.testing.assert_array_equal(buf.numpy(), ref[node])
        np.testing.assert_array_equal(buf.numpy(), src)


def test_multicast_plan_schedule_moves_model_blocks():
    """The execute-while-load plan's schedule (``plan_scale``) delivers
    every block row to every node bit for bit, sources untouched."""
    plan = plan_scale(8, 6, k=2)
    stacked = torch.randint(0, 256, (6, 1024), dtype=torch.uint8,
                            generator=torch.Generator().manual_seed(1))
    bufs = [stacked.clone(), stacked.clone()] + \
        [torch.zeros_like(stacked) for _ in range(6)]
    multicast(bufs, plan.schedule)
    assert all(torch.equal(b, stacked) for b in bufs)


RANK = r"""
import datetime, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.core.multicast import binomial_schedule, kway_schedule
from repro_torch.distributed import multicast_group, multicast_reference

rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=4, rank=rank,
                        timeout=datetime.timedelta(seconds=60))
for k, sched in ((1, binomial_schedule(4, 5)), (2, kway_schedule(4, 5, 2))):
    src = np.random.default_rng(k).integers(0, 255, (5, 384), dtype=np.uint8)
    blocks = np.zeros((4, 5, 384), np.uint8)
    blocks[:k] = src
    want = multicast_reference(blocks, sched)[rank]
    buf = torch.from_numpy(blocks[rank].copy())
    out = multicast_group(buf, sched, rank)
    assert out is buf and (buf.numpy() == want).all(), (k, rank)
    assert (want == src).all()
dist.barrier()
dist.destroy_process_group()
print("RANK-OK", rank)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_multicast_group_on_four_gloo_ranks():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r), port],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK-OK {r}" in out, err[-3000:]
