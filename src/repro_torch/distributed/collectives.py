"""Execution of λPipe multicast schedules on GPUs.

The paper moves model blocks between GPU nodes with one-sided RDMA/GDR.
Here a schedule runs on one of two paths, and the caller picks which:

- ``multicast`` moves rows between per-node buffers that one process
  holds (one buffer per device, or several on one device);
- ``multicast_group`` runs one rank's side under an initialised
  ``torch.distributed`` process group (gloo on the CPU, NCCL on GPUs):
  each schedule step is one ``batch_isend_irecv`` of the step's pairs.

Both keep the semantics of the JAX package's staged ``ppermute`` and of
``multicast_reference``: within a step every sent row is read before any
row is written.  Because the schedule is static, every node knows which
block it sends and which it stores at each step; no block ids travel on
the wire.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.multicast import Schedule


def multicast(bufs: List[torch.Tensor], schedule: Schedule
              ) -> List[torch.Tensor]:
    """Run ``schedule`` over N per-node (n_blocks, P) uint8 buffers in one
    process, in place, and return them.  Each buffer lives on its node's
    device; source rows hold real data, destination rows are scratch.
    Each step stages every sent row, then writes it with ``copy_``."""
    assert len(bufs) == schedule.n_nodes, (len(bufs), schedule.n_nodes)
    for step in schedule.steps:
        staged = [(dst, blk, bufs[src][blk].clone())
                  for src, dst, blk in step]
        for dst, blk, row in staged:
            bufs[dst][blk].copy_(row)
    return bufs


def multicast_group(buf: torch.Tensor, schedule: Schedule, rank: int,
                    group: Optional[dist.ProcessGroup] = None
                    ) -> torch.Tensor:
    """Run this rank's side of ``schedule`` on its (n_blocks, P) buffer, in
    place, under an initialised process group (node i is group rank i;
    under NCCL the caller has set its CUDA device).  Each step posts the
    step's sends and receives of this rank as one ``batch_isend_irecv``
    and waits for them; received rows land in ``buf`` after the step's
    sends were staged."""
    peer = (lambda r: r) if group is None \
        else (lambda r: dist.get_global_rank(group, r))
    # a step's batch involves only its pairs, but the group's first NCCL
    # call must involve every rank: one barrier sets the group up
    dist.barrier(group=group)
    for step in schedule.steps:
        ops, recvs = [], []
        for src, dst, blk in step:
            if src == rank:
                ops.append(dist.P2POp(dist.isend, buf[blk].clone(),
                                      peer(dst), group))
            if dst == rank:
                row = torch.empty_like(buf[blk])
                ops.append(dist.P2POp(dist.irecv, row, peer(src), group))
                recvs.append((blk, row))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for blk, row in recvs:
            buf[blk].copy_(row)
    return buf


def multicast_reference(blocks: np.ndarray, schedule: Schedule) -> np.ndarray:
    """Pure-numpy oracle with identical semantics (for tests)."""
    out = np.array(blocks)
    for step in schedule.steps:
        staged = [(dst, blk, out[src, blk].copy()) for src, dst, blk in step]
        for dst, blk, data in staged:
            out[dst, blk] = data
    return out
