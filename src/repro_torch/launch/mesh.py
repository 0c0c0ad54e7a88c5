"""Production meshes on placeholder ranks.

The counterpart of ``repro.launch.mesh``.  The JAX dry-run forces 512
host devices before JAX starts; here one process joins a fake process
group (``torch.testing._internal.distributed.fake_pg``) of the mesh's
size as rank 0 and builds a ``DeviceMesh`` of device type ``"cpu"`` over
it.  DTensors on that mesh dispatch their local ops on rank 0's shards,
and the group's collectives move nothing, so a 512-rank mesh costs one
process and no device.  The single-pod mesh is 16×16 = 256 ranks
(("data", "model")); multi-pod adds a leading "pod" axis: 2×16×16 = 512.

The group is process-global: ``placeholder_mesh`` replaces a fake group
of another size, and refuses to replace a real one.  ``mesh_context``
has no counterpart: a ``DeviceMesh`` is passed explicitly to whatever
needs it.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def placeholder_mesh(shape: Sequence[int], axes: Sequence[str]) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` on a fake process
    group of ``prod(shape)`` ranks, this process being rank 0.  One rank
    is allowed (a mesh of one card's program)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = math.prod(shape)
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is initialised; the "
                               "placeholder mesh needs a fake one")
        if dist.get_world_size() != n:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), world_size=n,
                                rank=0)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return placeholder_mesh(shape, axes)


def make_test_mesh(n_nodes: int = 8, axis: str = "node") -> DeviceMesh:
    """1-D mesh of ``n_nodes`` placeholder ranks."""
    return placeholder_mesh((n_nodes,), (axis,))


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
