"""Per-device op cost of a traced function: the counterpart of
``repro.launch.hlo_cost.HloCost``.

JAX's walker parses the compiled per-device HLO.  The port has no HLO:
``OpCost`` is a ``TorchDispatchMode`` that sees every op the function
dispatches and keeps ``HloCost``'s four totals:

  * flops      — ``torch.utils.flop_counter``'s formulas (matmuls,
                 convolutions, attention) on the shapes each op sees;
  * bytes      — output bytes of every materialising op: views, factory
                 metadata and collectives' waits are free; an in-place
                 scatter into a buffer (``index_put_`` and its kin) is
                 charged a read and a write of its update, not the
                 buffer (``HloCost``'s in-place alias rule);
  * collective bytes/counts — by JAX's five types (all-gather,
                 all-reduce, reduce-scatter, all-to-all,
                 collective-permute), output bytes of each.

Per device, on DTensors: ``OpCost`` returns ``NotImplemented`` for an op
on DTensors, so DTensor first decomposes it into the local op on rank
0's shards and the functional collectives its redistribution issues,
and the mode counts those.  Two things of DTensor are kept out:
sharding propagation runs each op once on global-shape fake tensors to
learn the output's metadata (that run is not counted), and on a CPU mesh
DTensor stands in an all-gather plus a chunk for an all-to-all (the
redistribution is counted as the all-to-all it is on GPUs).

Python loops have no trip count to read: a caller that traces one trip
of a loop counts it ``n`` times inside ``repeat(n)`` (``trips(n)`` finds
the active counter), as ``HloCost`` multiplies a while body by its
``known_trip_count``.

Eager dispatch does not fuse: every elementwise op writes its output,
where XLA fuses chains of them into one.  So ``bytes`` exceeds the JAX
package's ``hlo_bytes`` for the same function.

The mode also tracks memory: ``peak_bytes`` is the largest total of
live storages that ops made while it was active (an op's result that
aliases an input, a view or an in-place update, makes none; tensors
that existed before it, such as the arguments, are not counted; a
storage is freed when its last tensor dies).  The counterpart of the
``temp`` part of XLA's ``memory_analysis``.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# functional-collective op names (``_c10d_functional``) by JAX type
_COLLECTIVE_OF = (("all_gather", "all-gather"),
                  ("reduce_scatter", "reduce-scatter"),
                  ("all_reduce", "all-reduce"),
                  ("all_to_all", "all-to-all"),
                  ("permute", "collective-permute"))

# in-place writes of an update into a buffer: charged 2× the update
_SCATTERS = {"index_put_": "values", "_index_put_impl_": "values",
             "scatter_": "src", "scatter_add_": "src", "index_add_": "source",
             "index_copy_": "source"}

_FREE_OPS = {"empty", "empty_strided", "empty_like", "detach", "alias",
             "lift_fresh"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _collective_type(func) -> str | None:
    ns = func.namespace
    if "c10d" not in ns and ns != "_dtensor":
        return None
    name = func._opname
    for key, kind in _COLLECTIVE_OF:
        if key in name:
            return kind
    return None


class OpCost(TorchDispatchMode):
    """Count what ops dispatch under ``with OpCost() as cost:``.  The
    totals read like ``HloCost``'s: ``flops``, ``bytes``,
    ``collective_bytes``, ``collective_counts``; ``peak_bytes`` is the
    peak of live storages made inside the block."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collective_bytes: Dict[str, float] = {c: 0.0
                                                   for c in COLLECTIVES}
        self.collective_counts: Dict[str, int] = {c: 0 for c in COLLECTIVES}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}
        self._paused = 0
        self._scale = 1
        self._patches = []

    # ------------------------------------------------------------- counting
    def add_collective(self, kind: str, nbytes: float) -> None:
        """Count one collective of ``kind`` moving ``nbytes`` (its
        output), for hand-offs the caller makes outside any op."""
        self.collective_bytes[kind] += float(nbytes) * self._scale
        self.collective_counts[kind] += round(self._scale)

    @contextlib.contextmanager
    def repeat(self, n: int):
        """Ops inside count ``n`` times: a loop traced for one trip, as
        ``HloCost`` multiplies a while body by its trip count."""
        self._scale *= n
        try:
            yield
        finally:
            self._scale //= n

    def _track(self, out) -> None:
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # let DTensor go local first
        out = func(*args, **kwargs)
        if self._paused:
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += self._scale * flop_registry[packet](
                *args, **kwargs, out_val=out)
        kind = _collective_type(func)
        if kind is not None:
            outs = [t for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor)]
            self.add_collective(kind, sum(_nbytes(t) for t in outs))
        elif not (func.is_view or func._opname in _FREE_OPS
                  or func.namespace == "prim"
                  or func._opname == "wait_tensor"):
            upd = _SCATTERS.get(func._opname)
            if upd is not None:
                names = [a.name for a in func._schema.arguments]
                val = kwargs.get(upd, args[names.index(upd)]
                                 if upd in names
                                 and names.index(upd) < len(args) else None)
                if isinstance(val, torch.Tensor):
                    self.bytes += self._scale * 2 * _nbytes(val)
            else:
                self.bytes += self._scale * sum(
                    _nbytes(t) for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor))
        # an alias (a view, an in-place result, a collective's wait)
        # allocates nothing
        if not (any(r.alias_info for r in func._schema.returns)
                or func._opname == "wait_tensor"):
            self._track(out)
        return out

    # --------------------------------------------------- DTensor internals
    def __enter__(self):
        self._patch()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            for obj, name, old in reversed(self._patches):
                setattr(obj, name, old)
            self._patches.clear()

    @contextlib.contextmanager
    def paused(self):
        """A context in which ops run uncounted and untracked."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def _patch(self) -> None:
        from torch.distributed.tensor import _collective_utils, placement_types
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        cost = self
        meta = ShardingPropagator._propagate_tensor_meta_non_cached

        def propagate_meta(prop, *a, **k):
            with cost.paused():
                return meta(prop, *a, **k)

        alltoall = _collective_utils.shard_dim_alltoall

        def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            with cost.paused():
                out = alltoall(input, gather_dim, shard_dim, mesh, mesh_dim)
            if not cost._paused:
                cost.add_collective("all-to-all", _nbytes(out))
                cost.bytes += cost._scale * _nbytes(out)
                cost._track(out)
            return out

        self._patches.append((ShardingPropagator,
                              "_propagate_tensor_meta_non_cached", meta))
        ShardingPropagator._propagate_tensor_meta_non_cached = propagate_meta
        for mod in (_collective_utils, placement_types):
            if getattr(mod, "shard_dim_alltoall", None) is alltoall:
                self._patches.append((mod, "shard_dim_alltoall", alltoall))
                mod.shard_dim_alltoall = shard_dim_alltoall


def trips(n: int):
    """``OpCost.repeat(n)`` of the innermost active ``OpCost`` (a null
    context when none is counting)."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, OpCost):
            return mode.repeat(n)
    return contextlib.nullcontext()
