"""Shape-only inputs for every (architecture × input shape) combination,
placed on a mesh.

The counterpart of ``repro.launch.specs``.  ``build_dryrun(cfg, shape,
mesh)`` returns ``(fn, args)``: the args are DTensors on ``mesh`` whose
local shards are fake tensors (``FakeTensorMode``: shapes and dtypes, no
storage), placed by ``repro_torch.distributed.sharding``'s rules, and
``fn(*args)`` runs the port's own step on them, on rank 0's shards:

  train_4k     → training.make_train_step's step(params, opt_state, batch)
                 (loss + grad + AdamW in place: the plain path, as
                 training runs on the card)
  prefill_32k  → forward(params, batch, build_cache=True) -> logits + K/V
  decode_32k   → decode_step(params, cache, tokens, positions) (ONE token)
  long_500k    → decode_step with windowed/recurrent caches only
                 (sub-quadratic gate: see supports_long)

Run ``fn`` under ``fake_mode_of(args)`` (and ``launch.op_cost.OpCost`` to
count it).  Every path is the plain one (``kernel_impl="plain"``: the
CUDA kernels take no fake tensors), and MoE layers run the static form,
which reads nothing back to the host.

DTensor carries most of the model as it is (``implicit_replication`` for
the constants the model makes inside).  The functions it cannot
propagate run on local shards while ``fn`` runs (``spmd_patches``), as
``local_map`` runs a function: their inputs are redistributed to chosen
placements, the function runs on rank 0's shards, and its outputs are
wrapped back.  They are the attention core (a head dim split over
"model" meets a GQA reshape), the loss (a gather over a split
vocabulary), the MoE layer's routing, dispatch and combine (sorts and
scatters over tokens; its expert products stay on DTensors), the RG-LRU
and mLSTM scans and the sLSTM loop, and xLSTM's ``logsigmoid``.  The
three loops (a step a token, or a chunk) are traced for one trip whose
ops count once a trip (``_loop``; a 32k-token prefill would otherwise
dispatch ~10^6 ops a layer), the backward as one trip's backward.  Each takes explicit placements: batch over the data
axes, heads, channels or the vocabulary over "model" where they divide,
and a reduction that crosses shards becomes an explicit collective.  A
dispatch mode (``_SpmdMode``) handles the rest: the decode ring write
(an in-place scatter into a batch-sharded cache), ops without a rule at
their placements, and reshapes that would leave a strided shard.  The
model code and its numbers do not change.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map_only

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.distributed.sharding import (axis_sizes, batch_shardings,
                                              cache_shardings,
                                              param_shardings, placements,
                                              to_dtensors)


def supports_long(cfg: ModelConfig) -> bool:
    """True iff 524k-token decode keeps bounded state: recurrent mixers
    and/or windowed attention (incl. the llama4 global-layer fallback)."""
    if cfg.family == "encdec":
        return False
    for ent in cfg.layer_pattern:
        mixer = ent.split(":")[0]
        if mixer in ("attn", "attn_full") and cfg.window is None:
            return False
    return True


def applicable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    if shape.name == "long_500k" and not supports_long(cfg):
        return False, "full-attention arch: 524k decode is quadratic (skip)"
    return True, ""


def batch_specs(cfg: ModelConfig, batch: int, seq_len: int,
                dtype=torch.bfloat16, fake_mode=None):
    """Fake tensors of a batch's shapes and dtypes, of ``fake_mode`` (by
    default the active one, else a new one)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from torch._guards import detect_fake_mode

    with fake_mode or detect_fake_mode() or FakeTensorMode():
        s_text = seq_len - (cfg.n_patches or 0)
        b = {"tokens": torch.empty((batch, s_text), dtype=torch.int32)}
        if cfg.n_patches:
            b["patches"] = torch.empty((batch, cfg.n_patches, cfg.d_model),
                                       dtype=dtype)
        if cfg.family == "encdec":
            b["frames"] = torch.empty((batch, cfg.enc_seq, cfg.d_model),
                                      dtype=dtype)
    return b


def fake_mode_of(args):
    """The ``FakeTensorMode`` of the first DTensor (or fake tensor) in
    ``args``."""
    from torch.utils._pytree import tree_leaves

    for t in tree_leaves(args):
        if isinstance(t, DTensor):
            t = t._local_tensor
        if hasattr(t, "fake_mode"):
            return t.fake_mode
    raise ValueError("no fake tensor among the arguments")


def build_dryrun(cfg: ModelConfig, shape: InputShape, mesh, *,
                 dtype=torch.bfloat16, fsdp: bool = True,
                 opts: dict | None = None):
    """Returns (fn, args); see the module docstring.

    opts — the JAX package's tuning knobs, each with its counterpart:
      prefill_moe_cf: float|None   capacity factor for prefill MoE dispatch
                                   (None = drop-free; baseline)
      cache_shard:    "dh"|"seq"   decode-cache model-axis placement
      decode_argmax:  bool         serve_step returns sampled token ids
                                   instead of full (B, vocab) logits
      moe_ep:         bool         expert-parallel MoE bank sharding
      tp_pairs:       bool         Megatron row-parallel w_out/w_down
      pure_fsdp:      bool         ZeRO-3 over every mesh axis, no TP
      grad_constraint: bool        redistribute each gradient to its
                                   parameter's placements before AdamW
      pad_heads:      bool         pad n_heads / n_kv_heads up to the next
                                   multiple of the model-axis size
    """
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import decode_step, forward, init_cache, \
        init_params

    opts = opts or {}
    sizes = axis_sizes(mesh)
    if opts.get("pad_heads"):
        m = sizes["model"]

        def _up(x):
            return ((x + m - 1) // m) * m
        cfg = dataclasses.replace(
            cfg, n_heads=_up(cfg.n_heads),
            n_kv_heads=cfg.n_kv_heads if cfg.n_kv_heads == cfg.n_heads
            else _up(cfg.n_kv_heads))
    fake = FakeTensorMode()
    with fake:
        params_g = init_params(cfg, 0, dtype, device="cpu")
    pure = opts.get("pure_fsdp", False)
    p_place = param_shardings(
        cfg, mesh, params_g, fsdp=fsdp,
        moe_expert_parallel=opts.get("moe_ep", False),
        tp_pairs=opts.get("tp_pairs", False), pure_fsdp=pure)
    with fake:
        params = to_dtensors(mesh, params_g, p_place)
    del params_g
    spmd = functools.partial(spmd_patches, mesh)

    if shape.kind == "train":
        from repro_torch.training.optimizer import AdamWConfig, \
            init_opt_state
        from repro_torch.training.train_loop import make_train_step

        with fake:
            opt_state = init_opt_state(params)
            batch_g = batch_specs(cfg, shape.global_batch, shape.seq_len,
                                  dtype, fake)
            if pure:
                axes = tuple(sizes)
                b_place = {k: placements((axes,), mesh) for k in batch_g}
            else:
                b_place = batch_shardings(mesh, batch_g)
            batch = to_dtensors(mesh, batch_g, b_place)
        constraint = None
        if opts.get("grad_constraint"):
            def constraint(grads):
                return _redistribute(mesh, grads, p_place)
        step = make_train_step(cfg, AdamWConfig(), grad_constraint=constraint)
        return spmd(step), (params, opt_state, batch)

    if shape.kind == "prefill":
        with fake:
            batch_g = batch_specs(cfg, shape.global_batch, shape.seq_len,
                                  dtype, fake)
            batch = to_dtensors(mesh, batch_g,
                                batch_shardings(mesh, batch_g))
        moe_cf = opts.get("prefill_moe_cf", None)

        def prefill(params, b):
            return forward(cfg, params, b, build_cache=True,
                           cache_len=shape.seq_len, moe_cf=moe_cf,
                           kernel_impl="plain")

        return spmd(prefill), (params, batch)

    # decode: ONE new token against a seq_len cache
    B = shape.global_batch
    with fake:
        cache_g = init_cache(cfg, B, shape.seq_len, dtype=dtype,
                             device="cpu")
        cache = to_dtensors(mesh, cache_g, cache_shardings(
            cfg, mesh, cache_g, mode=opts.get("cache_shard", "dh")))
        del cache_g
        toks = torch.empty((B,), dtype=torch.int32)
        pos = torch.empty((B,), dtype=torch.int32)
        tp = batch_shardings(mesh, {"t": toks})["t"]
        toks, pos = to_dtensors(mesh, (toks, pos), (tp, tp))
    argmax = opts.get("decode_argmax", False)

    def serve_step(params, cache, tokens, positions):
        logits, new_cache = decode_step(cfg, params, cache, tokens,
                                        positions, kernel_impl="plain")
        if argmax:
            return torch.argmax(logits, -1).to(torch.int32), new_cache
        return logits, new_cache

    return spmd(serve_step), (params, cache, toks, pos)


def _redistribute(mesh, tree, place_tree):
    from repro_torch.distributed.sharding import _map_with_path, _leaf_at

    return _map_with_path(
        lambda path, g: g.redistribute(mesh, _leaf_at(place_tree, path)),
        tree)


# ============================================================ SPMD patches
def spmd_patches(mesh, fn):
    """``fn`` wrapped to run under ``implicit_replication`` with the
    local-shard versions of the functions DTensor cannot propagate (see
    the module docstring)."""
    from torch.distributed.tensor.experimental import implicit_replication

    @functools.wraps(fn)
    def run(*args):
        with implicit_replication(), _patched(mesh):
            return fn(*args)
    return run


def _const(value, dtype, device):
    return torch.tensor(value, dtype=dtype, device=device)


@contextlib.contextmanager
def fresh_consts():
    """``layers.const`` without its process-wide cache while the block
    runs: a constant made under a ``FakeTensorMode`` must not outlive it
    (the cache would hand it to a later real run)."""
    from repro_torch.models import layers as L
    from repro_torch.models import xlstm as X

    saved = L.const
    L.const = X.const = _const
    try:
        yield
    finally:
        L.const = X.const = saved


@contextlib.contextmanager
def _patched(mesh):
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    from repro_torch.models import recurrent as R
    from repro_torch.models import xlstm as X
    from repro_torch.training import train_loop as T

    targets = [(L, "_sdpa"), (M, "apply_moe"), (M, "_bank_products"),
               (M, "_expert"), (T, "loss_terms"), (R, "rglru_scan_ref"),
               (X, "mlstm_chunkwise_ref"), (X, "apply_slstm"), (X, "F")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]
    sp = _Spmd(mesh, {name: old for _, name, old in saved})
    for mod, name in targets:
        setattr(mod, name, getattr(sp, name.lstrip("_")))
    try:
        with fresh_consts(), _SpmdMode(sp):
            yield
    finally:
        for mod, name, old in saved:
            setattr(mod, name, old)


def _is_dt(t) -> bool:
    return isinstance(t, DTensor)


# what DTensor raises when its sharding propagation has no rule for an op
# at the given placements (a data-dependent fake result is a RuntimeError)
_NO_RULE = (RuntimeError, NotImplementedError, AssertionError, ValueError,
            IndexError)


class _SpmdMode(TorchDispatchMode):
    """Pushed above ``OpCost`` while ``fn`` runs, it sees each op on
    DTensors before DTensor does (the forward, the backward and the
    checkpointed recompute alike):

    - ``dtensor[rows, slot] = value`` (the decode ring write, an
      ``index_put_`` into a sharded cache) goes to ``_Spmd.ring_write``;
    - an op DTensor has no rule for at these placements is made again on
      its DTensor operands gathered over "model", then over every axis;
    - an op whose result would hold a strided shard (a reshape that
      merges a split dim with another: the ops after it have no rule
      for one, and gathering it later needs the data) is made again on
      its first operand gathered over those mesh dims.

    The redistributions are DTensor's, so ``OpCost`` below counts their
    collectives."""

    def __init__(self, sp):
        super().__init__()
        self.sp = sp

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        if func._opname == "index_put_" and _is_dt(args[0]):
            return self.sp.ring_write(args[0], tuple(args[1]), args[2])
        try:
            out = func(*args, **kwargs)
        except _NO_RULE as e:
            out = None
            for whole in (False, True):
                args = tree_map_only(
                    DTensor, functools.partial(self.sp.gather, whole=whole),
                    args)
                try:
                    out = func(*args, **kwargs)
                    break
                except _NO_RULE:
                    if whole:
                        raise e from None
        bad = self.sp.strided_dims(out)
        if bad and _is_dt(args[0]):
            x = args[0]
            place = [Replicate() if i in bad else p
                     for i, p in enumerate(x.placements)]
            out = func(x.redistribute(self.sp.mesh, place), *args[1:],
                       **kwargs)
        if self.sp.strided_dims(out):
            raise NotImplementedError(f"{func} leaves a strided shard")
        return out


class _Spmd:
    """Local-shard versions of the functions DTensor cannot propagate.
    Each picks its placements from its inputs' shapes (and the cache's
    placement), redistributes every input to them (``_local``: the
    collectives are DTensor's, so ``OpCost`` counts them), runs on rank
    0's shards with explicit functional collectives where a reduction
    crosses shards, and wraps the result back (``_wrap``)."""

    def __init__(self, mesh, originals):
        self.mesh = mesh
        self.orig = originals
        self.F = _Functional(self)
        self.names = tuple(mesh.mesh_dim_names)
        sizes = axis_sizes(mesh)
        self.m = sizes["model"]
        self.daxes = tuple(a for a in self.names if a in ("pod", "data"))
        self.dsize = 1
        for a in self.daxes:
            self.dsize *= sizes[a]

    # ------------------------------------------------------------ helpers
    def _b(self, n):
        return self.daxes if n % self.dsize == 0 else None

    def _model_dim(self):
        return self.names.index("model")

    def _local(self, t, spec):
        place = placements(spec, self.mesh)
        if not _is_dt(t):
            t = DTensor.from_local(t, self.mesh,
                                   [Replicate()] * len(self.names),
                                   run_check=False)
        if tuple(t.placements) != place:
            t = t.redistribute(self.mesh, place)
        return t.to_local()

    def _wrap(self, t, spec, shape, partial=(), avg=()):
        """Rank 0's shard ``t`` as a DTensor of global ``shape``; mesh
        axes in ``partial`` hold partial sums, those in ``avg`` partial
        means."""
        place = list(placements(spec, self.mesh))
        for i, a in enumerate(self.names):
            if a in partial:
                place[i] = Partial()
            elif a in avg:
                place[i] = Partial("avg")
        return DTensor.from_local(t.contiguous(), self.mesh, place,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=_contiguous(shape))

    def _tree(self, fn, tree, spec):
        if isinstance(tree, dict):
            return {k: self._tree(fn, v, spec[k]) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self._tree(fn, v, s)
                              for v, s in zip(tree, spec))
        return fn(tree, spec) if isinstance(tree, torch.Tensor) else tree

    def _run_local(self, fn, args, specs, out_specs):
        """``fn`` on rank 0's shards of ``args`` (each leaf under its spec
        of ``specs``); its outputs are wrapped under ``out_specs``."""
        local = self._tree(self._local, args, specs)
        out = fn(*local)
        return self._tree(lambda t, s: self._wrap(t, s, self._global(
            t.shape, s)), out, out_specs)

    def _global(self, shape, spec):
        sizes = axis_sizes(self.mesh)
        out = list(shape)
        for d, e in enumerate(spec):
            for a in (e if isinstance(e, tuple) else (e,) if e else ()):
                out[d] *= sizes[a]
        return tuple(out)

    def _group(self):
        return (self.mesh, self._model_dim())

    def _offset(self, n_local):
        return self.mesh.get_local_rank("model") * n_local

    def gather(self, t, whole=False):
        """``t`` replicated over "model" (over every axis with
        ``whole``; a partial sum summed)."""
        i = self._model_dim()
        place = [Replicate() if whole or j == i else p
                 for j, p in enumerate(t.placements)]
        if place == list(t.placements):
            return t
        return t.redistribute(self.mesh, place)

    def strided_dims(self, out):
        """The mesh dims on which a DTensor result (or one in a tuple)
        holds a strided shard."""
        from torch.distributed.tensor.placement_types import _StridedShard

        outs = out if isinstance(out, tuple) else (out,)
        return {i for t in outs if _is_dt(t)
                for i, p in enumerate(t.placements)
                if isinstance(p, _StridedShard)}

    # ---------------------------------------------------------- attention
    def sdpa(self, q, k, v, mask, cfg):
        """The attention core: heads split over "model" when the KV heads
        divide; a cache split on dh or on its sequence keeps its split
        (partial scores, or a cross-shard softmax); else the queries'
        sequence; else replicated."""
        if not any(_is_dt(t) for t in (q, k, v, mask)):
            return self.orig["_sdpa"](q, k, v, mask, cfg)
        B, Sq, H, dh = q.shape
        Sk, kv = k.shape[1], k.shape[2]
        m, b = self.m, self._b(B)
        kdim = None
        if _is_dt(k):
            p = k.placements[self._model_dim()]
            kdim = getattr(p, "dim", None)
        if kdim == 3 and dh % m == 0:
            mode = "dh"
        elif kdim == 1 and Sk % m == 0:
            mode = "seq"
        elif kv % m == 0:
            mode = "heads"
        elif Sq > 1 and Sq % m == 0:
            mode = "query"
        elif dh % m == 0:
            mode = "dh"
        else:
            mode = "rep"
        M_ = "model"
        qs = {"heads": (b, None, M_, None), "dh": (b, None, None, M_),
              "query": (b, M_, None, None)}.get(mode, (b, None, None, None))
        ks = {"heads": (b, None, M_, None), "dh": (b, None, None, M_),
              "seq": (b, M_, None, None)}.get(mode, (b, None, None, None))
        ms = {"seq": (b, None, M_), "query": (b, M_, None)}.get(
            mode, (b, None, None))
        grp = self._group()
        o = _attend_local(
            self._local(q, qs), self._local(k, ks), self._local(v, ks),
            self._local(mask.expand(B, *mask.shape[1:]), ms),
            scale=1.0 / math.sqrt(dh),
            dh_group=grp if mode == "dh" else None,
            seq_group=grp if mode == "seq" else None)
        o = self._wrap(o, qs, q.shape)
        if mode != "heads":     # the out projection takes whole heads
            o = o.redistribute(self.mesh, placements(
                (b, None, M_ if H % m == 0 else None, None), self.mesh))
        return o

    def ring_write(self, buf, index, value):
        """``buf[rows, slot] = value`` in place for rows = every batch row
        (the decode ring write): each rank writes its own rows, into its
        own ring range when the ring is split (a write outside it keeps
        the old value)."""
        from repro_torch.distributed.sharding import to_spec

        if len(index) != 2:
            raise NotImplementedError(
                f"sharded indexed write with {len(index)} indices")
        rows, slot = index
        spec = to_spec(buf.placements, self.mesh, buf.ndim)
        c = buf._local_tensor
        s = self._local(slot, (spec[0],))
        val = self._local(value.expand(rows.shape[0], *buf.shape[2:]),
                          (spec[0],) + tuple(spec[2:]))
        Wl = c.shape[1]
        ls = s.long()
        if spec[1] is not None:
            ls = ls - self._offset(Wl)
        ok = (ls >= 0) & (ls < Wl)
        ls = ls.clamp(0, Wl - 1)
        r = torch.arange(c.shape[0], device=c.device)
        keep = ok.reshape(ok.shape + (1,) * (val.ndim - 1))
        c.index_put_((r, ls), torch.where(keep, val.to(c.dtype),
                                          c[r, ls]))
        return buf

    # ------------------------------------------------------------ recurrent
    def _split(self, n):
        return "model" if n % self.m == 0 else None

    def rglru_scan_ref(self, a, b, h0):
        """The RG-LRU scan per channel (batch and channels stay split),
        one trip of its loop counted S times (``_loop``)."""
        if not any(_is_dt(t) for t in (a, b, h0)):
            return self.orig["rglru_scan_ref"](a, b, h0)
        bb, ds = self._b(a.shape[0]), self._split(a.shape[2])
        seq = (bb, None, ds)
        return self._run_local(_rglru_trips, (a, b, h0),
                               (seq, seq, (bb, ds)), seq)

    def mlstm_chunkwise_ref(self, q, k, v, i_pre, f_pre, state=None,
                            **kw):
        """The chunkwise mLSTM per head (batch and heads stay split), one
        chunk counted once a chunk (``_loop``)."""
        if not any(_is_dt(t) for t in (q, k, v, i_pre, f_pre)):
            return self.orig["mlstm_chunkwise_ref"](q, k, v, i_pre, f_pre,
                                                    state, **kw)
        bb, hs = self._b(q.shape[0]), self._split(q.shape[1])
        q4, g3 = (bb, hs, None, None), (bb, hs, None)
        st = (q4, g3, (bb, hs))
        args = (q, k, v, i_pre, f_pre) + ((state,) if state else ())
        specs = (q4, q4, q4, g3, g3) + ((st,) if state else ())
        return self._run_local(functools.partial(_mlstm_trips, **kw), args,
                               specs, (q4, st))

    def apply_slstm(self, p, x, cfg, state=None):
        """The sLSTM block on each rank's batch rows, its weights whole,
        one step of its loop counted S times (``_loop``)."""
        if not _is_dt(x):
            return self.orig["apply_slstm"](p, x, cfg, state)
        bb = self._b(x.shape[0])
        rep = self._tree(lambda t, s: (None,) * t.ndim, p, p)
        st = {k: (bb, None) for k in ("c", "n", "h", "m")}
        args = (p, x) + ((state,) if state else ())
        specs = (rep, (bb, None, None)) + ((st,) if state else ())
        return self._run_local(
            lambda p_, x_, *s: _slstm_trips(p_, x_, cfg, *s), args, specs,
            ((bb, None, None), st))

    def pointwise(self, fn, x):
        """An elementwise ``fn`` DTensor has no rule for, on the shard."""
        if not _is_dt(x):
            return fn(x)
        place = [Replicate() if isinstance(p, Partial) else p
                 for p in x.placements]
        if list(x.placements) != place:
            x = x.redistribute(self.mesh, place)
        y = fn(x.to_local())
        return DTensor.from_local(y, self.mesh, place, run_check=False,
                                  shape=x.shape, stride=x.stride())

    # ---------------------------------------------------------------- MoE
    def apply_moe(self, p, x, cfg, *, capacity_factor=1.25, grouped=False,
                  need_aux=True):
        """The static form with its tokens on their data shard: routing,
        dispatch and combine run on the shard's tokens (``aux`` is each
        shard's own load-balance term, averaged), the expert products
        on DTensors (``bank_products``, ``expert``), where DTensor picks
        between gathering the banks and moving the activations (an
        expert-parallel bank splits the products by expert)."""
        if not _is_dt(x):
            return self.orig["apply_moe"](
                p, x, cfg, capacity_factor=capacity_factor, grouped=grouped,
                need_aux=need_aux)
        b = self._b(x.shape[0])
        self._moe_b = b
        lp = dict(p, router=self._local(p["router"], (None, None)))
        out, aux = self.orig["apply_moe"](
            lp, self._local(x, (b, None, None)), cfg,
            capacity_factor=capacity_factor, need_aux=need_aux)
        out = self._wrap(out, (b, None, None), x.shape)
        if aux is not None:
            aux = self._wrap(aux, (), (), avg=self.daxes if b else ())
            aux = aux.redistribute(self.mesh, placements((), self.mesh))
        return out, aux

    def _tokens(self, t, dim):
        """A data shard's rows ``t`` (split on ``dim``) as a DTensor."""
        spec = [None] * t.ndim
        spec[dim] = self._moe_b
        return self._wrap(t, spec, self._global(t.shape, spec)), spec

    def bank_products(self, buf, p):
        if not _is_dt(p["w_in"]):
            return self.orig["_bank_products"](buf, p)
        bd, spec = self._tokens(buf, 1)
        return self._local(self.orig["_bank_products"](bd, p), spec)

    def expert(self, rows, w_gate, w_in, w_out):
        if not _is_dt(w_in):
            return self.orig["_expert"](rows, w_gate, w_in, w_out)
        rd, spec = self._tokens(rows, 0)
        return self._local(self.orig["_expert"](rd, w_gate, w_in, w_out),
                           spec)

    # --------------------------------------------------------------- loss
    def loss_terms(self, out, tokens):
        """``train_loop.loss_terms`` with the vocabulary split over
        "model" where it divides: a cross-shard log-sum-exp and gold
        logit (Megatron's vocab-parallel cross-entropy)."""
        logits = out["logits"]
        if not _is_dt(logits):
            return self.orig["loss_terms"](out, tokens)
        B, _, V = logits.shape
        b = self._b(B)
        vs = "model" if V % self.m == 0 else None
        lg = self._local(logits, (b, None, vs))
        tk = self._local(tokens, (b, None))
        nll = _nll_local(lg, tk, self._group() if vs else None,
                         self._offset(lg.shape[-1]) if vs else 0)
        nll = self._wrap(nll, (), (), avg=self.daxes if b else ())
        nll = nll.redistribute(self.mesh, placements((), self.mesh))
        loss = nll + out["aux"]
        return loss, {"nll": nll, "aux": out["aux"]}


class _Functional:
    """``torch.nn.functional`` for the xLSTM block, with ``logsigmoid``
    (which DTensor has no rule for) run on shards."""

    def __init__(self, sp):
        self._sp = sp

    def logsigmoid(self, x):
        import torch.nn.functional as F
        return self._sp.pointwise(F.logsigmoid, x)

    def __getattr__(self, name):
        import torch.nn.functional as F
        return getattr(F, name)


def _contiguous(shape):
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _all_reduce(t, op, group):
    from torch.distributed import _functional_collectives as funcol
    return funcol.all_reduce(t, op, group)


def _attend_local(q, k, v, mask, *, scale, dh_group=None, seq_group=None):
    """``layers._sdpa`` on shards: q (B,Sq,H,dh), k/v (B,Sk,kv,dh), mask
    (B,Sq,Sk).  ``dh_group`` sums the partial scores of a dh split;
    ``seq_group`` merges the softmax of a key split."""
    from repro_torch.kernels.ref import upcast
    from repro_torch.models.layers import NEG_INF

    B, Sq, H, dh = q.shape
    kv = k.shape[2]
    qg = q.reshape(B, Sq, kv, H // kv, dh) * scale
    s = torch.einsum("bqkgd,bskd->bkgqs", upcast(qg), upcast(k))
    if dh_group is not None:
        s = _all_reduce(s, "sum", dh_group)
    s = torch.where(mask[:, None, None, :, :], s, NEG_INF)
    mx = s.amax(-1, keepdim=True).detach()    # a stabiliser: no gradient
    if seq_group is not None:
        mx = _all_reduce(mx, "max", seq_group)
    e = torch.exp(s - mx)
    den = e.sum(-1, keepdim=True)
    if seq_group is not None:
        den = _all_reduce(den, "sum", seq_group)
    o = torch.einsum("bkgqs,bskd->bqkgd", (e / den).to(v.dtype), v)
    if seq_group is not None:
        o = _all_reduce(o, "sum", seq_group)
    return o.reshape(B, Sq, H, dh)


def _nll_local(logits, tokens, group, offset):
    """The mean next-token NLL of ``train_loop.loss_terms`` on a shard
    whose vocabulary starts at ``offset`` (all of it without
    ``group``)."""
    from repro_torch.kernels.ref import upcast

    logits = upcast(logits)
    P = logits.shape[1] - tokens.shape[1]
    pred = logits[:, P:-1]
    tgt = tokens[:, 1:].long() - offset
    Vl = pred.shape[-1]
    mx = pred.amax(-1, keepdim=True).detach()
    if group is not None:
        mx = _all_reduce(mx, "max", group)
    sumexp = torch.exp(pred - mx).sum(-1)
    if group is not None:
        sumexp = _all_reduce(sumexp, "sum", group)
    logz = torch.log(sumexp) + mx[..., 0]
    mine = (tgt >= 0) & (tgt < Vl)
    gold = torch.gather(pred, -1, tgt.clamp(0, Vl - 1)[..., None])[..., 0]
    gold = torch.where(mine, gold, torch.zeros_like(gold))
    if group is not None:
        gold = _all_reduce(gold, "sum", group)
    return (logz - gold).mean()


# ============================================ loops traced for one trip
class _Trips(torch.autograd.Function):
    """A loop of ``n`` trips of ``trip(*inputs)`` traced for one trip
    whose ops ``OpCost`` counts ``n`` times; returns fresh tensors of the
    loop's output shapes.  Its backward is one trip's backward, counted
    ``n`` times, and a gradient of each input's shape."""

    @staticmethod
    def forward(ctx, trip, n, outs, *inputs):
        from repro_torch.launch.op_cost import trips

        ctx.trip, ctx.n = trip, n
        ctx.save_for_backward(*inputs)
        with trips(n):
            trip(*inputs)
        return tuple(torch.empty(shape, dtype=dt, device=inputs[0].device)
                     for shape, dt in outs)

    @staticmethod
    def backward(ctx, *grads):
        from repro_torch.launch.op_cost import trips

        xs = [x.detach().requires_grad_(x.is_floating_point())
              for x in ctx.saved_tensors]
        with torch.enable_grad(), trips(ctx.n):
            ys = [y for y in tree_leaves(ctx.trip(*xs))
                  if isinstance(y, torch.Tensor) and y.requires_grad]
            torch.autograd.grad(ys, [x for x in xs if x.requires_grad],
                                [torch.ones_like(y) for y in ys],
                                allow_unused=True)
        return (None, None, None) + tuple(
            torch.zeros_like(x) if x.is_floating_point() else None
            for x in xs)


def _loop(trip, n, outs, *inputs):
    return _Trips.apply(trip, n, outs, *inputs)


def _rglru_trips(a, b, h0):
    """``ref.rglru_scan_ref``: its fp32 casts once, its S steps as one."""
    from repro_torch.kernels.ref import upcast

    B, S, d = a.shape

    def trip(af, bf, carry):
        return (af[:, 0] * carry + bf[:, 0]).to(a.dtype)
    return _loop(trip, S, [((B, S, d), a.dtype)], upcast(a), upcast(b),
                 upcast(h0))[0]


def _mlstm_trips(q, k, v, i_pre, f_pre, state=None, *, chunk=None):
    """``ref.mlstm_chunkwise_ref``: its chunks as one."""
    from repro_torch.kernels.ref import (MLSTM_CHUNK, NEG_INF, acc_dtype,
                                         mlstm_chunk_step)

    chunk = chunk or MLSTM_CHUNK
    B, H, S, dh = q.shape
    if state is None:
        acc = acc_dtype(q.dtype)
        state = (torch.zeros((B, H, dh, dh), dtype=acc, device=q.device),
                 torch.zeros((B, H, dh), dtype=acc, device=q.device),
                 torch.full((B, H), NEG_INF, dtype=acc, device=q.device))

    def trip(q, k, v, i_pre, f_pre, C, n, m):
        sl = slice(0, chunk)
        return mlstm_chunk_step(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                i_pre[:, :, sl], f_pre[:, :, sl], (C, n, m))
    outs = [((B, H, S, dh), q.dtype)] + [(t.shape, t.dtype) for t in state]
    h, *st = _loop(trip, -(-S // chunk), outs, q, k, v, i_pre, f_pre,
                   *state)
    return h, tuple(st)


def _slstm_trips(p, x, cfg, state=None):
    """``xlstm.apply_slstm``: its input products and output once, its S
    steps as one."""
    from repro_torch.models import xlstm as X

    B, S, _ = x.shape
    if state is None:
        state = X.init_slstm_state(cfg, B, x.dtype, x.device)
    pre = X._slstm_pre(p, x)
    keys = ("c", "n", "h", "m")

    def trip(pre, r, b, *st):
        new = X._slstm_step({"r": r, "b": b}, pre[:, :, 0],
                            dict(zip(keys, st)), cfg.n_heads)
        return tuple(new[k] for k in keys)
    outs = [((B, S) + tuple(state["h"].shape[1:]), state["h"].dtype)] + [
        (state[k].shape, state[k].dtype) for k in keys]
    hs, *st = _loop(trip, S, outs, pre, p["r"], p["b"],
                    *(state[k] for k in keys))
    return X._slstm_out(p, hs, x), dict(zip(keys, st))
