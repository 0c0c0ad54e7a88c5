"""Inference engines in PyTorch: static-batch and continuous-batching.

The counterparts of ``repro.serving.engine``.  ``InferenceEngine`` is the
static loop (one prefill, a fixed decode loop over the striped ring
cache: the ring decode kernel, one launch per attention layer per step).
``ContinuousBatchingEngine`` executes the request-level schedule of
``repro_torch.serving.scheduler`` in any of its roles (``unified``,
``prefill``, ``decode``), on the paged KV cache by default or, with
``paged=False``, on per-slot striped rings.
Each tick advances every live slot by one pooled decode step and
prefills new arrivals into free slots (the flash prefill kernel; the
RG-LRU scan and mLSTM chunkwise kernels for recurrent layers; an
attention-free model still allocates pages, which carry no K/V).  On the paged layout
copy-on-write prefix sharing lets a prompt whose leading pages are cached
share them and prefill only its suffix (attention-only configs).

The mode switch, disaggregation and preemption move live sequences
between engines: ``handoff`` (after ``drain``), ``export_prefilled``
(prefill role) and ``preempt_export`` pack each slot's live pages into a
``PackedKV`` (deduped on the wire under prefix sharing), and ``adopt``
restores them copy-on-adopt into fresh pages, parking what does not fit
in the scheduler's resume queue.  A sequence that arrives without a
cache (from the pipelined engine, which keeps none) has it recomputed
once through ``core.mode_switch.handoff_requests``; it resumes in DECODE
and never re-enters the prefill queue.

The decode tick is the port's counterpart of the JAX engine's compiled
executables (``_cb_executables``/``_paged_executables``): one in-place
step body (``models.decode_step_inplace``) reads the page table, the
positions and the last tokens from static per-engine tensors and writes
every cache leaf and the greedy tokens in place.  On the CPU it runs
eagerly every tick.  On a CUDA device the first decode tick runs it
eagerly on a side stream (the real tick, and the warm-up: kernel builds,
split counts, cuBLAS handles), then the engine captures it as one CUDA
graph (``kernels.graph``) and every later tick is one replay, guarded
against stale addresses and counted in the kernels' launch counters.
Everything that writes the cache between ticks (prefill scatter, suffix
prefill, copy-on-write, adoption) writes in place.  The fused step sizes
its split by the table's MP·ps, so one graph serves every page count,
and the decode kernels bound their walks by each slot's length: the JAX
engine's per-bucket decode executables are not needed.

Prefills are compiled the same way, per length bucket, as the JAX
package compiles one prefill executable per prompt length: a prompt (or
a shared-prefix suffix) is right-padded to ``prefill_bucket(n)`` tokens
and its real length, slot and suffix start are staged in place into
one-element device tensors, so one step body (forward with
``length=``, scatter, first token into ``_tok``, the slot's position)
serves every slot and every length of its bucket, exactly: causal
masking keeps the real rows, padded K/V land on the trash page or
outside the ring, and recurrent state is read at the real length.  On a
CUDA device each bucket's first prefill runs eagerly and is then
captured (``prefill_graphs``, one memory pool for all buckets of the
engine); later prefills of the bucket are replays.  A config with a
``moe`` ffn keeps its prefill eager (the grouped form reads the expert
counts to the host); its decode tick is captured all the same.  The CPU
runs the same padded bodies eagerly.  ``InferenceEngine`` pads nothing:
it compiles its prefill and its decode step per exact batch shape.
"""
from __future__ import annotations

import functools
import itertools
from collections import OrderedDict
from typing import (TYPE_CHECKING, Any, Dict, List, Optional, Sequence,
                    Tuple)

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.mode_switch import handoff_requests
from repro_torch.kernels import graph
from repro_torch.models import (DEFAULT_PAGE_SIZE, PackedKV, PageTable,
                                PrefixIndex, cache_from_prefill,
                                cache_gather, cache_scatter,
                                decode_step_inplace, forward, has_moe,
                                init_cache, init_paged_cache, n_positions,
                                pack_single_cache, paged_adopt_scatter,
                                paged_copy_page, paged_geometry, paged_pack,
                                paged_prefill_scatter, paged_suffix_prefill,
                                pages_for, supports_prefix_sharing)
from repro_torch.models.cache_ops import _leaf_map, _leaves, slot_row
from repro_torch.serving.scheduler import (DEFAULT_SLOTS, AdmissionPolicy,
                                           Scheduler, SeqState, SlotState)

# wire-dedupe export tag: every export of a prefix-sharing engine gets a
# fresh batch id, shared by all its payloads, so adopters can remap
# source page ids without ever confusing two exports
_HANDOFF_BATCH = itertools.count(1)

if TYPE_CHECKING:                                    # pragma: no cover
    from repro_torch.serving.workload import SLOClass

# the shortest prefill length bucket, in tokens
MIN_BUCKET = 16
# the batch shapes an ``InferenceEngine`` keeps (static inputs, cache,
# graphs), and the batch entries it stages
MAX_SHAPES = 4
_STATIC_INPUTS = ("tokens", "patches", "frames")
# ``ContinuousBatchingEngine.decode_graphs``'s one key
_TICK = "tick"


def prefill_bucket(n: int, cap: int) -> int:
    """The length an ``n``-token prefill is right-padded to: the next
    power of two from MIN_BUCKET, at most ``cap`` (and never below n).
    So an engine holds at most log2(cap / 16) + 2 prefill graphs of a
    kind."""
    b = max(MIN_BUCKET, 1 << max(n - 1, 0).bit_length())
    return max(n, min(b, cap))


def _scalar(device) -> torch.Tensor:
    """A one-element int64 device tensor: a step input staged in place."""
    return torch.zeros((1,), dtype=torch.int64, device=device)


class InferenceEngine:
    """Static-batch reference engine: one prefill, fixed decode loop over
    the striped ring cache.  Batches carry "patches" (vlm) or "frames"
    (encdec) beside "tokens"; MoE layers drop nothing.  ``kernel_impl``:
    see ``models.layers``.

    The prefill step (forward, the striped cache written in place into
    the engine's cache for the batch's shape) and the decode step
    (``decode_step_inplace`` on that cache) are CUDA graphs on a CUDA
    device, captured at the first use of their key, which is the batch's
    exact shape, as ``jax.jit`` keys the JAX engine's executables: (text
    shape, cache length, extra inputs).  Nothing is padded: ``generate``'s
    cache length is the text plus the new tokens, so a length bucket
    would still key one graph per text length.  ``prefill_graphs`` share
    one memory pool, ``decode_graphs`` another; the engine keeps the
    inputs, cache and graphs of its MAX_SHAPES most recent shapes.  A MoE
    config's prefill stays eager."""

    def __init__(self, cfg: ModelConfig, params, *, max_len: int = 4096,
                 kernel_impl: str = "kernel"):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.kernel_impl = kernel_impl
        self.device = params["embed"].device
        self.prefill_graphs = graph.StepGraphs(self.device,
                                               capturing=not has_moe(cfg))
        self.decode_graphs = graph.StepGraphs(self.device)
        # shape key -> {"batch": static inputs, "cache", "tok"}, the most
        # recently used last
        self._shapes: "OrderedDict[Tuple, Dict[str, Any]]" = OrderedDict()

    def _shape(self, batch: Dict, cache_len: int) -> Tuple:
        """The key of ``batch``'s shape, its static inputs staged from
        ``batch``; the least recently used shape beyond MAX_SHAPES is
        dropped with its graphs."""
        inputs = {k: batch[k] for k in _STATIC_INPUTS
                  if batch.get(k) is not None}
        key = (cache_len,) + tuple((k, tuple(v.shape), v.dtype)
                                   for k, v in inputs.items())
        st = self._shapes.pop(key, None)
        if st is None:
            B = batch["tokens"].shape[0]
            st = {"batch": {k: torch.empty(v.shape, dtype=v.dtype,
                                           device=self.device)
                            for k, v in inputs.items()},
                  "cache": init_cache(self.cfg, B, cache_len,
                                      dtype=self.params["embed"].dtype,
                                      device=self.device),
                  "tok": torch.zeros((B,), dtype=torch.int64,
                                     device=self.device)}
        self._shapes[key] = st
        while len(self._shapes) > MAX_SHAPES:
            old, _ = self._shapes.popitem(last=False)
            self.prefill_graphs.drop(old)
            self.decode_graphs.drop(old)
        for k, v in inputs.items():
            st["batch"][k].copy_(v)
        return key

    def _prefill(self, batch: Dict, cache_len: int) -> Tuple[Tuple, Any]:
        """Stage ``batch`` and run its shape's prefill step: (the shape's
        key, last-position logits (B, V), a static output of the step's
        graph); the shape's cache holds the prefill."""
        key = self._shape(batch, cache_len)
        st = self._shapes[key]

        def body():
            out = forward(self.cfg, self.params, st["batch"],
                          build_cache=True, cache_len=cache_len,
                          moe_cf=None, kernel_impl=self.kernel_impl,
                          last_only=True)
            _leaf_map(torch.Tensor.copy_, st["cache"], cache_from_prefill(
                self.cfg, out["kv"], cache_len,
                n_positions(self.cfg, st["batch"])))
            return out["logits"][:, -1]
        return key, self.prefill_graphs.run(
            key, body, [*st["batch"].values(), *_leaves(st["cache"])])

    def prefill(self, batch: Dict, cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, dict]:
        """Last-position logits (B, V) and the striped decode cache of
        length ``cache_len``, positioned after the prefill's last position
        (patches + tokens): copies, which the engine's later steps do not
        touch."""
        key, logits = self._prefill(batch, cache_len or self.max_len)
        return logits.clone(), _leaf_map(torch.clone,
                                         self._shapes[key]["cache"])

    def _decode(self, key: Tuple, tok: torch.Tensor) -> torch.Tensor:
        """One decode step, in place, of shape ``key``'s cache on the
        tokens ``tok`` (B,); returns the logits (B, V), a static output of
        the step's graph."""
        st = self._shapes[key]
        st["tok"].copy_(tok)
        return self.decode_graphs.run(
            key, lambda: decode_step_inplace(self.cfg, self.params,
                                             st["cache"], st["tok"],
                                             kernel_impl=self.kernel_impl),
            [st["tok"], *_leaves(st["cache"])])

    def generate(self, batch: Dict, max_new_tokens: int, *,
                 greedy: bool = True,
                 generator: Optional[torch.Generator] = None,
                 temperature: float = 1.0,
                 cache_len: Optional[int] = None) -> torch.Tensor:
        """Returns (B, max_new_tokens) generated token ids.  ``greedy=False``
        samples from softmax(logits / temperature) with ``generator`` (a
        ``torch.Generator`` on the parameters' device).  ``cache_len``
        defaults to the text tokens plus ``max_new_tokens``, as in the JAX
        package: a vlm batch's patches are not counted, so its ring wraps
        over the first positions in the last steps (pass ``cache_len`` to
        keep them)."""
        if not greedy and generator is None:
            raise ValueError("sampling needs a torch.Generator")
        key, logits = self._prefill(
            batch, cache_len or batch["tokens"].shape[1] + max_new_tokens)
        tok = self._sample(logits, greedy, generator, temperature)
        toks = [tok]
        for _ in range(1, max_new_tokens):
            logits = self._decode(key, tok)
            tok = self._sample(logits, greedy, generator, temperature)
            toks.append(tok)
        return torch.stack(toks, dim=1)

    @staticmethod
    def _sample(logits, greedy, generator, temperature):
        if greedy:
            return logits.argmax(-1)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]


class ContinuousBatchingEngine:
    """Slot-pool engine executing the continuous-batching schedule.

    The decode cache for ``n_slots`` lives on the parameters' device:
    paged by default, per-slot striped rings with ``paged=False`` (the
    baseline layout; prefill is forward plus a slot scatter, and every
    leaf of the slot, recurrent state included, is overwritten).  Each
    scheduler tick (a) advances the whole pool one decode step, keeping
    only the tokens of live slots, and (b) prefills up to
    ``max_prefill_per_tick`` queued requests into free slots.  Greedy
    decoding only.  Prefix sharing needs the paged layout and an
    attention-only config, and is off otherwise.  ``kernel_impl``: see
    ``models.layers``.

    ``role`` specializes the engine to one phase of the request
    lifecycle (prefill/decode disaggregation): a ``prefill`` engine runs
    prompt passes only and streams finished prompt pages out through
    ``export_prefilled()`` (the deduped ``PackedKV`` wire); a ``decode``
    engine takes no fresh prompts and receives everything pre-prefilled
    via ``adopt``.  Non-unified roles need the paged layout: the wire
    between the pools IS the page-granular ``PackedKV`` path.
    ``preemption=True`` (paged only) evicts lower-priority decode slots
    over the same wire when a higher class cannot be admitted.

    On a CUDA device every decode tick after the first is one replay of
    the engine's captured decode graph (``decode_graph``), which holds a
    private memory pool until the engine is freed, and every fresh or
    suffix prefill after the first of its length bucket is one replay of
    that bucket's graph (``prefill_graphs``, keyed ("fresh" or "suffix",
    bucket), one shared pool; eager for a MoE config).  Nothing may
    replace a cache leaf (``cache``'s tensors are updated in place); a
    replaced leaf makes the next tick raise.
    """

    def __init__(self, cfg: ModelConfig, params, *,
                 n_slots: int = DEFAULT_SLOTS, max_len: int = 512,
                 max_prefill_per_tick: int = 1, paged: bool = True,
                 page_size=DEFAULT_PAGE_SIZE,
                 n_pages: Optional[int] = None, kernel_impl: str = "kernel",
                 prefix_sharing: bool = True,
                 policy: Optional[AdmissionPolicy] = None,
                 role: str = "unified",
                 shed_limit: Optional[int] = None,
                 preemption: bool = False):
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.n_slots = n_slots
        self.max_len = max_len
        self.kernel_impl = kernel_impl
        self.role = role
        if role != "unified" and not (paged and cfg.family != "encdec"):
            raise ValueError(
                f"{role}-role engine needs the paged KV layout — the "
                f"prefill → decode wire is the page-granular PackedKV "
                f"path")
        # encdec keeps fixed-size cross-attention K/V per slot: it stays
        # on the striped layout, as in the JAX package
        self.paged = paged and cfg.family != "encdec"
        paged = self.paged
        self.prefix_sharing = bool(paged and prefix_sharing
                                   and supports_prefix_sharing(cfg))
        dtype = params["embed"].dtype
        if paged:
            page_size, _ = paged_geometry(cfg, n_slots, max_len,
                                          page_size=page_size,
                                          attn_impl=kernel_impl,
                                          shared=self.prefix_sharing,
                                          device=self.device, dtype=dtype)
            self.page_size = page_size
            self.max_pages = pages_for(max_len, page_size)
            self.n_pages = n_pages or n_slots * self.max_pages
            self.pages = PageTable(self.n_pages, page_size, n_slots,
                                   self.max_pages)
            if self.prefix_sharing:
                self.pages.prefix = PrefixIndex(page_size)
            self.cache = init_paged_cache(
                cfg, n_slots, n_pages=self.n_pages, page_size=page_size,
                max_pages=self.max_pages, dtype=dtype, device=self.device)
        else:
            self.pages = None
            self.cache = init_cache(cfg, n_slots, max_len, dtype=dtype,
                                    device=self.device)
        self.sched = Scheduler(n_slots,
                               max_prefill_per_tick=max_prefill_per_tick,
                               pages=self.pages, policy=policy, role=role,
                               shed_limit=shed_limit)
        # the next decode input of every slot, at a fixed address: the
        # decode step reads it and writes the step's greedy tokens back
        # into it, so pending records keep a copy of it, never it
        self._tok = torch.zeros((n_slots,), dtype=torch.int64,
                                device=self.device)
        # the table upload last copied into cache["pages"]
        self._table_src: Optional[torch.Tensor] = None
        # the decode tick, captured at the first tick (CUDA only), in a
        # memory pool of its own
        self.decode_graphs = graph.StepGraphs(self.device)
        # the prefill steps' static inputs: the real length, the slot and
        # the suffix start (shared by every bucket), the right-padded
        # tokens (one buffer a bucket); and their graphs, per bucket
        self._n, self._slot, self._start = (_scalar(self.device)
                                            for _ in range(3))
        self._tokens: Dict[int, torch.Tensor] = {}
        self.prefill_graphs = graph.StepGraphs(self.device,
                                               capturing=not has_moe(cfg))
        self._next_id = 0
        # lazily-resolved token ids: (seq, index, slot, device tensor).
        # EOS-terminated sequences need token values at schedule time, so
        # any eos_id switches the engine to per-tick host reads.
        self._pending: List[Tuple[SeqState, int, int, torch.Tensor]] = []
        self._eager = False
        # handed-off sequences waiting for a slot (Scheduler.resume_queue):
        # req_id -> payload, or None when the cache must be rebuilt
        # (mode-switch recomputation) at resume time
        self._parked: Dict[int, Any] = {}
        # wire-dedupe adoption state per handoff batch: source-pid → own
        # pool page remap, pages held alive for parked sharers, and the
        # req_ids of batch payloads not yet restored here
        self._dedupe: Dict[int, Dict[str, Any]] = {}
        # overload survival: preemption packs low-priority victims over
        # the PackedKV wire into this outbox.  A cluster harvests it
        # (take_preempted); a standalone engine re-enqueues it at the NEXT
        # step — one tick late on purpose, so the requester that triggered
        # the preemption takes the freed slot/pages first.
        self.preemption = bool(preemption and self.paged)
        self.preempt_outbox: List[Tuple[SeqState, Any, int]] = []
        # (req_id, slo_class_name, retry_after) of submits the scheduler
        # rejected outright; drained by take_shed()
        self.shed_log: List[Tuple[int, str, float]] = []

    # ------------------------------------------------------------- intake
    def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
               req_id: Optional[int] = None,
               eos_id: Optional[int] = None,
               t_arrive: Optional[float] = None,
               slo: Optional["SLOClass"] = None,
               probe: bool = False) -> int:
        if req_id is None:
            req_id = self._next_id
        self._next_id = max(self._next_id, req_id) + 1
        # a prefill-role pool only ever holds the prompt's KV (the slot
        # is exported before any decode step appends to it)
        need = len(prompt) if self.role == "prefill" \
            else len(prompt) + max_new_tokens
        if need > self.max_len:
            raise ValueError(
                f"request needs {need} cache slots "
                f"but the pool was built with max_len={self.max_len}")
        if self.paged and pages_for(need, self.page_size) > self.n_pages:
            raise ValueError(
                f"request needs more pages than the whole pool holds "
                f"({self.n_pages} × {self.page_size} tokens)")
        if eos_id is not None:
            self._eager = True
        res = self.sched.submit(SeqState(req_id, list(prompt),
                                         max_new_tokens, eos_id=eos_id,
                                         t_arrive=t_arrive, slo=slo,
                                         probe=probe))
        if res.shed:
            self.shed_log.append((req_id,
                                  slo.name if slo is not None else "",
                                  res.retry_after))
        return req_id

    # ------------------------------------------------------------ execution
    def _record(self, seq: SeqState, slot: int, arr) -> int:
        """Register a device-side token for ``seq``; returns the id to
        append (the real value in eager mode, a placeholder otherwise)."""
        if self._eager:
            return int(arr[slot])
        self._pending.append((seq, len(seq.generated), slot, arr))
        return -1

    def flush(self) -> None:
        """Resolve placeholder token ids (one device-to-host copy)."""
        if not self._pending:
            return
        vals = torch.cat([a[slot:slot + 1]
                          for _, _, slot, a in self._pending]).cpu()
        for (seq, idx, _, _), v in zip(self._pending, vals.tolist()):
            seq.generated[idx] = v
        self._pending = []

    def _stage_token(self, slot: int, value) -> None:
        """Make ``value`` the next decode input of ``slot`` (in place)."""
        self._tok[slot] = value

    def _sync_table(self) -> None:
        """Copy the allocator's table into ``cache["pages"]`` (in place:
        the decode graph reads it there) when an allocation changed."""
        table = self.pages.device_table(self.device)
        if table is not self._table_src:
            self.cache["pages"].copy_(table)
            self._table_src = table

    # ---------------------------------------------------- the decode tick
    def _decode_body(self) -> torch.Tensor:
        """One decode step of the whole pool, every tensor in place: what
        the graph captures.  Returns the logits (B, V)."""
        logits = decode_step_inplace(self.cfg, self.params, self.cache,
                                     self._tok, kernel_impl=self.kernel_impl)
        self._tok.copy_(logits.argmax(-1))
        return logits

    def _graph_inputs(self) -> List[torch.Tensor]:
        """The tensors the decode step reads and writes from outside."""
        return [self._tok, *_leaves(self.cache)]

    @property
    def decode_graph(self) -> Optional[graph.CapturedStep]:
        """The captured decode tick, or None before the first tick (or
        off CUDA)."""
        return self.decode_graphs.steps.get(_TICK)

    @decode_graph.setter
    def decode_graph(self, step: graph.CapturedStep) -> None:
        self.decode_graphs.steps[_TICK] = step

    def _decode_tick(self) -> None:
        self.decode_graphs.run(_TICK, self._decode_body,
                               self._graph_inputs())

    # ------------------------------------------------------- the prefills
    def _fresh_body(self, tokens: torch.Tensor) -> torch.Tensor:
        """A fresh prefill of the staged prompt (``tokens`` right-padded
        past ``_n``) into slot ``_slot``, in place: the cache scatter, the
        first token into ``_tok`` and the slot's position.  Returns the
        first token (1,)."""
        out = forward(self.cfg, self.params, {"tokens": tokens},
                      build_cache=True, cache_len=self.max_len, moe_cf=None,
                      kernel_impl=self.kernel_impl, last_only=True,
                      length=self._n)
        first = out["logits"][:, -1].argmax(-1)
        if self.paged:
            paged_prefill_scatter(self.cfg, self.cache, out["kv"],
                                  self._slot,
                                  slot_row(self.cache["pages"], self._slot),
                                  self._n)
        else:
            cache_scatter(self.cache,
                          cache_from_prefill(self.cfg, out["kv"],
                                             self.max_len, self._n),
                          self._slot)
        self._tok.index_copy_(0, self._slot, first)
        return first

    def _suffix_body(self, tokens: torch.Tensor) -> torch.Tensor:
        """The suffix prefill of the staged suffix (``_n`` real tokens at
        positions ``_start``...) into slot ``_slot``; as ``_fresh_body``."""
        logits, _ = paged_suffix_prefill(self.cfg, self.params, self.cache,
                                         tokens, self._slot, self._start,
                                         n_tokens=self._n)
        first = logits.argmax(-1)
        self._tok.index_copy_(0, self._slot, first)
        return first

    def _prefill_step(self, kind: str, slot: int,
                      toks: Sequence[int]) -> torch.Tensor:
        """Stage ``toks`` right-padded into their bucket's buffer, their
        count and ``slot``, and run the ``kind`` prefill of the bucket (a
        graph replay after its first use on CUDA).  Returns a copy of the
        first token (1,)."""
        n = len(toks)
        Sb = prefill_bucket(n, self.max_len)
        tokens = self._tokens.get(Sb)
        if tokens is None:
            tokens = self._tokens[Sb] = torch.zeros(
                (1, Sb), dtype=torch.int64, device=self.device)
        host = torch.tensor([list(toks) + [0] * (Sb - n)],
                            dtype=torch.int64)
        if self.device.type == "cuda":
            host = host.pin_memory()     # no host wait on the device
        tokens.copy_(host, non_blocking=True)
        self._n.fill_(n)
        self._slot.fill_(slot)
        body = self._suffix_body if kind == "suffix" else self._fresh_body
        first = self.prefill_graphs.run(
            (kind, Sb), functools.partial(body, tokens),
            [tokens, self._n, self._slot, self._start, self._tok,
             *_leaves(self.cache)])
        return first.clone()

    def _do_prefill(self, slot: int, seq: SeqState) -> None:
        toks = seq.tokens_so_far
        shared = seq.shared_tokens if self.prefix_sharing else 0
        if self.paged:
            if shared % self.page_size:
                # the scheduler's bind() attached the cached prefix run to
                # this slot; prefill covers only the suffix.  A mid-page
                # divergence forks the partially-matched page first (CoW:
                # the suffix writes into it, and other owners must never
                # see those writes).
                old, new = self.pages.fork(slot, shared // self.page_size)
                if old != new:
                    paged_copy_page(self.cfg, self.cache, old, new)
            self.pages.ensure(slot, len(toks))
            self._sync_table()
        if shared:
            self._start.fill_(shared)
            first = self._prefill_step("suffix", slot, toks[shared:])
        else:
            first = self._prefill_step("fresh", slot, toks)
        if self.prefix_sharing:
            # index the prompt's immutable pages so later prompts can
            # share them; decode never appends into an indexed page
            # (first append position >= len(prompt))
            self.pages.prefix.insert(self.pages, seq.prompt,
                                     self.pages.slot_pages(slot))
        self.sched.on_prefilled(slot, self._record(seq, 0, first))

    def step(self) -> bool:
        """Run one scheduler tick.  Returns False when nothing ran."""
        # un-harvested preemption victims (no cluster took them last
        # tick) re-enter the resume queue now, AFTER the preempting
        # requester was admitted
        if self.preempt_outbox:
            self.adopt([(s, p) for s, p, _ in self.preempt_outbox])
            self.preempt_outbox = []
        self._maybe_preempt()
        tick = self.sched.next_tick()
        # a parked sequence that finished while parked (EOS in its last
        # handed-off token) is retired by the scheduler without ever
        # taking a slot — drop the payload it was parked with
        if self._parked:
            for rid in [r for r in self._parked if r in self.sched.finished]:
                self._dedupe_discard(rid, self._parked.pop(rid))
        if tick.idle:
            return False
        # drop back to the sync-free path once no live/queued/parked
        # sequence terminates on EOS
        if self._eager and not any(
                s is not None and s.eos_id is not None
                for s in self.sched.slots) and not any(
                s.eos_id is not None
                for s in self.sched.queue + self.sched.resume_queue):
            self._eager = False
        # resumed sequences are mid-decode: their caches must land in the
        # pool BEFORE this tick's decode step advances every row
        for slot, seq in tick.resume:
            self._restore(slot, seq, self._parked.pop(seq.req_id, None))
        # decode first: the pooled decode step advances EVERY cache row,
        # so freshly-prefilled rows must be written after it, not before
        if tick.decode:
            if self.paged:
                # the incoming token's page must exist before the step
                # writes its K/V at position seq.pos - 1
                for slot in tick.decode:
                    self.pages.ensure(slot, self.sched.slots[slot].pos)
                self._sync_table()
            self._decode_tick()
            # the next tick overwrites _tok: pending records read a copy
            toks = self._tok.clone()
            for slot in tick.decode:
                seq = self.sched.slots[slot]
                self.sched.on_decoded(slot, self._record(seq, slot, toks))
        for slot, seq in tick.admit:
            self._do_prefill(slot, seq)
        return True

    def run(self) -> Dict[int, List[int]]:
        """Drive ticks until queue and slots are empty; returns
        req_id -> generated tokens."""
        while self.step():
            pass
        self.flush()
        return {rid: s.generated for rid, s in self.sched.finished.items()}

    # ----------------------------------------------------- wire dedupe state
    def _dedupe_state(self, batch: int) -> Dict[str, Any]:
        return self._dedupe.setdefault(
            batch, {"remap": {}, "holds": [], "pending": set(),
                    "needed": set()})

    def _dedupe_discard(self, req_id: int, payload: Any) -> None:
        """A batch payload left without restoring here (finished while
        parked, or re-exported by a further handoff): drop it from the
        batch's pending set, releasing the batch's page holds once no
        parked payload can reference them anymore."""
        if not (isinstance(payload, PackedKV) and payload.batch is not None):
            return
        st = self._dedupe.get(payload.batch)
        if st is None:
            return
        st["pending"].discard(req_id)
        if not st["pending"]:
            self._dedupe_release(payload.batch)

    def _dedupe_release(self, batch: int) -> None:
        st = self._dedupe.pop(batch, None)
        if st is not None:
            for pid in st["holds"]:
                self.pages.unhold(pid)

    def _restore_shared(self, slot: int, seq: SeqState,
                        payload: PackedKV) -> bool:
        """Restore a wire-deduped payload: its referenced pages rode in
        an earlier payload of the same handoff batch and are resolved
        through the batch remap (source page id → own pool page), shared
        copy-on-write into this slot; only the ``carried`` suffix pages
        are scattered from the wire.  Returns False when a reference
        does not resolve here (the carrier was adopted elsewhere, or
        restored with a different batch) — the caller rebuilds the cache
        from tokens instead."""
        st = self._dedupe_state(payload.batch)
        st["pending"].discard(seq.req_id)
        remap, carried = st["remap"], set(payload.carried)
        refs: List[int] = []
        for p in range(payload.n_pages):
            if p in carried:
                break
            dst = remap.get(payload.page_ids[p])
            if dst is None:
                return False
            refs.append(dst)
        # sharing is prefix-structured: carried pages must be exactly
        # the suffix past the referenced run
        if sorted(carried) != list(range(len(refs), payload.n_pages)):
            return False
        self.pages.share(slot, refs)
        self.pages.ensure(slot, payload.n_tokens)
        self._sync_table()
        fresh = self.pages.slot_pages(slot)[len(refs):]
        paged_adopt_scatter(self.cfg, self.cache, payload, slot, fresh)
        for j, p in enumerate(sorted(carried)):
            src = payload.page_ids[p]
            if src in st["needed"] and src not in remap:
                remap[src] = fresh[j]
                if st["pending"]:
                    # parked batch-mates may reference this page after
                    # this slot retires — hold it until the batch drains
                    self.pages.hold(fresh[j])
                    st["holds"].append(fresh[j])
        return True

    def _index_restored(self, slot: int, seq: SeqState) -> None:
        """A restored sequence's prompt pages are as shareable as a
        freshly-prefilled one's (the scatter laid the tokens out
        linearly, and decode only appends past them) — index them for
        future prompts."""
        if self.prefix_sharing:
            self.pages.prefix.insert(self.pages, seq.prompt,
                                     self.pages.slot_pages(slot))

    def _restore(self, slot: int, seq: SeqState, payload: Any) -> None:
        """Restore a handed-off sequence's KV state into ``slot`` and
        stage its last generated token as the next decode input.

        Payload kinds: a ``PackedKV`` (page-granular wire form, possibly
        wire-deduped against an earlier payload of its handoff batch), a
        raw batch-1 striped cache (striped engines), or None — the source
        kept no decode cache (λPipe); the cache is then rebuilt once from
        the tokens (§4.4) and the sequence never re-enters the prefill
        queue."""
        if self.paged:
            if isinstance(payload, PackedKV) \
                    and payload.batch is not None \
                    and payload.page_size == self.page_size:
                ok = self._restore_shared(slot, seq, payload)
                st = self._dedupe.get(payload.batch)
                if st is not None and not st["pending"]:
                    self._dedupe_release(payload.batch)
                if ok:
                    self._index_restored(slot, seq)
                    self._stage_token(slot, seq.generated[-1])
                    return
                payload = None         # unresolvable refs: rebuild below
            if payload is None:
                payload = handoff_requests(
                    self.cfg, self.params, [seq], cache_len=self.max_len,
                    page_size=self.page_size,
                    kernel_impl=self.kernel_impl)[seq.req_id]
            elif not isinstance(payload, PackedKV):
                payload = pack_single_cache(self.cfg, payload,
                                            self.page_size)
            if payload.page_size != self.page_size:
                raise ValueError(
                    f"page-size mismatch at adoption: payload "
                    f"{payload.page_size} vs pool {self.page_size}")
            self.pages.ensure(slot, payload.n_tokens)
            self._sync_table()
            ids = self.pages.slot_pages(slot)[:payload.n_pages]
            paged_adopt_scatter(self.cfg, self.cache, payload, slot, ids)
            self._index_restored(slot, seq)
        else:
            if payload is None:     # pipelined source kept no decode cache
                payload = handoff_requests(
                    self.cfg, self.params, [seq], cache_len=self.max_len,
                    kernel_impl=self.kernel_impl)[seq.req_id]
            elif isinstance(payload, PackedKV):
                raise ValueError(
                    "page-granular payload handed to a striped engine — "
                    "adopt into a paged engine or hand off with None")
            cache_scatter(self.cache, payload, slot)
        self._stage_token(slot, seq.generated[-1])

    # --------------------------------------------------------- mode switch
    def drain(self) -> None:
        self.sched.drain()

    def _pack_slot(self, slot: int, seq: SeqState, batch: Optional[int],
                   shipped: set) -> PackedKV:
        """Pack one live slot's KV pages into the ``PackedKV`` wire form
        (shared by drain-time ``handoff``, ``export_prefilled`` and
        preemption).  With a dedupe ``batch``, pages already shipped in
        this export ride as references only."""
        # the cache holds seq.pos - 1 tokens: the last generated token
        # is the next decode input, not yet written
        n_tok = seq.pos - 1
        ids = self.pages.slot_pages(slot)[:pages_for(n_tok,
                                                     self.page_size)]
        if batch is None:
            return paged_pack(self.cfg, self.cache, slot, ids, n_tok,
                              self.page_size)
        carried = tuple(p for p, pid in enumerate(ids) if pid not in shipped)
        payload = paged_pack(self.cfg, self.cache, slot, ids, n_tok,
                             self.page_size,
                             ship=[ids[p] for p in carried])
        payload.page_ids = tuple(ids)
        payload.carried = carried
        payload.batch = batch
        shipped.update(ids)
        return payload

    # ------------------------------------------------------- preemption
    def _maybe_preempt(self) -> None:
        """Preempt low-priority decode slots when the policy's next
        fresh admission is a HIGHER class that cannot be admitted for
        lack of a slot or pages.  Victims are packed over the PackedKV
        wire into ``preempt_outbox`` before the tick plans admissions,
        so the requester takes the freed capacity this very tick."""
        if not self.preemption or self.role == "prefill" \
                or self.sched.draining or not self.sched.queue:
            return
        sched = self.sched
        head = sched.queue[sched._pick(sched.queue)]
        if head.priority <= 0:
            return                  # lowest class preempts nobody
        free = sched.free_slots()
        if free and self.pages.can_admit(sched.admit_tokens(head),
                                         prompt=head.prompt):
            return                  # plain admission takes it this tick
        if sched._quota_blocked(head):
            return         # quota would veto it — don't shed live work
        # worst-case incremental pages still missing (slot_claim sums
        # are worst-case too, so coverage implies admissibility)
        headroom = self.pages.n_pages - self.pages.n_reserved
        need = pages_for(sched.admit_tokens(head), self.page_size) \
            - max(headroom, 0)
        victims = sched.pick_victims(need, head.slo, need_slot=not free)
        if victims:
            self.preempt_export(victims)

    def preempt_export(self, slots: Sequence[int]
                       ) -> List[Tuple[SeqState, Any, int]]:
        """Pack the live pages of each victim slot into the deduped
        ``PackedKV`` wire form and evict it (``Scheduler.preempt``):
        the slot and its pages free immediately (CoW sharers keep their
        references — packing copies page contents, so the payload is
        self-contained), and the (seq, payload, pages_reclaimed)
        triples land in ``preempt_outbox`` for a cluster to park — or
        for the engine itself to re-enqueue next step.  The sequence
        later re-enters through the ordinary resume/adopt machinery, so
        its greedy tokens stay equal to an uninterrupted run's."""
        if not self.paged:
            raise RuntimeError("preemption needs the paged KV layout")
        self.flush()       # _restore stages seq.generated[-1] at resume
        batch = next(_HANDOFF_BATCH) if self.prefix_sharing else None
        shipped: set = set()
        out: List[Tuple[SeqState, Any, int]] = []
        for slot in slots:
            seq = self.sched.slots[slot]
            if seq is None or seq.finished:
                continue           # EOS landed at flush — retires instead
            claim = self.pages.slot_claim(slot)
            payload = self._pack_slot(slot, seq, batch, shipped)
            self.sched.preempt(slot)
            out.append((seq, payload, claim))
        self.preempt_outbox.extend(out)
        return out

    def take_preempted(self) -> List[Tuple[SeqState, Any, int]]:
        """Drain the preemption outbox — (seq, payload, pages_reclaimed)
        triples the caller must now own (park them and re-enter them
        later, or hand them to ``adopt``)."""
        out, self.preempt_outbox = self.preempt_outbox, []
        return out

    def take_shed(self) -> List[Tuple[int, str, float]]:
        """Drain the shed log — (req_id, slo_class_name, retry_after)
        for every submit the scheduler rejected since the last drain."""
        out, self.shed_log = self.shed_log, []
        return out

    def evict_parked(self, req_id: int) -> Tuple[SeqState, Any]:
        """Remove a parked (resume-queue) sequence from this engine so
        the caller can re-route it to a less wedged instance.  Returns
        (seq, payload); the payload degrades to None when it was
        wire-deduped against THIS engine's adoption state — its page
        references resolve nowhere else, so the target rebuilds the
        cache from tokens instead (§4.4 recompute, still exact)."""
        seq = next(s for s in self.sched.resume_queue
                   if s.req_id == req_id)
        self.sched.resume_queue.remove(seq)
        payload = self._parked.pop(req_id, None)
        if isinstance(payload, PackedKV) and payload.batch is not None:
            self._dedupe_discard(req_id, payload)
            payload = None
        return seq, payload

    # ----------------------------------------------------- disagg export
    def export_prefilled(self) -> List[Tuple[SeqState, Any]]:
        """Stream out every prefilled slot (prefill-role wire).

        Each slot whose prompt pass has produced its first token is
        packed through the same batch-deduped ``PackedKV`` export as
        ``handoff()`` and its slot freed for the next prompt — but unlike
        a drain the engine keeps serving, and queued/parked state stays
        put.  Sequences that finished AT prefill (one-token budget, or
        EOS first) retire here and are not exported.  Policy order
        decides who ships first (who gets the decode pool's free slots).
        """
        if self.role != "prefill":
            raise RuntimeError(
                "export_prefilled() is the prefill-role wire — unified "
                "engines hand off at drain time instead")
        ready = self.sched.prefilled_slots()
        if not ready:
            return []
        self.flush()      # adopters need concrete first-token ids (§4.4)
        ready = [s for s in ready          # EOS may have landed at flush
                 if not self.sched.slots[s].finished]
        pairs = [(s, self.sched.slots[s]) for s in ready]
        pairs = [pairs[i] for i in
                 sorted(range(len(pairs)),
                        key=lambda i: self.sched.policy_key(pairs[i][1],
                                                            i))]
        batch = next(_HANDOFF_BATCH) if self.prefix_sharing else None
        shipped: set = set()
        out: List[Tuple[SeqState, Any]] = []
        for slot, seq in pairs:
            payload = self._pack_slot(slot, seq, batch, shipped)
            self.sched.export_slot(slot)
            out.append((seq, payload))
        return out

    def handoff(self) -> List[Tuple[SeqState, Any]]:
        """Export in-flight sequences with their live KV state.

        A paged engine packs only each sequence's live pages into a
        ``PackedKV`` wire payload (page-granular handoff); a striped
        engine gathers the whole slot row (``cache_gather``).  Sequences
        still queued (never prefilled) carry ``None``.  The export list
        is ordered by the admission policy (who gets the adopting
        instance's free slots first); FCFS keeps slot order.

        A prefix-sharing engine dedupes shared pages on the wire: the
        export gets one ``batch`` tag, each source page ships in the
        FIRST payload whose run holds it, and later payloads carry only
        their un-shipped suffix plus the source page ids the adopter
        needs to remap.  Payloads are packed in policy order so carriers
        always precede the payloads that reference them."""
        self.flush()          # adopters need concrete token ids (§4.4)
        out: List[Tuple[SeqState, Any]] = []
        live = [(i, s) for i, s in enumerate(self.sched.slots)
                if s is not None and not s.finished
                and self.sched.state[i] is not SlotState.FREE]
        live = [live[i] for i in
                sorted(range(len(live)),
                       key=lambda i: self.sched.policy_key(live[i][1], i))]
        batch = next(_HANDOFF_BATCH) if self.prefix_sharing else None
        shipped: set = set()
        for slot, seq in live:
            if self.paged:
                out.append((seq, self._pack_slot(slot, seq, batch,
                                                 shipped)))
            else:
                out.append((seq, cache_gather(self.cache, slot)))
        have = {s.req_id for s, _ in out}
        for seq in self.sched.handoff():     # releases slots (and pages)
            if seq.req_id not in have:
                # parked sequences keep the payload they arrived with;
                # a parked wire-deduped payload stops referencing THIS
                # engine's remap once exported, so its batch holds drop
                payload = self._parked.pop(seq.req_id, None)
                self._dedupe_discard(seq.req_id, payload)
                out.append((seq, payload))
        # un-harvested preemption victims ride along: they sit in no
        # scheduler queue, but their packed payloads are live state
        for seq, payload, _ in self.preempt_outbox:
            if seq.req_id not in have:
                out.append((seq, payload))
        self.preempt_outbox = []
        return out

    def adopt(self, pairs: Sequence[Tuple[SeqState, Any]]) -> None:
        """Adopt handed-off sequences (mode switch, §4.4).

        A sequence arriving with a live cache is scattered straight into
        a free slot; one arriving without (e.g. from a pipelined instance
        that keeps no decode cache) has its cache rebuilt once via
        ``core.mode_switch.handoff_requests`` — either way it resumes in
        DECODE and never re-enters the prefill queue.  When more live
        sequences arrive than slots (or pages) are free, the overflow
        parks in the scheduler's resume queue and enters DECODE as slots
        retire.  Sequences that never started decode are submitted
        normally."""
        if self.role == "prefill":
            raise RuntimeError(
                "prefill-role engine runs prompt passes only — adopt "
                "into a decode-role (or unified) engine")
        if any(s.eos_id is not None for s, _ in pairs):
            self._eager = True
        started = [(s, c) for s, c in pairs if s.generated]
        fresh = [s for s, c in pairs if not s.generated]
        # register every wire-dedupe batch payload BEFORE placement: the
        # first restored carrier must see its batch-mates as pending so
        # it holds the pages a later (possibly parked) sharer references.
        # Only source pages some OTHER payload references (non-carried
        # positions) need a retention hold.
        for s, payload in started:
            if isinstance(payload, PackedKV) and payload.batch is not None:
                st = self._dedupe_state(payload.batch)
                st["pending"].add(s.req_id)
                st["needed"].update(
                    payload.page_ids[p] for p in range(payload.n_pages)
                    if p not in payload.carried)
        # the ADOPTING scheduler's policy decides who takes the free
        # slots and who parks (stable: FCFS keeps the handoff order)
        started = [started[i] for i in
                   sorted(range(len(started)),
                          key=lambda i: self.sched.policy_key(
                              started[i][0], i))]
        free = self.sched.free_slots()
        placed = 0
        parked_any = False
        for seq, payload in started:
            # a paged pool admits by page budget as well as by slot.
            # Once one pair parks, every later pair parks too — the same
            # no-small-request-bypass FCFS the scheduler applies.
            if not parked_any and placed < len(free) and (
                    not self.paged
                    or self.pages.can_admit(seq.total_tokens)):
                slot = free[placed]
                placed += 1
                self._restore(slot, seq, payload)
                self.sched.adopt(seq, slot)
            else:
                parked_any = True
                self._parked[seq.req_id] = payload
                self.sched.enqueue_resume(seq)
        for seq in fresh:
            self.sched.submit(seq)

    def set_role(self, role: str) -> None:
        """Switch between the ``decode`` and ``unified`` roles in place
        (a cluster's fallback when a model's prefill pool empties).  Both
        roles size admission by the full generation budget, so the switch
        only toggles the submit gate; prefill conversions are refused —
        prompt-sized reservations on live slots cannot retroactively
        cover a generation budget."""
        if role == self.role:
            return
        if "prefill" in (role, self.role):
            raise ValueError(
                f"cannot convert a live engine {self.role!r} → {role!r}: "
                f"only decode ↔ unified share an admission sizing")
        self.role = role
        self.sched.role = role

    # ------------------------------------------------------------- status
    @property
    def stats(self) -> Dict[str, int]:
        return self.sched.stats
