"""Inference engines in PyTorch: static-batch and continuous-batching.

The counterparts of ``repro.serving.engine``.  ``InferenceEngine`` is the
static loop (one prefill, a fixed decode loop over the striped ring
cache: the ring decode kernel, one launch per attention layer per step).
``ContinuousBatchingEngine`` executes the request-level schedule of
``repro_torch.serving.scheduler`` in the ``unified`` role, on the paged
KV cache by default or, with ``paged=False``, on per-slot striped rings.
Each tick advances every live slot by one pooled decode step and
prefills new arrivals into free slots (the flash prefill kernel; the
RG-LRU scan and mLSTM chunkwise kernels for recurrent layers; an
attention-free model still allocates pages, which carry no K/V).  On the paged layout
copy-on-write prefix sharing lets a prompt whose leading pages are cached
share them and prefill only its suffix (attention-only configs).

PyTorch runs eagerly, so there are no per-shape executables; the decode
kernels bound their walks by each slot's length, so the JAX engine's
live-page buckets are not needed either.  Caches are updated in place.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import (DEFAULT_PAGE_SIZE, PageTable, PrefixIndex,
                                cache_from_prefill, cache_scatter,
                                decode_step, forward, init_cache,
                                init_paged_cache, paged_copy_page,
                                paged_geometry, paged_prefill_scatter,
                                paged_suffix_prefill, pages_for,
                                supports_prefix_sharing)
from repro_torch.serving.scheduler import (DEFAULT_SLOTS, AdmissionPolicy,
                                           Scheduler, SeqState)

if TYPE_CHECKING:                                    # pragma: no cover
    from repro_torch.serving.workload import SLOClass


class InferenceEngine:
    """Static-batch reference engine: one prefill, fixed decode loop over
    the striped ring cache.  ``kernel_impl``: see ``models.layers``."""

    def __init__(self, cfg: ModelConfig, params, *, max_len: int = 4096,
                 kernel_impl: str = "kernel"):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.kernel_impl = kernel_impl

    def prefill(self, batch: Dict, cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, dict]:
        """Last-position logits (B, V) and the striped decode cache."""
        cache_len = cache_len or self.max_len
        out = forward(self.cfg, self.params, batch, build_cache=True,
                      kernel_impl=self.kernel_impl, last_only=True)
        return out["logits"][:, -1], cache_from_prefill(
            self.cfg, out["kv"], cache_len, batch["tokens"].shape[1])

    def generate(self, batch: Dict, max_new_tokens: int, *,
                 greedy: bool = True,
                 generator: Optional[torch.Generator] = None,
                 temperature: float = 1.0,
                 cache_len: Optional[int] = None) -> torch.Tensor:
        """Returns (B, max_new_tokens) generated token ids.  ``greedy=False``
        samples from softmax(logits / temperature) with ``generator`` (a
        ``torch.Generator`` on the parameters' device)."""
        if not greedy and generator is None:
            raise ValueError("sampling needs a torch.Generator")
        logits, cache = self.prefill(
            batch,
            cache_len=cache_len or batch["tokens"].shape[1] + max_new_tokens)
        tok = self._sample(logits, greedy, generator, temperature)
        toks = [tok]
        for _ in range(1, max_new_tokens):
            logits, cache = decode_step(self.cfg, self.params, cache, tok,
                                        cache["pos"],
                                        kernel_impl=self.kernel_impl)
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
    """

    def __init__(self, cfg: ModelConfig, params, *,
                 n_slots: int = DEFAULT_SLOTS, max_len: int = 512,
                 max_prefill_per_tick: int = 1, paged: bool = True,
                 page_size=DEFAULT_PAGE_SIZE,
                 n_pages: Optional[int] = None, kernel_impl: str = "kernel",
                 prefix_sharing: bool = True,
                 policy: Optional[AdmissionPolicy] = None,
                 shed_limit: Optional[int] = None):
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.n_slots = n_slots
        self.max_len = max_len
        self.kernel_impl = kernel_impl
        self.paged = paged
        self.prefix_sharing = bool(paged and prefix_sharing
                                   and supports_prefix_sharing(cfg))
        dtype = params["embed"].dtype
        if paged:
            page_size, _ = paged_geometry(cfg, n_slots, max_len,
                                          page_size=page_size,
                                          shared=self.prefix_sharing)
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
            self.cache["pages"] = self.pages.device_table(self.device)
        else:
            self.pages = None
            self.cache = init_cache(cfg, n_slots, max_len, dtype=dtype,
                                    device=self.device)
        self.sched = Scheduler(n_slots,
                               max_prefill_per_tick=max_prefill_per_tick,
                               pages=self.pages, policy=policy,
                               shed_limit=shed_limit)
        # every update makes a NEW tensor: pending records keep a
        # reference and read their slot at flush time
        self._last_tok = torch.zeros((n_slots,), dtype=torch.int64,
                                     device=self.device)
        self._next_id = 0
        # lazily-resolved token ids: (seq, index, slot, device tensor).
        # EOS-terminated sequences need token values at schedule time, so
        # any eos_id switches the engine to per-tick host reads.
        self._pending: List[Tuple[SeqState, int, int, torch.Tensor]] = []
        self._eager = False
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
        need = len(prompt) + max_new_tokens
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
        vals = torch.stack([a for _, _, _, a in self._pending]).cpu()
        for (seq, idx, slot, _), row in zip(self._pending, vals):
            seq.generated[idx] = int(row[slot])
        self._pending = []

    def _set_first(self, slot: int, logits) -> None:
        tok = self._last_tok.clone()
        tok[slot] = logits.argmax(-1)[0]
        self._last_tok = tok

    def _do_prefill(self, slot: int, seq: SeqState) -> None:
        toks = seq.tokens_so_far
        shared = seq.shared_tokens if self.prefix_sharing else 0
        if shared:
            # the scheduler's bind() attached the cached prefix run to
            # this slot; prefill covers only the suffix.  A mid-page
            # divergence forks the partially-matched page first (CoW:
            # the suffix writes into it, and other owners must never see
            # those writes).
            if shared % self.page_size:
                old, new = self.pages.fork(slot, shared // self.page_size)
                if old != new:
                    paged_copy_page(self.cfg, self.cache, old, new)
            self.pages.ensure(slot, len(toks))
            self.cache["pages"] = self.pages.device_table(self.device)
            suffix = torch.tensor([toks[shared:]], dtype=torch.int64,
                                  device=self.device)
            logits, self.cache = paged_suffix_prefill(
                self.cfg, self.params, self.cache, suffix, slot, shared)
            self._set_first(slot, logits)
        else:
            tokens = torch.tensor([toks], dtype=torch.int64,
                                  device=self.device)
            out = forward(self.cfg, self.params, {"tokens": tokens},
                          build_cache=True, kernel_impl=self.kernel_impl,
                          last_only=True)
            self._set_first(slot, out["logits"][:, -1])
            if self.paged:
                self.pages.ensure(slot, len(toks))
                self.cache["pages"] = self.pages.device_table(self.device)
                paged_prefill_scatter(self.cfg, self.cache, out["kv"], slot,
                                      self.cache["pages"][slot], len(toks))
            else:
                cache_scatter(self.cache,
                              cache_from_prefill(self.cfg, out["kv"],
                                                 self.max_len, len(toks)),
                              slot)
        if self.prefix_sharing:
            # index the prompt's immutable pages so later prompts can
            # share them; decode never appends into an indexed page
            # (first append position >= len(prompt))
            self.pages.prefix.insert(self.pages, seq.prompt,
                                     self.pages.slot_pages(slot))
        self.sched.on_prefilled(slot, self._record(seq, slot,
                                                   self._last_tok))

    def step(self) -> bool:
        """Run one scheduler tick.  Returns False when nothing ran."""
        tick = self.sched.next_tick()
        if tick.idle:
            return False
        # drop back to the sync-free path once no live/queued sequence
        # terminates on EOS
        if self._eager and not any(
                s is not None and s.eos_id is not None
                for s in self.sched.slots) and not any(
                s.eos_id is not None for s in self.sched.queue):
            self._eager = False
        # decode first: the pooled decode step advances EVERY cache row,
        # so freshly-prefilled rows must be written after it, not before
        if tick.decode:
            if self.paged:
                # the incoming token's page must exist before the step
                # writes its K/V at position seq.pos - 1
                for slot in tick.decode:
                    self.pages.ensure(slot, self.sched.slots[slot].pos)
                self.cache["pages"] = self.pages.device_table(self.device)
            logits, self.cache = decode_step(
                self.cfg, self.params, self.cache, self._last_tok,
                self.cache["pos"], kernel_impl=self.kernel_impl)
            self._last_tok = logits.argmax(-1)
            for slot in tick.decode:
                seq = self.sched.slots[slot]
                self.sched.on_decoded(slot, self._record(seq, slot,
                                                         self._last_tok))
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

    def take_shed(self) -> List[Tuple[int, str, float]]:
        """Drain the shed log — (req_id, slo_class_name, retry_after)
        for every submit the scheduler rejected since the last drain."""
        out, self.shed_log = self.shed_log, []
        return out

    # ------------------------------------------------------------- status
    @property
    def stats(self) -> Dict[str, int]:
        return self.sched.stats
