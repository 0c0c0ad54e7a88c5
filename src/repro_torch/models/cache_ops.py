"""Paged KV allocation (the page pool's host-side bookkeeping) and the
striped pool's slot copies.

The PyTorch counterpart of ``repro.models.cache_ops`` (its ``batch_axes``
detection and ``cache_batch_concat`` serve the JAX package's stacked
cache layout only and are not ported).  Attention K/V live in a shared
pool of fixed-size token pages allocated on demand, so resident KV bytes
scale with live tokens instead of ``slots × max_len``.  ``PageTable`` is
the block allocator — host-side free list + per-slot page lists +
worst-case reservations for admission control — whose device-side table
(``(n_slots, max_pages)`` int32, -1 = unallocated) the decode step
consumes; ``PrefixIndex`` finds cached page
runs for copy-on-write prefix sharing.  Both are plain Python and numpy,
copied from the JAX package; only ``device_table`` touches the device.
``PackedKV`` is the page-granular handoff wire: one sequence's live pages
and slot state, for mode switch, disaggregation and preemption.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


# ===================================================== paged KV allocation
DEFAULT_PAGE_SIZE = 16           # tokens per KV page


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` (ceil division)."""
    return -(-max(n_tokens, 0) // page_size)


def paged_geometry(cfg, n_slots: int, max_len: int, *,
                   page_size=DEFAULT_PAGE_SIZE, attn_impl: str = "kernel",
                   shared: bool = False, device=None,
                   dtype: torch.dtype = torch.float32):
    """Resolve the paged-pool geometry knobs for one engine: returns
    (page_size, block_k).

    ``page_size`` may be the string ``"auto"``: the autotuner
    (``repro_torch.kernels.autotune``) is consulted — its sweep result is
    cached on disk, so only the first engine built for a given (config,
    pool, impl, sharing mode, device kind, dtype) pays the measurement,
    timed in the pool's ``dtype`` on ``device`` (None: the port's default
    device).  ``block_k`` is always
    None (the CUDA decode kernel walks fixed 32-token tiles).  ``shared``
    flags a prefix-sharing pool — part of the tuning key, since sharing
    changes the live-page distribution the sweep measures."""
    block_k = None
    if page_size == "auto":
        from repro_torch.kernels.autotune import autotune_paged_decode
        best = autotune_paged_decode(cfg, n_slots=n_slots, max_len=max_len,
                                     attn_impl=attn_impl, shared=shared,
                                     device=device, dtype=dtype)
        page_size, block_k = best.page_size, best.block_k
    return int(page_size), block_k


class PageTable:
    """Refcounted block allocator over a shared pool of token pages.

    One instance per paged engine: the scheduler reserves worst-case
    pages at admission (so a live sequence can never hit page exhaustion
    mid-decode), the engine allocates lazily as tokens actually arrive
    (``ensure``), and retirement/handoff releases both.  Resident KV
    bytes therefore scale with *live tokens* while admission control
    stays safe.

    Pages are copy-on-write shared across slots (prefix sharing): a page
    carries a refcount — one per owning slot plus one when the attached
    ``PrefixIndex`` retains it — and joins the free list only at
    refcount zero.  ``share`` attaches an existing page run to another
    slot, ``fork`` gives a slot a private copy of one of its shared
    pages (the engine copies the page contents on device), and
    ``release``/``unhold`` decref.  Index-retained pages with no slot
    owner are *reclaimable*: admission treats them as available and the
    allocator evicts them through the index when the free list runs dry.

    ``device_table()`` exposes the allocation state as the
    ``(n_slots, max_pages)`` int32 array (-1 = unallocated) the jitted
    paged-attention executables index; it is re-uploaded only when an
    allocation actually changed.
    """

    def __init__(self, n_pages: int, page_size: int, n_slots: int,
                 max_pages: int):
        if n_pages <= 0 or page_size <= 0:
            raise ValueError("n_pages and page_size must be positive")
        self.n_pages = n_pages
        self.page_size = page_size
        self.n_slots = n_slots
        self.max_pages = max_pages
        self._free: List[int] = list(range(n_pages))
        self._slot_pages: List[List[int]] = [[] for _ in range(n_slots)]
        self._owners: List[set] = [set() for _ in range(n_pages)]
        self._refcount: List[int] = [0] * n_pages
        # retention references per page (no owning slot): the PrefixIndex
        # holds indexed pages, the engine holds wire-dedupe remap targets
        # for parked sharers — a counter, the two can stack
        self._held: List[int] = [0] * n_pages
        self._reserved: List[int] = [0] * n_slots     # pages, worst case
        # +1 page headroom while a pending copy-on-write fork briefly
        # needs the fresh copy beside the still-shared original
        self._reserve_pad: List[int] = [0] * n_slots
        # slots whose bind-time shared pages are not yet exposed in the
        # device table: the pooled decode step advances EVERY row, and a
        # bound slot awaiting prefill has a stale position — its append
        # must keep landing on the trash page, which only an all--1 row
        # guarantees.  activate() (via the prefill's ensure/fork) flushes
        # the staged run into the table.
        self._staged: set = set()
        self.prefix: Optional["PrefixIndex"] = None
        self._np_table = np.full((n_slots, max_pages), -1, np.int32)
        self._version = 0
        self._dev_version = -1
        self._dev_table: Optional[torch.Tensor] = None

    # ------------------------------------------------------------ queries
    @property
    def n_allocated(self) -> int:
        return self.n_pages - len(self._free)

    @property
    def n_slot_owned(self) -> int:
        """Distinct pages with at least one slot owner (a shared page
        counts once, index-retained orphans count zero)."""
        return sum(1 for o in self._owners if o)

    @property
    def n_reserved(self) -> int:
        """Total worst-case claim: distinct slot-owned pages plus
        reservations not yet backed by an allocation.  Index-retained
        pages with no slot owner are reclaimable and count as free."""
        return self.n_slot_owned + sum(
            max(r + pad - len(p), 0) for r, pad, p in
            zip(self._reserved, self._reserve_pad, self._slot_pages))

    def refcount(self, pid: int) -> int:
        return self._refcount[pid]

    def occupancy(self) -> Dict[str, int]:
        """Live page-pool occupancy — the ``Scheduler.stats()`` surface
        the autoscaler's page-pressure signal reads.  ``pages_live``
        counts allocated pages; ``pages_held`` the subset pinned only by
        retention references (prefix index, wire-dedupe holds) — those
        are reclaimable, so pressure readers should treat
        ``pages_live - pages_held`` as the hard floor."""
        return {"pages_total": self.n_pages,
                "pages_live": self.n_allocated,
                "pages_free": len(self._free),
                "pages_held": sum(1 for h in self._held if h > 0)}

    def slot_pages(self, slot: int) -> List[int]:
        return list(self._slot_pages[slot])

    def slot_claim(self, slot: int) -> int:
        """Worst-case reservation headroom freed if ``slot`` released
        right now: pages owned by this slot ALONE (shared pages survive
        the release and free nothing; a sole-owned page leaves
        ``n_slot_owned`` even when the prefix index retains it — the
        orphan is reclaimable and admission already counts it as free)
        plus the unbacked remainder of its worst-case reservation.
        Preemption victim selection sums this to know a victim set
        actually covers the requester's page demand."""
        sole = sum(1 for pid in self._slot_pages[slot]
                   if self._owners[pid] == {slot})
        unbacked = max(self._reserved[slot] + self._reserve_pad[slot]
                       - len(self._slot_pages[slot]), 0)
        return sole + unbacked

    def shared_match(self, prompt) -> Tuple[List[int], int]:
        """(cached page run, matched tokens) the attached prefix index
        offers for ``prompt`` — ([], 0) when no index is attached."""
        if self.prefix is None:
            return [], 0
        return self.prefix.lookup(prompt)

    def can_admit(self, n_tokens: int, prompt=None) -> bool:
        """Would a sequence of ``n_tokens`` worst-case tokens fit beside
        every outstanding reservation?  With ``prompt`` and an attached
        ``PrefixIndex``, only the *incremental* claim is charged: shared
        pages already backed by a live slot cost nothing, index-retained
        orphans cost their re-own, and a mid-page partial match charges
        one extra page for the pending copy-on-write fork."""
        need = pages_for(n_tokens, self.page_size)
        if need > self.max_pages:
            return False
        if prompt is not None and self.prefix is not None:
            ids, matched = self.prefix.lookup(prompt)
            if matched:
                m = pages_for(matched, self.page_size)
                orphans = sum(1 for pid in ids[:m] if not self._owners[pid])
                need += orphans - m + (1 if matched % self.page_size else 0)
        return need <= self.n_pages - self.n_reserved

    # --------------------------------------------------------- allocation
    def reserve(self, slot: int, n_tokens: int) -> None:
        """Claim worst-case capacity for the sequence entering ``slot``
        (admission control; no pages move)."""
        self._reserved[slot] = max(pages_for(n_tokens, self.page_size),
                                   len(self._slot_pages[slot]))
        self._reserve_pad[slot] = 0

    def bind(self, slot: int, prompt, n_tokens: int) -> int:
        """Admission-time attach: share the longest cached page run for
        ``prompt`` into ``slot`` (acquiring refcounts so the run cannot
        be evicted underneath the request) and reserve the worst case.
        Returns the matched token count the engine's prefill may skip.

        The attach is STAGED: refcounts move now (so the run cannot be
        evicted before the prefill lands), but the slot's device-table
        row stays all -1 until ``activate`` — decode steps between
        admission and prefill advance every row with this slot's stale
        position, and their garbage append must stay on the trash page."""
        self._staged.add(slot)
        ids, matched = self.shared_match(prompt)
        if matched:
            self.share(slot, ids[:pages_for(matched, self.page_size)])
        self.reserve(slot, n_tokens)
        if matched % self.page_size:
            self._reserve_pad[slot] = 1
        return matched

    def activate(self, slot: int) -> None:
        """Flush a staged bind's page run into the device table (called
        by ``ensure``/``fork`` when the prefill actually runs)."""
        if slot not in self._staged:
            return
        self._staged.discard(slot)
        pages = self._slot_pages[slot]
        if pages:
            self._np_table[slot, :len(pages)] = pages
            self._version += 1

    def _alloc(self, slot: int) -> int:
        """Pop one free page for ``slot``, reclaiming index-retained
        pages when the free list is dry."""
        if not self._free and self.prefix is not None:
            self.prefix.evict(self, 1)
        if not self._free:
            raise RuntimeError(
                f"page pool exhausted: {self.n_pages} pages, "
                f"{self.n_reserved} reserved — admission control "
                f"should have prevented this")
        pid = self._free.pop()
        assert self._refcount[pid] == 0, f"page {pid} double-allocated"
        self._owners[pid].add(slot)
        self._refcount[pid] = 1
        return pid

    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Allocate pages until ``slot`` can hold ``n_tokens`` tokens.
        Returns True when the device table changed."""
        self.activate(slot)
        pages = self._slot_pages[slot]
        need = pages_for(n_tokens, self.page_size)
        if need > self.max_pages:
            raise RuntimeError(
                f"slot {slot} needs {need} pages but max_pages="
                f"{self.max_pages} (request exceeds the engine's max_len)")
        changed = False
        while len(pages) < need:
            pid = self._alloc(slot)
            self._np_table[slot, len(pages)] = pid
            pages.append(pid)
            changed = True
        if changed:
            self._version += 1
        return changed

    def share(self, slot: int, page_ids: List[int]) -> None:
        """Append an existing (allocated) page run to ``slot``'s pages,
        taking one reference per page — the copy-on-write attach."""
        pages = self._slot_pages[slot]
        if len(pages) + len(page_ids) > self.max_pages:
            raise RuntimeError(f"slot {slot} page list would exceed "
                               f"max_pages={self.max_pages}")
        for pid in page_ids:
            if self._refcount[pid] <= 0:
                raise RuntimeError(f"cannot share unallocated page {pid}")
            if slot in self._owners[pid]:
                raise RuntimeError(
                    f"slot {slot} already owns page {pid} — a prefix run "
                    f"never references the same page twice")
            self._owners[pid].add(slot)
            self._refcount[pid] += 1
            if slot not in self._staged:
                self._np_table[slot, len(pages)] = pid
            pages.append(pid)
        if page_ids and slot not in self._staged:
            self._version += 1

    def fork(self, slot: int, index: int) -> Tuple[int, int]:
        """Copy-on-write: give ``slot`` a private copy of the page at
        position ``index`` of its run.  Returns (old_pid, new_pid) — the
        caller must copy the page contents on device when they differ; a
        page already private to ``slot`` is a no-op (old == new)."""
        self.activate(slot)
        pages = self._slot_pages[slot]
        pid = pages[index]
        if self._owners[pid] == {slot} and not self._held[pid]:
            self._reserve_pad[slot] = 0
            return pid, pid               # already private
        new = self._alloc(slot)
        self._owners[pid].discard(slot)
        self._refcount[pid] -= 1
        assert self._refcount[pid] > 0    # someone else still holds it
        pages[index] = new
        self._np_table[slot, index] = new
        self._reserve_pad[slot] = 0
        self._version += 1
        return pid, new

    def hold(self, pid: int) -> None:
        """Take one retention reference on an allocated page."""
        if self._refcount[pid] <= 0:
            raise RuntimeError(f"cannot hold unallocated page {pid}")
        self._held[pid] += 1
        self._refcount[pid] += 1

    def unhold(self, pid: int) -> None:
        """Drop one retention reference; frees the page at refcount 0."""
        if self._held[pid] <= 0:
            raise RuntimeError(f"page {pid} not held")
        self._held[pid] -= 1
        self._refcount[pid] -= 1
        if self._refcount[pid] == 0:
            self._free.append(pid)

    def release(self, slot: int) -> List[int]:
        """Drop ``slot``'s reference on every one of its pages
        (retirement / handoff) and its reservation; returns the page ids
        that actually became free (refcount reached zero — shared or
        index-retained pages live on)."""
        pages = self._slot_pages[slot]
        freed = []
        for pid in pages:
            if slot not in self._owners[pid]:
                raise RuntimeError(
                    f"double free: page {pid} not owned by slot {slot} "
                    f"(owners={sorted(self._owners[pid])})")
            self._owners[pid].discard(slot)
            self._refcount[pid] -= 1
            if self._refcount[pid] == 0:
                self._free.append(pid)
                freed.append(pid)
        self._slot_pages[slot] = []
        self._reserved[slot] = 0
        self._reserve_pad[slot] = 0
        if pages and slot not in self._staged:
            self._np_table[slot, :] = -1
            self._version += 1
        self._staged.discard(slot)
        return freed

    # ------------------------------------------------------------- device
    def device_table(self, device) -> torch.Tensor:
        """The allocation state as an (n_slots, max_pages) int32 tensor on
        ``device``, uploaded again only when an allocation changed."""
        if self._dev_version != self._version or self._dev_table is None \
                or self._dev_table.device != torch.device(device):
            self._dev_table = torch.from_numpy(self._np_table.copy()).to(
                device)
            self._dev_version = self._version
        return self._dev_table

    def check_invariants(self) -> None:
        """Refcount accounting: every page's refcount equals its owning
        slots plus the index hold, the free list holds exactly the
        refcount-zero pages, and the trash page is never shared (no page
        id reaches the pool's trash index).  Property tests call this
        after every random share/fork/release step."""
        assert len(self._free) == len(set(self._free)), \
            "page duplicated in the free list"
        for slot, pages in enumerate(self._slot_pages):
            assert len(pages) == len(set(pages)), \
                f"slot {slot} references a page twice"
            for pos, pid in enumerate(pages):
                assert 0 <= pid < self.n_pages, \
                    f"slot {slot} references the trash page ({pid})"
                assert slot in self._owners[pid], \
                    f"slot {slot} holds page {pid} without ownership"
                if slot not in self._staged:
                    assert self._np_table[slot, pos] == pid, \
                        "device table out of sync with the page run"
            if slot in self._staged:
                # staged bind: refcounts moved, device row still empty so
                # dead-slot decode appends keep landing on the trash page
                assert all(self._np_table[slot, :] == -1), \
                    f"staged slot {slot} leaked pages into the device table"
            else:
                assert all(self._np_table[slot, len(pages):] == -1), \
                    "device table row has entries past the page run"
        free = set(self._free)
        for pid in range(self.n_pages):
            owners = self._owners[pid]
            want = len(owners) + self._held[pid]
            assert self._refcount[pid] == want, \
                (f"page {pid} refcount {self._refcount[pid]} != "
                 f"{len(owners)} owners + held={self._held[pid]}")
            assert (pid in free) == (self._refcount[pid] == 0), \
                f"page {pid} free-list membership disagrees with refcount"
            for slot in owners:
                assert pid in self._slot_pages[slot], \
                    f"owner {slot} of page {pid} lost it from its run"
        assert self.n_allocated == sum(
            1 for r in self._refcount if r > 0), "pages leaked"
        # NOTE: n_reserved <= n_pages is deliberately NOT asserted here —
        # it is admission discipline (can_admit callers), not allocator
        # structure; direct reserve/ensure interleavings may overshoot it


class PrefixIndex:
    """Page-granular prefix index: prompt tokens → longest cached run.

    A forest keyed by rolling token-id hashes at page granularity: each
    node maps one page's token tuple to the cached page holding exactly
    those tokens, and a node is reachable only through its full prefix
    chain, so a lookup hashes one page of ids per level (Python's tuple
    hash — the per-page rolling hash) and equality on the dict key
    verifies the tokens exactly (no false sharing on hash collisions).

    The index retains its pages with one ``PageTable.hold`` reference
    each, so indexed prefixes survive their writer's retirement; when
    the allocator's free list runs dry it calls back into ``evict``,
    which drops least-recently-used *leaf* entries (evicting an interior
    page would orphan its descendants) until enough retained-only pages
    fall back to the free list.  Only immutable pages are inserted —
    pages completely covered by a prompt, which decode never appends
    into — so a retained page's contents can never change under a
    sharer.  A lookup may additionally match a *partial* final page (the
    prompt diverges mid-page from a cached run): those tokens are
    shareable for reads — attention masks positions past the match —
    but the page must be forked before the sharer's first write.
    """

    def __init__(self, page_size: int):
        self.page_size = page_size
        self._next_id = 1
        # eid -> (parent_eid, page_tokens, pid, children{tokens: eid},
        #         stamp); eid 0 is the implicit root
        self._nodes: dict = {}
        self._roots: dict = {}            # first-page tokens -> eid
        self._clock = 0
        self.stats = {"hits": 0, "misses": 0, "evictions": 0,
                      "inserted_pages": 0}

    def __len__(self) -> int:
        return len(self._nodes)

    def _children(self, eid: int) -> dict:
        return self._roots if eid == 0 else self._nodes[eid][3]

    def _touch(self, eid: int) -> None:
        self._clock += 1
        n = self._nodes[eid]
        self._nodes[eid] = n[:4] + (self._clock,)

    def lookup(self, prompt) -> Tuple[List[int], int]:
        """Longest cached page run matching a prefix of ``prompt``.

        Returns (page_ids, matched_tokens); the match is capped at
        ``len(prompt) - 1`` so a fully-cached prompt still leaves one
        suffix token to prefill (something must produce the first output
        logits).  The final page may match partially (mid-page
        divergence) — ``matched % page_size != 0`` signals the pending
        fork-on-write."""
        ps = self.page_size
        target = max(len(prompt) - 1, 0)
        run: List[int] = []
        matched = 0
        node = 0
        for i in range(target // ps):
            eid = self._children(node).get(tuple(prompt[i * ps:(i + 1) * ps]))
            if eid is None:
                break
            self._touch(eid)
            run.append(self._nodes[eid][2])
            matched += ps
            node = eid
        else:
            i = target // ps
        tail = tuple(prompt[i * ps:target])
        if tail:                          # partial match of one more page
            best, best_len = None, 0
            for tokens, eid in self._children(node).items():
                n = 0
                for a, b in zip(tail, tokens):
                    if a != b:
                        break
                    n += 1
                if n > best_len:
                    best, best_len = eid, n
            if best is not None:
                self._touch(best)
                run.append(self._nodes[best][2])
                matched += best_len
        self.stats["hits" if matched else "misses"] += 1
        return run, matched

    def insert(self, pt: PageTable, prompt, page_ids) -> None:
        """Index ``prompt``'s immutable pages (those its tokens fill
        completely) from the slot's page run, retaining each newly
        indexed page with a ``hold`` reference.  Pages already on the
        identical chain are left as indexed (the sharer's own shared
        prefix re-inserts as a no-op)."""
        ps = self.page_size
        node = 0
        for i in range(len(prompt) // ps):
            tokens = tuple(prompt[i * ps:(i + 1) * ps])
            children = self._children(node)
            eid = children.get(tokens)
            if eid is None:
                pid = page_ids[i]
                pt.hold(pid)
                self._clock += 1
                eid = self._next_id
                self._next_id += 1
                self._nodes[eid] = (node, tokens, pid, {}, self._clock)
                children[tokens] = eid
                self.stats["inserted_pages"] += 1
            else:
                self._touch(eid)
            node = eid

    def evict(self, pt: PageTable, n_pages: int) -> int:
        """Drop least-recently-used leaf entries until ``n_pages`` pages
        reached the free list (or nothing evictable remains).  Evicting
        releases the index's hold; a page still referenced by live slots
        stays allocated, so eviction keeps going until enough *orphan*
        pages actually free up."""
        freed = 0
        while freed < n_pages:
            leaf = None
            for eid, (_, _, _, children, stamp) in self._nodes.items():
                if not children and (leaf is None
                                     or stamp < self._nodes[leaf][4]):
                    leaf = eid
            if leaf is None:
                break
            parent, tokens, pid, _, _ = self._nodes.pop(leaf)
            self._children(parent).pop(tokens)
            before = len(pt._free)
            pt.unhold(pid)
            freed += len(pt._free) - before
            self.stats["evictions"] += 1
        return freed

    def clear(self, pt: PageTable) -> None:
        """Drop every entry (engine teardown / leak checks)."""
        while self._nodes:
            self.evict(pt, pt.n_pages)


# ========================================================= striped slot ops
def _leaf_map(fn, *trees):
    """Apply ``fn`` to matching tensor leaves of nested dicts and lists."""
    head = trees[0]
    if isinstance(head, dict):
        return {k: _leaf_map(fn, *(t[k] for t in trees)) for k in head}
    if isinstance(head, (list, tuple)):
        return type(head)(_leaf_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def put_row(dst, slot, value) -> None:
    """``dst[slot] = value`` in place: for an int ``slot``, ``value`` is a
    scalar or a tensor with a leading axis of one; for a (1,) int64
    tensor ``slot`` (one ``index_copy_``: no host value, so a CUDA graph
    can hold it), a tensor of one row."""
    if isinstance(slot, torch.Tensor):
        dst.index_copy_(0, slot, value.to(dst.dtype).reshape(
            (1,) + tuple(dst.shape[1:])))
    else:
        dst[slot] = value[0].to(dst.dtype) \
            if isinstance(value, torch.Tensor) else value


def slot_row(table, slot):
    """Row ``slot`` of ``table`` (an int or a (1,) int64 tensor slot)."""
    if isinstance(slot, torch.Tensor):
        return table.index_select(0, slot)[0]
    return table[slot]


def cache_scatter(pool_cache, seq_cache, slot):
    """Write a batch-1 striped cache into row ``slot`` (an int or a (1,)
    int64 tensor) of the pooled one, in place; returns the pool.  Every
    striped leaf keeps the slot on axis 0 (``models.model.init_cache``),
    so the JAX package's per-leaf batch-axis detection (``batch_axes``) is
    not needed; every leaf is overwritten, recurrent state included."""
    def scatter(pool, seq):
        put_row(pool, slot, seq)
        return pool
    return _leaf_map(scatter, pool_cache, seq_cache)


def cache_gather(pool_cache, slot: int):
    """Row ``slot`` of a pooled striped cache as a batch-1 cache (copies)."""
    return _leaf_map(lambda pool: pool[slot:slot + 1].clone(), pool_cache)


def _leaves(tree):
    """Tensor leaves of nested dicts and lists, in insertion order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def bytes_as(raw: torch.Tensor, shape, dtype: torch.dtype) -> torch.Tensor:
    """A 1-D uint8 tensor's bytes as a ``dtype`` tensor of ``shape``: a
    view where the storage offset is a multiple of the item size, else a
    copy (``Tensor.view(dtype)`` raises on a misaligned offset)."""
    if raw.storage_offset() % dtype.itemsize:
        raw = raw.clone()
    return raw.view(dtype).reshape(shape)


# ------------------------------------------------------- page-granular KV
@dataclasses.dataclass
class PackedKV:
    """A sequence's live KV state packed page-granularly for the wire.

    ``kv`` mirrors the paged cache's per-layer list for ONE sequence:
    attention layers hold ``{"k", "v"}`` with only the sequence's live
    pages, contiguous and in position order (shape (n_live_pages,
    page_size, kv, dh)); recurrent layers hold their state dict batch-1.
    ``nbytes`` is what a handoff actually moves (the pricing input for
    the recompute-vs-transfer decision, §4.4) and ``wire()`` materializes
    the single contiguous buffer a transport would send.

    Prefix sharing dedupes pages on the wire: within one handoff export
    (``batch`` tags it) each distinct source page ships once, so a
    payload whose prefix rides in an earlier payload of the same batch
    carries only its ``carried`` suffix positions in ``kv`` and names
    every position's *source* page id in ``page_ids``.  The adopter
    remaps source ids to its own pool's pages (sharing ones already
    adopted), so the sharing structure survives the wire, and ``nbytes``
    prices only the deduped bytes.
    """
    n_tokens: int
    page_size: int
    kv: Any
    page_ids: Optional[Tuple[int, ...]] = None   # source pool page ids
    carried: Optional[Tuple[int, ...]] = None    # positions present in kv
    batch: Optional[int] = None                  # handoff export tag

    @property
    def n_pages(self) -> int:
        return pages_for(self.n_tokens, self.page_size)

    @property
    def deduped(self) -> bool:
        """True when some pages ride in another payload of the batch."""
        return (self.carried is not None
                and len(self.carried) < self.n_pages)

    @property
    def nbytes(self) -> int:
        return int(sum(t.numel() * t.element_size()
                       for t in _leaves(self.kv)))

    def wire(self) -> Tuple[torch.Tensor,
                            List[Tuple[Tuple[int, ...], torch.dtype]]]:
        """Flatten to one contiguous uint8 tensor on the leaves' device +
        per-leaf (shape, dtype) spec (leaf order = ``kv``'s order)."""
        leaves = list(_leaves(self.kv))
        spec = [(tuple(t.shape), t.dtype) for t in leaves]
        buf = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                         for t in leaves]) if leaves \
            else torch.zeros((0,), dtype=torch.uint8)
        return buf, spec

    def from_wire(self, buf: torch.Tensor,
                  spec: List[Tuple[Tuple[int, ...], torch.dtype]]
                  ) -> "PackedKV":
        """Rebuild the payload from a wire buffer (same structure as
        self); leaves are views into ``buf`` where aligned."""
        leaves, off = [], 0
        for shape, dtype in spec:
            n = math.prod(shape) * dtype.itemsize
            leaves.append(bytes_as(buf[off:off + n], shape, dtype))
            off += n
        it = iter(leaves)
        return PackedKV(self.n_tokens, self.page_size,
                        _leaf_map(lambda _: next(it), self.kv),
                        page_ids=self.page_ids, carried=self.carried,
                        batch=self.batch)


def payload_nbytes(payload: Any) -> int:
    """Wire bytes of a handoff payload: a ``PackedKV`` (page-granular),
    a raw batch-1 striped cache (``cache_gather``), or None."""
    if payload is None:
        return 0
    if isinstance(payload, PackedKV):
        return payload.nbytes
    return int(sum(t.numel() * t.element_size() for t in _leaves(payload)))
