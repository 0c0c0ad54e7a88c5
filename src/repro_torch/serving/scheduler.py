"""Request-level continuous-batching scheduler (λScale model manager).

A serving instance — local replica or λPipe execution pipeline — owns a
fixed pool of KV-cache *slots*.  The scheduler admits queued requests into
free slots (prefill), interleaves those prefills with batched decode of
every in-flight sequence, and retires finished sequences so freed slots
are refilled mid-generation.  It is pure Python and backend-agnostic: the
engines (``repro_torch.serving.engine.ContinuousBatchingEngine`` here, the
JAX package's engines in ``repro``) execute the actions it
emits, the discrete-event simulator prices instances with the same slot
constants, and the property tests drive it directly.

Slot state machine (see docs/architecture.md):

    FREE ──admit──▶ PREFILL ──first token──▶ DECODE ──finish──▶ FREE
                                                │
                                         drain/handoff
                                                ▼
                                      adopted by another
                                      instance in DECODE

Draining (mode switch, §4.4): a draining instance admits nothing new;
its in-flight sequences are exported by ``handoff()`` and re-enter a
local replica directly in DECODE — the request never re-runs its
completed prefill phase.

Roles (prefill/decode disaggregation): a scheduler can specialize to
one phase of the request lifecycle.  A ``prefill``-role scheduler runs
prompt passes only — admission reserves *prompt* pages (not the full
generation budget), ``next_tick`` never decodes, and a prefilled slot
sits in DECODE until ``export_slot`` streams it out over the PackedKV
wire; adoption entry points are closed.  A ``decode``-role scheduler
is the receiving end: ``submit`` is closed (prompts must route through
a prefill pool), everything arrives pre-prefilled via ``adopt``/
``enqueue_resume`` and is sized by the full generation budget.  The
default ``unified`` role is today's behavior, bit for bit.

Admission order is a pluggable ``AdmissionPolicy`` (the request control
plane): FCFS is the baseline, ``EDFPolicy`` orders by absolute TTFT
deadline (the request's ``SLOClass``), and ``StrictPriorityPolicy``
orders by class priority with aging so low classes never starve.  The
policy orders *everything the scheduler orders* — fresh admissions, the
resume queue of handed-off sequences, and the export order at drain
time (which decides who gets the adopting instance's free slots first).
A policy only reorders; it never drops or duplicates, so the admitted
set is always a permutation of FCFS's (tested).
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import TYPE_CHECKING, ClassVar, Dict, List, Optional, Tuple

if TYPE_CHECKING:                                    # pragma: no cover
    from repro_torch.models.cache_ops import PageTable
    from repro_torch.serving.workload import SLOClass

# ------------------------------------------------------ shared constants
# These ground the discrete-event simulator in the real engine: the
# simulator's per-instance concurrency and pipelined-mode penalties are
# imported from here, so the capacity it prices is the capacity the
# scheduler actually exposes.
DEFAULT_SLOTS = 8                # KV-cache slots per serving instance
PIPELINE_TOK_OVERHEAD = 1.10     # per-token inflation in pipelined mode
HOP_LATENCY = 2e-4               # activation hand-off per stage per token
MAX_PREFILL_PER_TICK = 1         # decode never starves behind admissions
ROLES = ("unified", "prefill", "decode")   # engine/scheduler phase roles


def instance_slot_count(kind: str, n_nodes: int,
                        base: int = DEFAULT_SLOTS) -> int:
    """Concurrent requests an instance sustains.  2-D pipelining (§4.3):
    a g-stage pipeline keeps all g nodes busy on different in-flight
    batches, so it exposes g× the per-replica slots."""
    return base * (n_nodes if kind == "pipeline" else 1)


# -------------------------------------------------------- overload surface
@dataclasses.dataclass(frozen=True)
class SubmitResult:
    """Outcome of ``Scheduler.submit`` under overload control.

    ``status`` is ``SubmitResult.OK`` (queued) or ``SubmitResult.SHED``
    (rejected outright).  A shed carries ``retry_after`` — a hint in
    scheduler ticks until queue pressure plausibly clears — so a client
    (or the cluster's audit log) can back off deterministically rather
    than hammering a saturated instance.  ``submit`` always returns one;
    callers that predate shedding may ignore it (OK is falsy-free and
    sheds only happen when a ``shed_limit`` is configured).
    """
    status: str = "ok"
    retry_after: float = 0.0
    reason: str = ""

    OK: ClassVar[str] = "ok"
    SHED: ClassVar[str] = "shed"

    @property
    def shed(self) -> bool:
        return self.status == SubmitResult.SHED


@dataclasses.dataclass(frozen=True)
class PageQuota:
    """Per-``SLOClass`` share of the page pool (quota admission).

    ``reserved_frac`` is a floor: this fraction of the pool is kept
    admissible for the class even when every other class is hungry —
    other classes' fresh admissions may not eat into it.  ``ceiling_frac``
    is a burstable cap: the class may grow past its floor into idle
    capacity but never beyond the ceiling.  Fractions are of
    ``PageTable.n_pages``; floors across classes should sum to <= 1.
    """
    reserved_frac: float = 0.0
    ceiling_frac: float = 1.0

    def floor_pages(self, total: int) -> int:
        return int(math.ceil(self.reserved_frac * total - 1e-9))

    def ceiling_pages(self, total: int) -> int:
        return int(self.ceiling_frac * total + 1e-9)


# ------------------------------------------------------- admission policies
@dataclasses.dataclass(frozen=True)
class Pending:
    """One waiting request as an admission policy sees it — a neutral
    view both runtimes can build (the ``Scheduler`` from ``SeqState``,
    the discrete-event simulator from ``workload.Request``):

      ``order``     arrival rank within the queue (FCFS tie-break);
      ``priority``  SLO class priority (0 when classless);
      ``deadline``  absolute TTFT deadline (inf when classless);
      ``waited``    time waited so far, in the caller's clock units
                    (scheduler ticks or simulated seconds — aging knobs
                    are in the consumer's units).
    """
    order: int
    priority: int = 0
    deadline: float = math.inf
    waited: float = 0.0


class AdmissionPolicy:
    """FCFS baseline: admit in arrival order.  Subclasses override
    ``key``; the smallest key is admitted next.  Policies are stateless
    and shareable across every scheduler/instance of a cluster run.

    ``quotas`` (optional, per-``SLOClass``-name ``PageQuota``) adds a
    page-share check on FRESH admissions: a class over its burstable
    ceiling, or whose admission would eat into another class's reserved
    floor, is *skipped* this tick — not a hard failure, and class-local,
    so other classes behind it in the queue still admit.  Resumes and
    adoptions are exempt (their pages were already paid for before the
    handoff); each scheduler tracks its own per-class usage, the policy
    object only carries the configuration and the rule.
    """
    name = "fcfs"

    def __init__(self, quotas: Optional[Dict[str, PageQuota]] = None):
        self.quotas: Dict[str, PageQuota] = dict(quotas) if quotas else {}

    def key(self, p: Pending) -> Tuple:
        return (p.order,)

    def quota_blocked(self, cls: str, need: int,
                      used: Dict[str, int], total: int,
                      headroom: int) -> bool:
        """Would admitting ``need`` worst-case pages of class ``cls``
        violate the quota rule?  ``used`` is the caller's per-class
        pages charged, ``total`` the pool size, ``headroom`` the pages
        still reservable (``n_pages - n_reserved``)."""
        if not self.quotas:
            return False
        q = self.quotas.get(cls)
        if q is not None and used.get(cls, 0) + need \
                > q.ceiling_pages(total):
            return True                          # burstable ceiling
        # never dip into another class's unfilled reserved floor
        owed = sum(max(qc.floor_pages(total) - used.get(c, 0), 0)
                   for c, qc in self.quotas.items() if c != cls)
        return headroom - need < owed

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


class EDFPolicy(AdmissionPolicy):
    """Earliest-deadline-first over the absolute TTFT deadline carried
    by each request's ``SLOClass``; classless requests (deadline inf)
    fall back to FCFS order among themselves, behind any deadline."""
    name = "edf"

    def key(self, p: Pending) -> Tuple:
        return (p.deadline, p.order)


class StrictPriorityPolicy(AdmissionPolicy):
    """Highest class priority first, with aging: a request's effective
    priority grows by one level per ``aging`` units waited, so a
    low-class request outranks fresh high-class arrivals after at most
    ``(max_priority - priority) * aging`` waiting — the starvation bound
    the property tests assert.  ``aging=inf`` is pure strict priority."""
    name = "priority"

    def __init__(self, aging: float = math.inf,
                 quotas: Optional[Dict[str, PageQuota]] = None):
        super().__init__(quotas)
        assert aging > 0
        self.aging = aging

    def key(self, p: Pending) -> Tuple:
        eff = p.priority + (p.waited / self.aging
                            if math.isfinite(self.aging) else 0.0)
        return (-eff, p.order)

    def __repr__(self) -> str:
        return f"StrictPriorityPolicy(aging={self.aging})"


ADMISSION_POLICIES = {"fcfs": AdmissionPolicy, "edf": EDFPolicy,
                      "priority": StrictPriorityPolicy}


# -------------------------------------------------------------- sequences
class SlotState(enum.Enum):
    FREE = "free"
    PREFILL = "prefill"
    DECODE = "decode"


@dataclasses.dataclass
class SeqState:
    """One in-flight request: everything needed to continue it anywhere.

    ``prompt`` and ``generated`` are plain int lists so the state can be
    handed between instances (mode switch) without touching device
    buffers; the owning engine keeps the device-side cache per slot.
    """
    req_id: int
    prompt: List[int]
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)
    eos_id: Optional[int] = None
    # set once at FIRST submission and preserved across handoffs — a
    # never-prefilled sequence re-submitted on the adopting instance
    # keeps its original queueing delay (TTFT would otherwise under-
    # report exactly the mode-switch path the paper measures)
    submit_tick: Optional[int] = None
    first_token_tick: Optional[int] = None
    t_arrive: Optional[float] = None     # simulated-clock arrival (metrics)
    slo: Optional["SLOClass"] = None     # service class (control plane)
    handoffs: int = 0
    # prompt tokens resolved from the prefix cache at admission
    # (``PageTable.bind``): the engine's prefill skips exactly these and
    # runs only the suffix through the model
    shared_tokens: int = 0
    # health-check traffic: runs like any request but does not count as
    # *activity* — the autoscaler's keep-alive clock ignores probe-only
    # replicas so a parked model's prober can't hold it at one replica
    probe: bool = False

    @property
    def deadline(self) -> float:
        """Absolute TTFT deadline on the simulated clock; inf when the
        request carries no SLO class (or arrived outside a timed replay,
        where no clock anchors the deadline)."""
        if self.slo is None or self.t_arrive is None:
            return math.inf
        return self.t_arrive + self.slo.ttft_deadline

    @property
    def priority(self) -> int:
        return self.slo.priority if self.slo is not None else 0

    @property
    def pos(self) -> int:
        """Next decode position = tokens processed so far."""
        return len(self.prompt) + len(self.generated)

    @property
    def total_tokens(self) -> int:
        """Worst-case KV footprint (prompt + full generation budget) —
        what page-aware admission reserves so a live sequence can never
        hit pool exhaustion mid-decode."""
        return len(self.prompt) + self.max_new_tokens

    @property
    def tokens_so_far(self) -> List[int]:
        return self.prompt + self.generated

    @property
    def finished(self) -> bool:
        if len(self.generated) >= self.max_new_tokens:
            return True
        return (self.eos_id is not None and self.generated
                and self.generated[-1] == self.eos_id)


@dataclasses.dataclass
class Tick:
    """One scheduling round, executed by an engine.

    ``admit``: (slot, seq) pairs to prefill this round.
    ``decode``: slots holding live sequences to advance one token.
    ``resume``: (slot, seq) handed-off sequences entering DECODE this
    round — the engine must restore their caches before decoding.
    """
    admit: List[Tuple[int, SeqState]]
    decode: List[int]
    resume: List[Tuple[int, SeqState]] = dataclasses.field(
        default_factory=list)

    @property
    def idle(self) -> bool:
        return not self.admit and not self.decode and not self.resume


# -------------------------------------------------------------- scheduler
class SchedulerStats(dict):
    """Counter mapping that doubles as a snapshot factory.

    Every existing call site subscripts the counters directly
    (``stats["admitted"]``) and keeps working; *calling* the object
    (``stats()``) returns a copy extended with live page-pool occupancy
    (``pages_total`` / ``pages_live`` / ``pages_free`` / ``pages_held``)
    whenever the scheduler admits against a ``PageTable`` — the surface
    the autoscaler's page-pressure signal reads.
    """

    def __init__(self, sched: "Scheduler", counters: Dict[str, int]):
        super().__init__(counters)
        self._sched = sched

    def __call__(self) -> Dict[str, float]:
        snap: Dict[str, float] = dict(self)
        if self._sched.pages is not None:
            snap.update(self._sched.pages.occupancy())
        return snap


class Scheduler:
    """Continuous batching over a fixed slot pool.

    Admission order is the pluggable ``policy`` (FCFS default); bounded
    prefills per tick (``max_prefill_per_tick``) mean a queue of new
    arrivals cannot starve decode of in-flight sequences — each tick
    advances every live slot by one token *and* admits at most a few
    newcomers, the policy deciding *which* newcomers.
    """

    def __init__(self, n_slots: int = DEFAULT_SLOTS, *,
                 max_prefill_per_tick: int = MAX_PREFILL_PER_TICK,
                 pages: Optional["PageTable"] = None,
                 policy: Optional[AdmissionPolicy] = None,
                 role: str = "unified",
                 shed_limit: Optional[int] = None):
        if role not in ROLES:
            raise ValueError(f"unknown scheduler role {role!r}; "
                             f"expected one of {ROLES}")
        self.n_slots = n_slots
        self.max_prefill_per_tick = max_prefill_per_tick
        self.policy = policy or AdmissionPolicy()
        self.role = role
        # load shedding: reject a fresh submit outright once this many
        # same-or-higher-priority requests are already queued (None =
        # never shed, the historical behavior).  The bound is per class
        # level, so a deep batch backlog never triggers sheds of
        # interactive arrivals that would jump it anyway.
        self.shed_limit = shed_limit
        # paged-KV admission control: a sequence is only admitted (or
        # resumed) when its worst-case page demand fits beside every
        # outstanding reservation; slots release their pages on retire
        self.pages = pages
        self.slots: List[Optional[SeqState]] = [None] * n_slots
        self.state: List[SlotState] = [SlotState.FREE] * n_slots
        self.queue: List[SeqState] = []
        self.resume_queue: List[SeqState] = []
        self.draining = False
        self.tick_count = 0
        self.finished: Dict[int, SeqState] = {}
        # per-class worst-case pages charged to occupied slots (quota
        # admission accounting); _slot_quota remembers each slot's
        # (class, pages) charge so every release path decrements exactly
        self._class_pages: Dict[str, int] = {}
        self._slot_quota: List[Optional[Tuple[str, int]]] = \
            [None] * n_slots
        self.stats = SchedulerStats(self, {
            "prefills": 0, "decode_ticks": 0, "decode_tokens": 0,
            "admitted": 0, "retired": 0, "adopted": 0,
            "prefill_tokens": 0, "shared_tokens": 0, "exported": 0,
            "shed": 0, "preempted": 0})

    # ------------------------------------------------------- role sizing
    def admit_tokens(self, seq: SeqState) -> int:
        """Worst-case token footprint admission reserves for ``seq``.
        A prefill-role slot only ever holds the prompt's KV (the slot is
        exported before any decode step appends), so it is sized by
        prompt pages; decode/unified slots carry the prompt plus the
        full generation budget."""
        if self.role == "prefill":
            return len(seq.prompt)
        return seq.total_tokens

    # ------------------------------------------------------------- intake
    def submit(self, seq: SeqState) -> SubmitResult:
        if self.role == "decode":
            raise RuntimeError(
                "decode-role instance takes prefilled work only — route "
                "prompts through a prefill-role (or unified) instance")
        if self.draining:
            raise RuntimeError("draining instance admits no new requests")
        if self.shed_limit is not None:
            ahead = sum(1 for s in self.queue
                        if s.priority >= seq.priority)
            if ahead >= self.shed_limit:
                self.stats["shed"] += 1
                # back-off hint: ticks until the same-or-higher backlog
                # plausibly drains one slot's worth of headroom — the
                # queue ahead plus the slots it must wait to free
                retry = float(max(1, ahead + self.in_flight
                                  - self.n_slots + 1))
                return SubmitResult(
                    SubmitResult.SHED, retry_after=retry,
                    reason=f"{ahead} same-or-higher-priority queued "
                           f">= shed_limit {self.shed_limit}")
        if seq.submit_tick is None:
            seq.submit_tick = self.tick_count
        self.queue.append(seq)
        return SubmitResult(SubmitResult.OK)

    def adopt(self, seq: SeqState, slot: int) -> None:
        """Place a handed-off sequence directly into DECODE (mode switch):
        its prefill already ran on the draining instance and is not
        re-entered here."""
        if self.role == "prefill":
            raise RuntimeError(
                "prefill-role instance runs prompt passes only — adopt "
                "into a decode-role (or unified) instance")
        assert self.state[slot] is SlotState.FREE
        seq.handoffs += 1
        self.slots[slot] = seq
        self.state[slot] = SlotState.DECODE
        if self.pages is not None:
            self.pages.reserve(slot, self.admit_tokens(seq))
        self._quota_charge(slot, seq)
        self.stats["adopted"] += 1

    def enqueue_resume(self, seq: SeqState) -> None:
        """Queue a handed-off mid-generation sequence for adoption when a
        slot frees up.  Unlike ``submit``, it will enter DECODE directly
        (``Tick.resume``) — its prefill is never re-run — but unlike
        ``adopt`` it does not require a slot to be free right now (a
        multi-pipeline mode switch can hand off more live sequences than
        one replica has free slots)."""
        if self.role == "prefill":
            raise RuntimeError(
                "prefill-role instance runs prompt passes only — resume "
                "on a decode-role (or unified) instance")
        if self.draining:
            raise RuntimeError("draining instance admits no new requests")
        self.resume_queue.append(seq)

    # ----------------------------------------------------- policy ordering
    def policy_key(self, seq: SeqState, order: int) -> Tuple:
        """The admission policy's sort key for ``seq`` at this tick.
        Waiting time is measured in scheduler ticks (the only clock the
        scheduler owns); deadlines ride on the sequence itself.
        ``submit_tick`` is preserved across handoffs for TTFT accounting
        and belongs to the SOURCE scheduler's clock, so it can exceed
        this scheduler's ``tick_count`` — clamp to zero rather than let
        a negative wait rank a handed-off sequence below fresh arrivals
        (aging restarts at adoption; it never goes backwards)."""
        waited = max(0, self.tick_count - (seq.submit_tick
                                           if seq.submit_tick is not None
                                           else self.tick_count))
        return self.policy.key(Pending(order, seq.priority,
                                       seq.deadline, waited))

    def _pick(self, queue: List[SeqState]) -> int:
        """Index of the sequence the policy admits next (queue list
        order is arrival order, so the index doubles as the FCFS rank)."""
        if len(queue) <= 1:
            return 0
        return min(range(len(queue)),
                   key=lambda i: self.policy_key(queue[i], i))

    # ---------------------------------------------------- page quotas
    @staticmethod
    def _cls_name(seq: SeqState) -> str:
        return seq.slo.name if seq.slo is not None else ""

    def _need_pages(self, seq: SeqState) -> int:
        """Worst-case pages ``seq`` charges against its class quota —
        the full reservation, deliberately ignoring prefix sharing (a
        shared page can unshare under CoW, so the quota holds the class
        to what it could end up owning)."""
        assert self.pages is not None
        ps = self.pages.page_size
        return -(-self.admit_tokens(seq) // ps)

    def _quota_blocked(self, seq: SeqState) -> bool:
        """Class-local quota veto for a FRESH admission (resumes are
        exempt — their pages were paid for before the handoff)."""
        if self.pages is None or not self.policy.quotas:
            return False
        return self.policy.quota_blocked(
            self._cls_name(seq), self._need_pages(seq),
            self._class_pages, self.pages.n_pages,
            self.pages.n_pages - self.pages.n_reserved)

    def _quota_charge(self, slot: int, seq: SeqState) -> None:
        if self.pages is None or not self.policy.quotas:
            return
        cls, n = self._cls_name(seq), self._need_pages(seq)
        self._slot_quota[slot] = (cls, n)
        self._class_pages[cls] = self._class_pages.get(cls, 0) + n

    def _quota_release(self, slot: int) -> None:
        charge = self._slot_quota[slot]
        if charge is None:
            return
        cls, n = charge
        self._slot_quota[slot] = None
        left = self._class_pages.get(cls, 0) - n
        if left > 0:
            self._class_pages[cls] = left
        else:
            self._class_pages.pop(cls, None)

    # ------------------------------------------------------------ tick
    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.state) if s is SlotState.FREE]

    def live_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.state)
                if s is SlotState.DECODE]

    def next_tick(self) -> Tick:
        """Plan one round: retire finished, refill freed slots, decode."""
        self.tick_count += 1
        self._retire_finished()
        resume: List[Tuple[int, SeqState]] = []
        admit: List[Tuple[int, SeqState]] = []
        if not self.draining:
            # handed-off sequences outrank fresh admissions: they already
            # spent prefill compute elsewhere and resume in DECODE.  One
            # that finished *while parked* (its last handed-off token was
            # EOS) retires directly — placing it in DECODE would advance
            # it one token past its stop token.
            for seq in [s for s in self.resume_queue if s.finished]:
                self.resume_queue.remove(seq)
                self.finished[seq.req_id] = seq
                self.stats["retired"] += 1
            for slot in self.free_slots():
                if not self.resume_queue:
                    break
                qi = self._pick(self.resume_queue)
                if self.pages is not None and not self.pages.can_admit(
                        self.admit_tokens(self.resume_queue[qi])):
                    break                    # pages free up as slots retire
                seq = self.resume_queue.pop(qi)
                self.adopt(seq, slot)
                resume.append((slot, seq))
            for slot in self.free_slots():
                if not self.queue or len(admit) >= self.max_prefill_per_tick:
                    break
                # a quota-blocked candidate is SKIPPED, not a head-of-
                # line block: the veto is class-specific, so requests of
                # other classes behind it must still admit this tick
                order = sorted(range(len(self.queue)),
                               key=lambda i: self.policy_key(
                                   self.queue[i], i))
                qi = next((i for i in order
                           if not self._quota_blocked(self.queue[i])),
                          None)
                if qi is None:
                    break        # every queued class over its quota
                # with a prefix index attached, admission charges only
                # the INCREMENTAL worst-case pages (shared prefix pages
                # already live cost nothing)
                if self.pages is not None and not self.pages.can_admit(
                        self.admit_tokens(self.queue[qi]),
                        prompt=self.queue[qi].prompt):
                    break        # the policy's head blocks: no size bypass
                seq = self.queue.pop(qi)
                self.slots[slot] = seq
                self.state[slot] = SlotState.PREFILL
                if self.pages is not None:
                    # bind = attach the longest cached prefix run (CoW
                    # share) + reserve the worst case; plain reserve
                    # when no prefix index is attached
                    seq.shared_tokens = self.pages.bind(
                        slot, seq.prompt, self.admit_tokens(seq))
                self._quota_charge(slot, seq)
                admit.append((slot, seq))
                self.stats["admitted"] += 1
                self.stats["prefill_tokens"] += (len(seq.prompt)
                                                 - seq.shared_tokens)
                self.stats["shared_tokens"] += seq.shared_tokens
        # a prefill-role instance never advances decode: its prefilled
        # slots sit in DECODE awaiting export over the PackedKV wire
        decode = [] if self.role == "prefill" else self.live_slots()
        if decode:
            self.stats["decode_ticks"] += 1
            self.stats["decode_tokens"] += len(decode)
        self.stats["prefills"] += len(admit)
        return Tick(admit=admit, decode=decode, resume=resume)

    # ----------------------------------------------------- engine feedback
    def on_prefilled(self, slot: int, first_token: int) -> None:
        """Engine reports the prefill of ``slot`` produced its first
        token; the sequence joins the decode batch next tick."""
        seq = self.slots[slot]
        assert seq is not None and self.state[slot] is SlotState.PREFILL
        seq.generated.append(first_token)
        if seq.first_token_tick is None:
            seq.first_token_tick = self.tick_count
        self.state[slot] = SlotState.DECODE

    def on_decoded(self, slot: int, token: int) -> None:
        seq = self.slots[slot]
        assert seq is not None and self.state[slot] is SlotState.DECODE
        seq.generated.append(token)

    def _retire_finished(self) -> None:
        for i, seq in enumerate(self.slots):
            if seq is not None and seq.finished:
                self.finished[seq.req_id] = seq
                self.slots[i] = None
                self.state[i] = SlotState.FREE
                if self.pages is not None:
                    self.pages.release(i)
                self._quota_release(i)
                self.stats["retired"] += 1

    # ------------------------------------------------------- preemption
    def pick_victims(self, pages_needed: int,
                     requester_slo: Optional["SLOClass"] = None, *,
                     need_slot: bool = False) -> List[int]:
        """Victim slots whose release covers ``pages_needed`` worst-case
        pages for a requester of class ``requester_slo`` — or ``[]``
        when no adequate victim set exists (partial preemption frees
        pages without unblocking the requester, so it sheds live work
        for nothing and is never proposed).

        Eligibility: DECODE-state slots strictly BELOW the requester's
        class priority (never preempt same-or-higher class) that have
        produced at least one token (a mid-prefill slot has no device
        state worth packing).  Ordering is lowest priority first, then
        latest deadline (most slack loses first), then fewest lost
        pages (``PageTable.slot_claim``), then slot index — fully
        deterministic.  ``need_slot`` forces at least one victim even
        when ``pages_needed <= 0`` (the requester is slot-starved, not
        page-starved)."""
        pri = requester_slo.priority if requester_slo is not None else 0
        if self.pages is None or (pages_needed <= 0 and not need_slot):
            return []
        cands = [i for i in self.live_slots()
                 if self.slots[i] is not None
                 and not self.slots[i].finished
                 and self.slots[i].generated
                 and self.slots[i].priority < pri]
        cands.sort(key=lambda i: (self.slots[i].priority,
                                  -self.slots[i].deadline,
                                  self.pages.slot_claim(i), i))
        victims: List[int] = []
        got = 0
        for i in cands:
            victims.append(i)
            got += self.pages.slot_claim(i)
            if got >= pages_needed:
                break
        if got < pages_needed:
            return []
        return victims

    def preempt(self, slot: int) -> SeqState:
        """Evict the live sequence in ``slot`` (the engine has already
        packed its pages over the PackedKV wire): the slot frees, its
        pages/reservation release (CoW sharers keep their references),
        and the sequence is returned for parking — it re-enters later
        through ``enqueue_resume``/``adopt`` exactly like a mode-switch
        handoff, so its tokens stay bit-equal."""
        seq = self.slots[slot]
        assert seq is not None and self.state[slot] is SlotState.DECODE \
            and not seq.finished, \
            (slot, "preempt needs a live (unfinished) DECODE slot")
        self.slots[slot] = None
        self.state[slot] = SlotState.FREE
        if self.pages is not None:
            self.pages.release(slot)
        self._quota_release(slot)
        self.stats["preempted"] += 1
        return seq

    # ----------------------------------------------------- disagg export
    def prefilled_slots(self) -> List[int]:
        """Slots whose prompt pass is done (DECODE state, unfinished) —
        what a prefill-role instance has ready to stream out."""
        return [i for i, s in enumerate(self.state)
                if s is SlotState.DECODE and self.slots[i] is not None
                and not self.slots[i].finished]

    def export_slot(self, slot: int) -> SeqState:
        """Release ``slot`` after its sequence was packed onto the wire
        (the steady-state prefill → decode stream, not a drain): the
        slot and its pages free immediately so the next prompt can be
        admitted.  The sequence does NOT retire here — it continues on
        the adopting decode-role instance."""
        seq = self.slots[slot]
        assert seq is not None and self.state[slot] is SlotState.DECODE, \
            (slot, "export needs a prefilled (DECODE-state) slot")
        self.slots[slot] = None
        self.state[slot] = SlotState.FREE
        if self.pages is not None:
            self.pages.release(slot)
        self._quota_release(slot)
        self.stats["exported"] += 1
        return seq

    # --------------------------------------------------------- mode switch
    def drain(self) -> None:
        """Stop admitting; in-flight sequences keep decoding until handed
        off (or until they finish on this instance)."""
        self.draining = True

    def handoff(self) -> List[SeqState]:
        """Export live slot state for adoption by another instance.

        Returns every in-flight sequence (queued-but-unstarted ones are
        included last — they carry no cache and simply re-queue).  Each
        segment is ordered by the admission policy: the adopting
        instance places sequences into free slots in list order, so the
        policy decides who resumes decoding first and who parks when
        the adopter is short on slots (FCFS keeps slot/queue order).
        The slots are freed; this instance can be torn down once the
        caller has adopted the sequences."""
        self._retire_finished()      # completed-but-unretired stay here
        out: List[SeqState] = []
        for i, seq in enumerate(self.slots):
            if seq is not None and not seq.finished:
                out.append(seq)
            self.slots[i] = None
            self.state[i] = SlotState.FREE
            if self.pages is not None:
                self.pages.release(i)    # engine packed live pages already
            self._quota_release(i)
        out = self.handoff_order(out)
        out.extend(self.handoff_order(self.resume_queue))
        self.resume_queue = []
        out.extend(self.handoff_order(self.queue))
        self.queue = []
        return out

    def handoff_order(self, seqs: List[SeqState]) -> List[SeqState]:
        """Policy-ordered view of ``seqs`` (stable: FCFS is identity)."""
        return [seqs[i] for i in
                sorted(range(len(seqs)),
                       key=lambda i: self.policy_key(seqs[i], i))]

    # ------------------------------------------------------------- status
    @property
    def pending(self) -> int:
        return len(self.queue) + len(self.resume_queue)

    @property
    def in_flight(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    @property
    def done(self) -> bool:
        return not self.queue and not self.resume_queue \
            and self.in_flight == 0

    @property
    def has_active(self) -> bool:
        """Any NON-probe work anywhere on the instance.  The activity
        half of the liveness/activity split: ``done`` (liveness) says
        whether the replica can be torn down right now, ``has_active``
        says whether real traffic should reset its keep-alive window —
        probe requests keep a replica live without keeping it *busy*."""
        return any(s is not None and not s.probe for s in self.slots) \
            or any(not s.probe for s in self.queue) \
            or any(not s.probe for s in self.resume_queue)
