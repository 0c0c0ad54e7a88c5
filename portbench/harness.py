"""One run of one cell: set-up, the measured window, the metrics and the
check that decides ``correct``.

Everything a cell is made of is found by name: the cell and its metrics in
``BENCHMARK.json``, the configuration in the file it names, the traffic mix
in ``portbench/traffic/<mix>.json``, the correctness limits in
``portbench/limits/<cell>.json`` and each metric's reader in
``portbench/metrics/<metric>.py``.  A new cell, mix, configuration or metric
is new files and new entries.

The system under test is the port's ``ContinuousBatchingEngine`` (paged KV
cache in a pool of the configuration's ``n_pages``, the prefix cache on as
the engine has it by default; its decode tick and prefills replayed as CUDA
graphs).  The harness submits requests at their due times (open loop) or as
clients' previous requests finish (closed loop) and calls ``step()`` in a
loop.  After every step it records a CUDA event; a token's time is the
device completion of the step that produced it, read after the window
against one anchor taken at a ``synchronize``.  No other synchronisation is
added.  A traced run (``--trace 1``) also wraps the engine's decode tick and
prefill step (``_decode_tick``, ``_prefill_step``) in CUDA events and
profiler ranges, and profiles a steady stretch in the middle of the window.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from portbench import gen
from portbench import reference as references
from portbench import trace as tracing

# what the process may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# kernels the cells' engines launch, built before the weights are made
KERNEL_SOURCES = ("paged_decode_step", "flash_attention")
# seconds of the traced run's profiled stretch, the last of the window (the
# profiler's stop reads its events back, which takes long: it runs after
# the window has closed)
PROFILE_S = 2.5


@dataclasses.dataclass
class Spec:
    cell: Dict
    conf: Dict
    mix: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load_spec(root: Path, workload: str) -> Spec:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    read = lambda p: json.loads(Path(p).read_text())           # noqa: E731
    mine = lambda m: workload in m.get("workloads", [workload])  # noqa: E731
    return Spec(cell, read(root / entry["file"]),
                read(root / "portbench" / "traffic" / f"{cell['traffic']}.json"),
                read(root / "portbench" / "limits" / f"{workload}.json"),
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)])


def metric_reader(root: Path, name: str):
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def model_config(conf: Dict):
    from repro_torch.configs.base import ModelConfig
    prog = dict(conf["program"])
    prog["layer_pattern"] = tuple(prog["layer_pattern"])
    return ModelConfig(**prog)


class Timeline:
    """Marks on the device's stream (CUDA events), or host times on the
    CPU, read against one anchor after the window."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: List[Any] = []
        self.t_anchor = 0.0

    def anchor(self, t_window: float) -> None:
        """Start timing; ``t_window`` is the host time the window opens."""
        if self.cuda:
            torch.cuda.synchronize()
            self._anchor = torch.cuda.Event(enable_timing=True)
            self._anchor.record()
        self.t_anchor = time.perf_counter()
        self.t_window = t_window

    def mark(self) -> int:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())
        return len(self.marks) - 1

    def times(self) -> List[float]:
        """Every mark in seconds from the window's start."""
        if self.cuda:
            torch.cuda.synchronize()
            off = self.t_anchor - self.t_window
            return [off + self._anchor.elapsed_time(e) / 1e3
                    for e in self.marks]
        return [t - self.t_window for t in self.marks]

    def span_ms(self, a: int, b: int) -> float:
        if self.cuda:
            return self.marks[a].elapsed_time(self.marks[b])
        return (self.marks[b] - self.marks[a]) * 1e3


@dataclasses.dataclass
class Rec:
    """One traffic request as the harness saw it."""
    req: gen.Req
    seq: Any                        # the scheduler's SeqState
    submit_t: float
    ticks: List[Optional[int]] = dataclasses.field(default_factory=list)
    failed: bool = False
    client: Optional[int] = None     # closed loop: the client that sent it
    slot: Optional[int] = None       # the slot that served it


class Run:
    """State of one run; the metric readers read its attributes."""

    def __init__(self, spec: Spec, seed: int, seconds: float, trace: bool,
                 device: torch.device, t_process: float):
        self.spec, self.seed, self.seconds, self.trace = (spec, seed,
                                                          seconds, trace)
        self.device, self.t_process = device, t_process
        self.mix = spec.mix
        self.cfg = model_config(spec.conf)
        self.n_slots = spec.conf["engine"]["n_slots"]
        self.page_size = spec.conf["engine"]["page_size"]
        self.timeline = Timeline(device)
        self.recs: List[Rec] = []
        self.inflight: Dict[int, Rec] = {}
        self.measuring = False
        self.profiling = False
        self.decode_spans: List[Dict] = []
        self.prefill_spans: List[Dict] = []
        self.queue_len: List[tuple] = []
        self.trace_out: Optional[Dict] = None
        self.peaks = None
        self.t_window = math.inf

    # ------------------------------------------------------------- clock
    def now(self) -> float:
        """Host seconds from the window's start (negative before it)."""
        return time.perf_counter() - self.t_window

    # ------------------------------------------------------------ intake
    def submit(self, req: gen.Req, client: Optional[int] = None) -> Rec:
        t = self.now()
        try:
            rid = self.eng.submit(req.prompt, req.max_new)
        except ValueError:
            rec = Rec(req, None, t, failed=True, client=client)
            self.recs.append(rec)
            return rec
        seq = self.eng.sched.queue[-1]
        assert seq.req_id == rid
        rec = Rec(req, seq, t, client=client)
        self.recs.append(rec)
        self.inflight[rid] = rec
        return rec

    def step(self) -> bool:
        if not self.eng.step():
            return False
        tick = self.timeline.mark() if self.measuring else None
        closed = self.mix["loop"] == "closed"
        for rid, rec in list(self.inflight.items()):
            n = len(rec.seq.generated)
            if n and rec.slot is None:
                rec.slot = next((i for i, s in enumerate(self.eng.sched.slots)
                                 if s is rec.seq), None)
            if n > len(rec.ticks):
                rec.ticks += [tick] * (n - len(rec.ticks))
                if n >= rec.seq.max_new_tokens:
                    del self.inflight[rid]
                    if closed:
                        phase = "window" if self.now() >= 0 else "lead"
                        self.submit(self.traffic.next_closed(rec.client,
                                                             phase),
                                    rec.client)
        if self.measuring:
            self.queue_len.append((self.now(), len(self.eng.sched.queue)))
        return True

    def drain(self) -> None:
        """Step until the engine is idle (set-up only)."""
        while self.step():
            pass

    # ----------------------------------------------------------- set-up
    def phase(self, name: str) -> None:
        """Close the set-up phase that ran since the last call."""
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        self.phases[name] = t - self._t_phase
        self._t_phase = t

    def build(self) -> None:
        from repro_torch.serving.engine import ContinuousBatchingEngine
        self.phases: Dict[str, float] = {}
        self._t_phase = self.t_process
        if self.device.type == "cuda":
            torch.cuda.init()
            self.phase("start")
            from repro_torch.kernels import _build
            _build.build_all(list(KERNEL_SOURCES))
        self.phase("kernels")
        from portbench import weights
        self.params = weights.make(self.cfg, self.seed, self.device)
        self.phase("weights")
        eng = self.spec.conf["engine"]
        self.eng = ContinuousBatchingEngine(
            self.cfg, self.params, n_slots=self.n_slots,
            max_len=gen.max_len(self.mix), page_size=self.page_size,
            n_pages=eng["n_pages"],
            max_prefill_per_tick=eng["max_prefill_per_tick"])
        self.traffic = gen.Traffic(self.mix, self.seed, self.cfg.vocab_size,
                                   self.seconds)
        if self.trace:
            self._wrap()
        self.phase("engine")

    def _wrap(self) -> None:
        """Spans around the engine's decode tick and prefill step (private
        methods, wrapped by name: a missing one fails the run)."""
        eng, tl = self.eng, self.timeline
        decode, prefill, step = eng._decode_tick, eng._prefill_step, eng.step
        rf = torch.profiler.record_function

        def traced_step():
            with rf("pb.step"):
                return step()

        def decode_tick():
            ctx = [eng.sched.slots[s].pos for s in eng.sched.live_slots()]
            if not self.measuring or self.now() < 0:
                return decode()
            with rf("pb.decode_tick"):
                a = tl.mark()
                decode()
                b = tl.mark()
            self.decode_spans.append({"a": a, "b": b, "ctx": ctx,
                                      "prof": self.profiling})

        def prefill_step(kind, slot, toks):
            seq = eng.sched.slots[slot]
            start = seq.shared_tokens if kind == "suffix" else 0
            if not self.measuring or self.now() < 0:
                return prefill(kind, slot, toks)
            with rf("pb.prefill"):
                a = tl.mark()
                out = prefill(kind, slot, toks)
                b = tl.mark()
            self.prefill_spans.append({"a": a, "b": b, "kind": kind,
                                       "n": len(toks), "start": start,
                                       "prof": self.profiling})
            return out

        eng._decode_tick, eng._prefill_step = decode_tick, prefill_step
        eng.step = traced_step

    def warm_up(self) -> None:
        """Run every prefill bucket this cell's traffic reaches once (its
        eager pass and capture), and the decode tick."""
        from repro_torch.serving.engine import prefill_bucket
        mix, cap = self.mix, self.eng.max_len
        hi_fresh = gen.max_prompt(mix)
        if mix.get("warm_start"):
            hi_fresh += mix["output"]["max"] - 1
        lo = mix["prompt"]["min"] + (mix["prefix"]["tokens"]
                                     if "prefix" in mix else 0)
        hi_fresh = min(hi_fresh, cap - 2)

        def buckets(a, b):
            out, n = {}, a
            while n <= b:
                out.setdefault(prefill_bucket(n, cap), n)
                n = max(n + 1, 1 << n.bit_length())
            out.setdefault(prefill_bucket(b, cap), b)
            return out
        rid = 0
        for n in buckets(lo, hi_fresh).values():
            rid += 1
            self.eng.submit(self.traffic.tokens((4, rid), n), 2)
            self.drain()
        if "prefix" in mix:
            sys_p = self.traffic.system_prompt(0)
            for n in buckets(mix["prompt"]["min"], mix["prompt"]["max"]
                             ).values():
                rid += 1
                self.eng.submit(sys_p + self.traffic.tokens((4, rid), n), 2)
                self.drain()

    def prepare(self) -> None:
        """Set-up after the engine: warm-up, the tenants' system prompts,
        and the traffic's own lead-in (closed loop: every client's first request in flight;
        open loop: ``lead_in_s`` of arrivals, driven by ``window``)."""
        self.warm_up()
        if self.trace:
            tracing.warm(self)
        self.phase("warm_up")
        if "prefix" in self.mix:
            # every tenant's system prompt in the cache
            for k in range(self.mix["prefix"]["count"]):
                self.eng.submit(self.traffic.system_prompt(k)
                                + self.traffic.tokens((6, k), 16), 2)
            self.drain()
            self.phase("system_prompts")
        if self.mix["loop"] == "closed":
            for k in range(self.mix["clients"]):
                self.submit(self.traffic.next_closed(
                    k, "wave" if self.mix.get("warm_start") else "lead"), k)
            while self.eng.sched.queue:
                self.step()
            self.phase("first_wave")

    # ----------------------------------------------------------- window
    def window(self) -> None:
        lead = self.mix.get("lead_in_s", 0.0) if self.mix["loop"] == "open" \
            else 0.0
        # everything set-up made stays out of the window's collections
        gc.collect()
        gc.freeze()
        self.t_window = time.perf_counter() + lead
        self.timeline.anchor(self.t_window)
        self.measuring = True
        sched = self.traffic.schedule if self.mix["loop"] == "open" else []
        i = 0
        prof = None
        p0 = max(0.0, self.seconds - PROFILE_S)
        opened = False
        while True:
            now = self.now()
            if not opened and now >= 0:
                opened = True
                # a checkout's first run builds the kernels: that phase is
                # reported apart, in ``phases``, and not counted here
                self.setup_s = (time.perf_counter() - self.t_process
                                - self.phases["kernels"])
                self.stats_open = dict(self.eng.stats())
            while i < len(sched) and sched[i].due <= now:
                self.submit(sched[i])
                i += 1
            if self.trace and prof is None and now >= p0:
                prof = tracing.start(self)
            if now >= self.seconds:
                break
            if not self.step():
                nxt = sched[i].due if i < len(sched) else self.seconds
                wait = min(nxt, self.seconds) - self.now()
                if wait > 0:
                    with (torch.profiler.record_function("pb.wait")
                          if self.trace else contextlib.nullcontext()):
                        time.sleep(min(wait, 0.002))
        if self.profiling:
            tracing.stop(self, prof)
        self.stats_close = dict(self.eng.stats())
        prefix = self.eng.pages.prefix
        self.pool = {"pages": self.eng.n_pages,
                     "free_at_close": self.stats_close["pages_free"],
                     "evictions": prefix.stats["evictions"] if prefix else 0}
        self.measuring = False
        self.tick_t = self.timeline.times()

    # ---------------------------------------------------------- reading
    def token_times(self, rec: Rec) -> List[Optional[float]]:
        return [None if k is None else self.tick_t[k] for k in rec.ticks]

    def window_recs(self) -> List[Rec]:
        return [r for r in self.recs if r.req.phase == "window"]

    @staticmethod
    def unprofiled(spans: List[Dict]) -> List[Dict]:
        """Spans outside the profiled stretch: the profiler slows the
        host's launches, and these metrics time the steps as they run."""
        return [s for s in spans if not s["prof"]]

    def ms(self, span: Dict) -> float:
        return self.timeline.span_ms(span["a"], span["b"])


def _check_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, *, device: str = "cuda",
             t_process: Optional[float] = None, control: bool = False,
             mix_override: Optional[Dict] = None) -> Dict:
    """One run of ``workload``; returns the result line's object.
    ``control`` also reads the control's gaps (calibration only);
    ``mix_override`` replaces keys of the mix (the knee sweep only)."""
    from portbench import check
    t_process = time.perf_counter() if t_process is None else t_process
    spec = load_spec(root, workload)
    if mix_override:
        spec.mix = {**spec.mix, **mix_override}
    dev = torch.device(device)
    run = Run(spec, seed, seconds, trace, dev, t_process)
    run.build()
    run.prepare()
    run.window()
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    peaks = json.loads((root / "portbench" / "peaks.json").read_text())
    run.peaks = peaks.get(kind)
    mem = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
           else 0)
    metrics: Dict[str, Dict] = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        v = metric_reader(root, m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    attempted = len(run.window_recs())
    failed = sum(r.failed for r in run.recs)
    # the check: served tokens against the plain reference, after the
    # program's state is freed
    run.eng.flush()
    finished = [r for r in run.recs if r.seq is not None
                and len(r.seq.generated) >= r.seq.max_new_tokens]
    picked = check.sample(finished, spec.mix["check"]["requests"], seed)
    del run.eng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref_cls = references.load(spec.conf["reference"])
    t_ref = time.perf_counter()
    got = check.gaps(ref_cls(spec.conf["published"], run.params), picked,
                     spec.conf["published"]["vocab_size"],
                     ref_cls(spec.conf["published"], run.params, "fp8")
                     if control else None,
                     spec.mix.get("prefix", {}).get("tokens", 0))
    got["ref_s"] = time.perf_counter() - t_ref
    limit = spec.limits["max_gap"]
    compared = {"max_gap": {"value": got["max_gap"], "limit": limit},
                "served_tokens": {"value": got["tokens"],
                                  "limit": spec.limits["min_tokens"]},
                "bad_tokens": {"value": got["bad"], "limit": 0},
                "failed": {"value": failed, "limit": 0}}
    correct = (got["max_gap"] <= limit and got["bad"] == 0 and failed == 0
               and got["tokens"] >= spec.limits["min_tokens"]
               and attempted > 0)
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                      "kind": kind, "count": 1, "memory_peak_bytes": mem}}
    if trace and run.trace_out:
        out["device"]["busy_s"] = run.trace_out["busy_s"]
        out["device"]["window_s"] = run.trace_out["window_s"]
        out["breakdown"] = run.trace_out["breakdown"]
    out["run"] = {"setup_s": run.setup_s, "phases": run.phases,
                  "ref_s": got["ref_s"],
                  "sampled": got["requests"],
                  "control_gap": got.get("control_gap"),
                  "stats": {k: run.stats_close[k] - run.stats_open[k]
                            for k in ("prefills", "decode_ticks",
                                      "decode_tokens", "prefill_tokens",
                                      "shared_tokens")},
                  "backlog": _backlog(run), "pool": run.pool}
    if trace:
        out["run"]["decode_ms"] = {
            f"profiled={p}": float(np.mean(ms)) for p in (False, True)
            if (ms := [run.ms(d) for d in run.decode_spans if d["prof"] == p])}
    out["check"] = compared
    found = _check_modules()
    if found:
        raise ForbiddenModules(found)
    return out


def _backlog(run: Run) -> Dict[str, float]:
    """Queue length at the first and last quarter of the window (medians)."""
    q = [(t, n) for t, n in run.queue_len if 0 <= t < run.seconds]
    if not q:
        return {}
    a = [n for t, n in q if t < run.seconds / 4]
    b = [n for t, n in q if t >= 3 * run.seconds / 4]
    return {"first_quarter": float(np.median(a)) if a else 0.0,
            "last_quarter": float(np.median(b)) if b else 0.0}


class ForbiddenModules(RuntimeError):
    def __init__(self, found: List[str]):
        super().__init__("modules that no run may load: " + ", ".join(found))
        self.found = found
