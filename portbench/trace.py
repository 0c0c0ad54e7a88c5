"""The traced run's profiler: a stretch of the window under
``torch.profiler`` (host ranges and the device's kernels), reduced to the
device's busy time, kernel times by name and the idle gaps by what the host
was doing.

The arithmetic is that of ``chip_smoke.py``'s ``profile_call`` (device-side
events only, so a host operator's kernels are not counted twice), rewritten
to take the union of the kernels' intervals and to label each gap between
them by the innermost ``pb.*`` range the harness had open on the host at
the gap's middle (``pb.step``: the engine's scheduling and staging around
its launches; ``pb.decode_tick``, ``pb.prefill``: the launches themselves;
``pb.wait``: no request due; none: the harness's own loop).  The profiler
keeps its events in memory; nothing is written to disk.
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Tuple

import torch

TOP = 10
# a gap shorter than this lies between two kernels of one launch sequence
# (inside a replayed graph, or back-to-back launches): not labelled
SHORT_GAP_US = 20.0


def _activities(run):
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if run.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


def warm(run) -> None:
    """Start and stop the profiler once in set-up: its first start
    initialises the tracer, which must not happen inside the window."""
    from torch.profiler import profile
    with profile(activities=_activities(run)):
        torch.ones(1, device=run.device).add_(1)
        if run.device.type == "cuda":
            torch.cuda.synchronize()


def start(run):
    from torch.profiler import profile
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    prof = profile(activities=_activities(run))
    prof.start()
    run.profiling = True
    run.t_prof = time.perf_counter()
    return prof


def stop(run, prof) -> None:
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - run.t_prof
    prof.stop()
    run.profiling = False
    run.trace_out = reduce(prof.events(), wall)


def _on_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce(events, wall_s: float) -> Dict:
    """``events``: the profiler's events (times in microseconds)."""
    dev, host = [], []
    for e in events:
        tr = e.time_range
        if e.name.startswith("pb."):
            # the harness's ranges; newer profilers also mirror each one
            # onto the device's timeline, which is no device work
            if not _on_device(e):
                host.append((tr.start, tr.end, e.name))
        elif _on_device(e):
            dev.append((tr.start, tr.end, e.name))
    kernels: Dict[str, float] = {}
    for a, b, name in dev:
        kernels[name] = kernels.get(name, 0.0) + (b - a) / 1e6
    busy = _union([(a, b) for a, b, _ in dev])
    host.sort()
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        if s1 - e0 < SHORT_GAP_US:
            label = "between kernels, under 20 us"
        else:
            mid = (e0 + s1) / 2
            label = "harness"
            i = bisect.bisect_right(starts, mid)
            for h in reversed(host[max(0, i - 8):i]):
                if h[1] >= mid:           # the innermost open range
                    label = h[2]
                    break
        gaps[label] = gaps.get(label, 0.0) + (s1 - e0) / 1e6
    top = lambda d: [[k[:160], v] for k, v in                  # noqa: E731
                     sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"busy_s": sum(b - a for a, b in busy) / 1e6,
            "window_s": wall_s, "kernels": kernels,
            "breakdown": {"device_ops": top(kernels),
                          "idle_gaps": top(gaps)}}


def kernel_s(run, fragment: str):
    """Seconds the profiled stretch spent in kernels whose name holds
    ``fragment``; None when there is no trace or no such kernel."""
    if not run.trace_out:
        return None
    t = sum(v for k, v in run.trace_out["kernels"].items() if fragment in k)
    return t or None
