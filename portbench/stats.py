"""Percentile and spread arithmetic of the benchmark.

``percentile`` is a frozen copy of ``percentile`` in the port's
``serving/metrics.py`` (nearest rank); the times it is given come from the
card, never from a simulated clock.  ``spread`` is the benchmark's measure
of run-to-run noise: the distance between the first and third quartile of
``statistics.quantiles(values, n=4)``, as a share of the median.
"""
from __future__ import annotations

import math
import statistics
from typing import Sequence


def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least ``q``
    percent of the values at or below it.  NaN for no values."""
    ss = sorted(xs)
    if not ss:
        return float("nan")
    i = min(len(ss) - 1, max(0, int(math.ceil(q / 100 * len(ss))) - 1))
    return ss[i]


def spread(values: Sequence[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
