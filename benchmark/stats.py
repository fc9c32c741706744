"""The arithmetic of the end-to-end and span metrics: a rate over a whole
window, the nearest-rank percentile of all samples, and the median."""

from __future__ import annotations

import math
from typing import Sequence


def rate(count: int, seconds: float) -> float:
    """All the work of the window over all of its time."""
    return count / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest rank: the smallest sample with at least ``q`` % of all the
    samples at or below it."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def median(values: Sequence[float]) -> float:
    v = sorted(values)
    n = len(v)
    return v[n // 2] if n % 2 else (v[n // 2 - 1] + v[n // 2]) / 2
