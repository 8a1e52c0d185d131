"""The arithmetic of the end-to-end metrics: percentiles and rates."""

from __future__ import annotations

import math


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile (0..100) of ``values``, interpolated linearly
    between the two order statistics around rank q / 100 * (n - 1) (numpy's
    default). Raises on an empty list."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    rank = q / 100.0 * (len(xs) - 1)
    lo, hi = math.floor(rank), math.ceil(rank)
    return xs[lo] + (xs[hi] - xs[lo]) * (rank - lo)


def rate(amount: float, seconds: float) -> float:
    """``amount`` over ``seconds``, the whole window."""
    if seconds <= 0:
        raise ValueError("a rate over no time")
    return amount / seconds
