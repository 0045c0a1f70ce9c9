"""Window statistics: rates, percentiles over every call, and the spread
of a metric over runs (``bounds.py``)."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values`` by linear
    interpolation between closest ranks."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def window_rate(units_per_call, window_s: float) -> float:
    """Units completed over the whole window's wall time (calls, resets
    and the gaps between them included): the sum of ``units_per_call`` over
    ``window_s``."""
    if window_s <= 0:
        raise ValueError("empty window")
    return sum(units_per_call) / window_s


def spread(values) -> float:
    """Distance between the first and third quartile over the median
    (``statistics.quantiles``' default method)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
