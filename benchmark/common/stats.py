"""Statistics of a run and of sets of runs."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """Nearest-rank ``q``-th percentile (0 < q <= 100) of every value; a
    missing value (a failed request) is ``math.inf`` and ranks last."""
    vals = sorted(values)
    if not vals:
        raise ValueError("no values")
    rank = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[rank - 1]


def latency_p95(latencies, n_failed: int) -> float:
    """95th percentile over every request: the completed ones' latencies
    and each failed one counted as missing (infinitely late)."""
    return percentile(list(latencies) + [math.inf] * int(n_failed), 95.0)


def spread(values) -> float:
    """Distance between the first and third quartile over the median
    (``statistics.quantiles``, exclusive method)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
