"""The percentile the benchmark's tails use."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """Nearest-rank ``q``-th percentile (0 < q <= 100); a missing value
    is ``inf`` and sorts last."""
    xs = sorted(values)
    if not xs:
        return math.nan
    return xs[max(0, math.ceil(q / 100 * len(xs)) - 1)]

