"""Percentiles over whole windows, with censored samples.

A request that has no first token when its wait is cut off is censored:
its latency is beyond every observed one. Such samples sort past every
finite value; a percentile that lands among them is reported as the
largest lower bound known for them (their censoring time), so a run
that loses requests reads high, never low.
"""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float,
               censored: Sequence[float] = ()) -> float:
    """The ``q``-th percentile (0–100, linear between closest ranks, as
    numpy's default) of ``values`` plus ``censored`` samples known only
    to exceed their given bounds. NaN when there is no sample."""
    finite = sorted(float(v) for v in values)
    n = len(finite) + len(censored)
    if n == 0:
        return math.nan
    pos = q / 100.0 * (n - 1)
    lo, hi = math.floor(pos), math.ceil(pos)
    if hi >= len(finite):
        # the rank reaches past the observed values
        bound = max(censored) if censored else finite[-1]
        return max(bound, finite[-1] if finite else bound)
    return finite[lo] + (finite[hi] - finite[lo]) * (pos - lo)
