"""Percentiles, as ``numpy.percentile`` computes them by default (linear
interpolation between closest ranks), in plain Python. Copied from the
port's scheduler arithmetic (``runtime/scheduler.py`` ``_pct``) so that a
change to the program cannot move it."""

from __future__ import annotations

import math
from typing import Optional, Sequence


def percentile(xs: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile (0-100) of ``xs``; None for an empty sample."""
    if not xs:
        return None
    s = sorted(float(x) for x in xs)
    if len(s) == 1:
        return s[0]
    rank = (len(s) - 1) * q / 100.0
    lo = math.floor(rank)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (rank - lo)
