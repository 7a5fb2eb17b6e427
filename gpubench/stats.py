"""Small statistics shared by the metric readers."""

from __future__ import annotations

import math
from typing import Iterable, List, Optional


def percentile(xs: Iterable[float], q: float) -> Optional[float]:
    """The *q*-th percentile of *xs* by linear interpolation between
    order statistics (numpy's default); None for no samples."""
    v: List[float] = sorted(xs)
    if not v:
        return None
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
