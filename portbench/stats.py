"""The window's arithmetic: percentiles of latencies and rates over the
window."""
from __future__ import annotations

from typing import Iterable

import numpy as np


def percentile(values: Iterable[float], q: float) -> float:
    """The ``q``-th percentile, linear between order statistics (numpy's
    default)."""
    v = np.asarray(list(values), dtype=np.float64)
    if v.size == 0:
        raise ValueError("no samples")
    return float(np.percentile(v, q))


def rate(count: float, seconds: float) -> float:
    """Work completed over the window's seconds."""
    if seconds <= 0:
        raise ValueError("an empty window")
    return count / seconds

