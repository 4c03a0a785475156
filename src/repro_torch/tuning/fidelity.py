"""Fidelity-aware measurement statistics + ASHA back-compat shim.

The ASHA ``RungScheduler`` that used to live here moved to
``repro_torch.tuning.schedulers.asha`` when the scheduler seam was extracted
(see that package: HyperBand and PBT now share its driver).  The
historical import path is kept working as a plain re-export:

    from repro_torch.tuning.fidelity import RungScheduler   # still fine

What *lives* here is the fidelity-keyed completion-time bookkeeping the
remote pool uses for straggler detection — ``StreamingQuantiles`` and
``CompletionStats`` — which is about measurements, not scheduling
policy.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional


class StreamingQuantiles:
    """Bounded-memory quantile tracker for completion times.

    Keeps the most recent ``max_samples`` observations in a ring buffer
    and answers quantile queries from a sorted copy — O(n log n) on a
    few hundred floats, called a few times per second at most.  Recency
    weighting is deliberate: a fleet's speed changes when workers join
    or leave, and stale samples from a departed slow host must not keep
    inflating the straggler threshold forever.

    Thread-safe: the remote pool's read loops ``add`` from one thread
    per worker while the monitor loop queries.
    """

    def __init__(self, max_samples: int = 256):
        self._max = max(8, int(max_samples))
        self._ring: List[float] = []
        self._next = 0
        self._count = 0  # lifetime observation count (never decays)
        self._lock = threading.Lock()

    def add(self, x: float) -> None:
        x = float(x)
        if not math.isfinite(x) or x < 0.0:
            return
        with self._lock:
            if len(self._ring) < self._max:
                self._ring.append(x)
            else:
                self._ring[self._next] = x
                self._next = (self._next + 1) % self._max
            self._count += 1

    @property
    def n(self) -> int:
        """Lifetime observations (not just the retained window)."""
        return self._count

    def quantile(self, q: float) -> Optional[float]:
        """q-quantile of the retained window (nearest-rank), or ``None``
        with no observations."""
        with self._lock:
            if not self._ring:
                return None
            s = sorted(self._ring)
        q = min(1.0, max(0.0, float(q)))
        idx = min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))
        return s[idx]

    def p50(self) -> Optional[float]:
        return self.quantile(0.50)

    def p95(self) -> Optional[float]:
        return self.quantile(0.95)


class CompletionStats:
    """Per-rung observed completion times for straggler detection.

    Rungs are keyed by their fidelity (the ladder maps rung <-> fidelity
    one-to-one, and fidelity is what actually crosses the wire to the
    measurement workers), so the remote pool can record without knowing
    scheduler internals.  ``None`` fidelity — the single-fidelity path —
    gets its own bucket.
    """

    def __init__(self, max_samples: int = 256):
        self._max_samples = max_samples
        self._by_key: Dict[float, StreamingQuantiles] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _key(fidelity: Optional[float]) -> float:
        return 1.0 if fidelity is None else round(float(fidelity), 9)

    def _bucket(self, fidelity: Optional[float]) -> StreamingQuantiles:
        key = self._key(fidelity)
        with self._lock:
            q = self._by_key.get(key)
            if q is None:
                q = self._by_key[key] = StreamingQuantiles(self._max_samples)
            return q

    def record(self, fidelity: Optional[float], seconds: float) -> None:
        self._bucket(fidelity).add(seconds)

    def observations(self, fidelity: Optional[float]) -> int:
        key = self._key(fidelity)
        with self._lock:
            q = self._by_key.get(key)
        return 0 if q is None else q.n

    def p50(self, fidelity: Optional[float]) -> Optional[float]:
        key = self._key(fidelity)
        with self._lock:
            q = self._by_key.get(key)
        return None if q is None else q.p50()

    def p95(self, fidelity: Optional[float]) -> Optional[float]:
        key = self._key(fidelity)
        with self._lock:
            q = self._by_key.get(key)
        return None if q is None else q.p95()

    def snapshot(self) -> List[dict]:
        """JSON-able per-rung summary (fleet_health / bench artifacts)."""
        with self._lock:
            items = sorted(self._by_key.items())
        return [{"fidelity": k, "n": q.n,
                 "p50": q.p50(), "p95": q.p95()} for k, q in items]


# back-compat: the ASHA scheduler moved behind the TrialScheduler seam
from repro_torch.tuning.schedulers.asha import RungScheduler, RungState  # noqa: E402

__all__ = ["CompletionStats", "RungScheduler", "RungState",
           "StreamingQuantiles"]
