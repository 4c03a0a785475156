"""Evaluation history D = {(x_i, y_i)} (paper §2.2) + persistence.

The history is the single source of truth shared by every algorithm
engine (paper Fig. 4: common data-acquisition module).  It also implements
the paper's Table-2 analysis: per-parameter sampled-range coverage.

Asynchronous evaluation support: ``mark_inflight``/``clear_inflight``
track points handed to the parallel executor but not yet measured, so
engines never re-propose them (``pending``).  Under the
completion-driven tuner loop, completions arrive out of submission
order: ``add`` appends each result the moment it lands (evaluation
``index`` is completion order, not ask order) and atomically drops the
point's in-flight mark, so the pending set and the completed set stay
disjoint at every instant.  A checkpoint written mid-stream (``save``
persists completed evaluations only) is therefore always consistent —
resuming re-evaluates whatever was still in flight, and stale in-flight
marks never leak into a checkpoint.
"""
from __future__ import annotations

import json
import math
import pathlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.observation import Observation
from repro_torch.core.space import SearchSpace


@dataclass
class Evaluation:
    point: Dict
    value: float  # objective (throughput; higher is better)
    index: int
    cost_seconds: float = 0.0
    meta: dict = field(default_factory=dict)
    #: fraction of a full measurement this value came from (multi-fidelity
    #: tuning records partial measurements too; 1.0 = exact/full)
    fidelity: float = 1.0
    #: scheduler coordinate (ASHA rung / HyperBand global rung / PBT step)
    rung: Optional[int] = None
    #: trial ancestry (HyperBand bracket "b<idx>", PBT lineage "m<k>");
    #: resume replay routes scheduler state reconstruction by it
    lineage: Optional[str] = None


class History:
    def __init__(self, space: SearchSpace):
        self.space = space
        self.evals: List[Evaluation] = []
        self._by_key: Dict[Tuple, Evaluation] = {}
        self._inflight: set = set()
        # append-only caches behind encoded()/values()/costs(): the history
        # only ever grows, so each ask encodes just the new rows instead of
        # re-encoding the whole trace (O(n) per ask, not O(n^2) per run)
        self._enc_X = np.zeros((0, space.n_dims))
        self._enc_y = np.zeros((0,))
        self._enc_costs = np.zeros((0,))
        self._enc_fids = np.zeros((0,))
        self._enc_n = 0

    def __len__(self) -> int:
        return len(self.evals)

    def add(self, point: Dict, value: float, cost_seconds: float = 0.0,
            meta: Optional[dict] = None,
            fidelity: float = 1.0,
            rung: Optional[int] = None,
            lineage: Optional[str] = None) -> Evaluation:
        ev = Evaluation(dict(point), float(value), len(self.evals),
                        cost_seconds, meta or {}, float(fidelity),
                        rung, lineage)
        self.evals.append(ev)
        key = self.space.key(point)
        self._by_key[key] = ev
        self._inflight.discard(key)
        return ev

    def add_batch(self, points: List[Dict], values: List[float],
                  costs: Optional[List[float]] = None,
                  metas: Optional[List[dict]] = None) -> List[Evaluation]:
        """Append a completed batch (in submission order)."""
        costs = costs or [0.0] * len(points)
        metas = metas or [None] * len(points)
        return [self.add(p, v, c, m)
                for p, v, c, m in zip(points, values, costs, metas)]

    def add_observations(self, observations: List[Observation]
                         ) -> List[Evaluation]:
        """Append completed :class:`Observation` records (in order)."""
        return [self.add(o.point, o.value, o.cost_seconds, o.meta, o.fidelity,
                         o.rung, o.lineage)
                for o in observations]

    def observations(self) -> List[Observation]:
        """The trace as :class:`Observation` records — the schema
        ``Engine.tell`` takes, checkpoints snapshot, and the tuning
        service serializes over the wire."""
        return [Observation(point=dict(e.point), value=e.value,
                            cost_seconds=e.cost_seconds, fidelity=e.fidelity,
                            rung=e.rung, lineage=e.lineage,
                            meta=dict(e.meta))
                for e in self.evals]

    # -- in-flight bookkeeping (parallel executor) ---------------------------
    def mark_inflight(self, points: List[Dict]) -> None:
        for p in points:
            self._inflight.add(self.space.key(p))

    def clear_inflight(self, points: Optional[List[Dict]] = None) -> None:
        if points is None:
            self._inflight.clear()
        else:
            for p in points:
                self._inflight.discard(self.space.key(p))

    def pending(self, point: Dict) -> bool:
        """True while the point is submitted but not yet measured."""
        return self.space.key(point) in self._inflight

    def n_pending(self) -> int:
        return len(self._inflight)

    def lookup(self, point: Dict) -> Optional[Evaluation]:
        return self._by_key.get(self.space.key(point))

    def seen(self, point: Dict) -> bool:
        return self.space.key(point) in self._by_key

    def best(self, full_fidelity_only: bool = False) -> Evaluation:
        """Best finite evaluation; ``full_fidelity_only`` restricts to
        full measurements (a multi-fidelity run's partial values are
        noisy/biased by construction and should not win "best")."""
        finite = [e for e in self.evals if math.isfinite(e.value)
                  and (not full_fidelity_only or e.fidelity >= 1.0)]
        assert finite, "no finite evaluations"
        return max(finite, key=lambda e: e.value)

    def best_curve(self) -> List[float]:
        """Running best value per iteration (paper Fig. 5 curves)."""
        out, cur = [], -math.inf
        for e in self.evals:
            if math.isfinite(e.value):
                cur = max(cur, e.value)
            out.append(cur)
        return out

    def points(self) -> List[Dict]:
        return [e.point for e in self.evals]

    def _refresh_encoding_cache(self) -> None:
        """Encode only rows appended since the last call (append-only)."""
        n = len(self.evals)
        if self._enc_n == n:
            return
        cap = self._enc_X.shape[0]
        if cap < n:  # geometric growth: amortized O(1) appends
            new_cap = max(2 * cap, n, 16)
            self._enc_X = np.concatenate(
                [self._enc_X, np.zeros((new_cap - cap, self.space.n_dims))])
            self._enc_y = np.concatenate([self._enc_y, np.zeros(new_cap - cap)])
            self._enc_costs = np.concatenate(
                [self._enc_costs, np.zeros(new_cap - cap)])
            self._enc_fids = np.concatenate(
                [self._enc_fids, np.zeros(new_cap - cap)])
        for i in range(self._enc_n, n):
            e = self.evals[i]
            self._enc_X[i] = self.space.encode(e.point)
            self._enc_y[i] = e.value
            self._enc_costs[i] = e.cost_seconds
            self._enc_fids[i] = e.fidelity
        self._enc_n = n

    def values(self) -> np.ndarray:
        self._refresh_encoding_cache()
        return self._enc_y[:len(self.evals)].copy()

    def costs(self) -> np.ndarray:
        """Measured ``cost_seconds`` per evaluation (0 where unmeasured)."""
        self._refresh_encoding_cache()
        return self._enc_costs[:len(self.evals)].copy()

    def fidelities(self) -> np.ndarray:
        """Fidelity per evaluation (1.0 = full measurement)."""
        self._refresh_encoding_cache()
        return self._enc_fids[:len(self.evals)].copy()

    def encoded(self) -> Tuple[np.ndarray, np.ndarray]:
        self._refresh_encoding_cache()
        n = len(self.evals)
        return self._enc_X[:n].copy(), self._enc_y[:n].copy()

    # -- Table 2 analysis ----------------------------------------------------
    def sampled_ranges(self) -> Dict[str, Tuple]:
        """Per-parameter (min, max) of the values actually sampled."""
        out = {}
        for d in self.space.dims:
            samples = [e.point[d.name] for e in self.evals]
            if all(isinstance(v, (int, float)) for v in d.values):
                out[d.name] = (min(samples), max(samples))
            else:  # categorical: report set coverage
                out[d.name] = tuple(sorted(set(map(str, samples))))
        return out

    def sampled_range_fraction(self) -> Dict[str, float]:
        """Fraction of each tunable range covered (paper Table 2 %)."""
        out = {}
        for d in self.space.dims:
            samples = [e.point[d.name] for e in self.evals]
            vals = d.values
            if all(isinstance(v, (int, float)) for v in vals) and len(vals) > 1:
                lo, hi = min(vals), max(vals)
                out[d.name] = (max(samples) - min(samples)) / (hi - lo)
            else:
                out[d.name] = len(set(samples)) / len(vals)
        return out

    # -- persistence (tuner fault tolerance) ---------------------------------
    def to_json(self) -> str:
        return json.dumps(
            [
                {"point": e.point, "value": e.value, "index": e.index,
                 "cost_seconds": e.cost_seconds, "meta": e.meta,
                 "fidelity": e.fidelity, "rung": e.rung,
                 "lineage": e.lineage}
                for e in self.evals
            ]
        )

    def save(self, path) -> None:
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(".tmp")
        tmp.write_text(self.to_json())
        tmp.replace(p)  # atomic

    @classmethod
    def load(cls, path, space: SearchSpace) -> "History":
        h = cls(space)
        for rec in json.loads(pathlib.Path(path).read_text()):
            h.add(rec["point"], rec["value"], rec.get("cost_seconds", 0.0),
                  rec.get("meta"), rec.get("fidelity", 1.0),
                  rec.get("rung"), rec.get("lineage"))
        return h
