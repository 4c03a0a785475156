"""Persistent cross-job observation corpus for transfer learning.

Every completed evaluation the executor finalizes is worth more than its
memo entry: a *different* job on a *similar* workload can use it to skip
the from-scratch exploration phase entirely (AutoTVM's "TopHub" insight,
arxiv 1805.08166, and the clustering of near-optimal threading configs
across related CPU workloads in arxiv 1812.01665).  This module is the
storage and similarity layer:

* :class:`TuningCorpus` — append-only record store on the shared
  :class:`~repro_torch.tuning.cache.JsonCacheStore` (atomic replace + flock,
  so concurrent jobs union their observations).  One record per
  completed evaluation: point, value, ``cost_seconds``, fidelity, plus
  the **workload descriptor** of the job that measured it.
* Workload descriptor = task-feature vector (evaluator-declared
  ``task_features()``, e.g. roofline flops/bytes/intensity terms from
  ``cost_model.py`` or traffic stats from ``hlo_analysis.py``) + space
  fingerprint + hardware fingerprint + ``job_id`` + timestamp.
* :func:`workload_distance` — normalized mean per-feature relative
  difference in ``[0, 1]``-ish scale; the knob every consumer (kNN
  neighbor selection, noise inflation, the ``max_distance`` cutoff)
  ranks by.
* :func:`TuningCorpus.prior_observations` — the read side: k-nearest
  neighbor workloads' observations, hard-filtered to the matching
  search-space fingerprint, for surrogate warm-starts and candidate
  pre-filtering.

The corpus is strictly additive: with no corpus configured, nothing in
the tuner consults this module and every trace stays byte-identical.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import platform
import time
import uuid
from typing import Any, Dict, List, Optional

from repro_torch.tuning.cache import CacheStore, JsonCacheStore, NullCacheStore

#: distance penalty added when the observing job ran on different hardware
#: (a config tuned elsewhere is still informative about the *shape* of the
#: landscape, just less trustworthy — soft penalty, not a hard miss like
#: the TuningDB, whose records configure kernels directly)
_HARDWARE_PENALTY = 0.2


def space_fingerprint(space) -> str:
    """Stable short fingerprint of a search space's dimension spec.

    Transfer across *different* spaces is meaningless (points don't even
    validate), so neighbor selection hard-filters on this.
    """
    spec = json.dumps(space.to_dicts(), sort_keys=True)
    return hashlib.sha256(spec.encode()).hexdigest()[:16]


def hardware_descriptor() -> Dict[str, Any]:
    """The TuningDB hardware fingerprint (``repro_torch.tuning.tundb``:
    the card when there is one), degraded gracefully.  Its fields differ
    from the reference package's, so a record measured on a GPU is never
    taken for one measured on a TPU, and vice versa."""
    try:
        from repro_torch.tuning.tundb import hardware_fingerprint
        return hardware_fingerprint()
    except Exception:
        return {"machine": platform.machine(),
                "cpu_count": os.cpu_count() or 1}


def task_features(objective) -> Dict[str, float]:
    """Evaluator-declared task features, coerced to a flat str->float map.

    Evaluators opt in by exposing ``task_features() -> {name: number}``
    (e.g. roofline flops/bytes/arithmetic-intensity terms).  Objectives
    without the hook — plain callables, legacy evaluators — yield ``{}``:
    the corpus still records provenance, and distance falls back to
    "same space = neighbor".
    """
    fn = getattr(objective, "task_features", None)
    if fn is None:
        return {}
    try:
        raw = dict(fn())
    except Exception:
        return {}
    feats: Dict[str, float] = {}
    for k, v in raw.items():
        try:
            f = float(v)
        except (TypeError, ValueError):
            continue
        if math.isfinite(f):
            feats[str(k)] = f
    return feats


def workload_distance(fa: Dict[str, float], fb: Dict[str, float]) -> float:
    """Mean per-feature relative difference over the union of feature keys.

    Per feature: ``|a - b| / (|a| + |b| + eps)`` — 0 for identical, -> 1
    for wildly different magnitudes; a feature one side lacks counts as
    1.0 (maximally uninformative).  Two empty descriptors are distance 0
    (nothing contradicts similarity; the space fingerprint already
    filtered).
    """
    keys = set(fa) | set(fb)
    if not keys:
        return 0.0
    total = 0.0
    for k in keys:
        if k not in fa or k not in fb:
            total += 1.0
        else:
            a, b = fa[k], fb[k]
            total += abs(a - b) / (abs(a) + abs(b) + 1e-12)
    return total / len(keys)


def prediction_agreement(pred, actual) -> Optional[float]:
    """Pearson correlation between predicted and measured values, or
    ``None`` when degenerate (fewer than 2 pairs, or either side
    constant).  The negative-transfer guard drops a prior whose
    agreement is negative: it is actively *mis*-ranking this workload."""
    import numpy as np

    p = np.asarray(pred, dtype=float)
    a = np.asarray(actual, dtype=float)
    if p.size != a.size or p.size < 2:
        return None
    if float(p.std()) == 0.0 or float(a.std()) == 0.0:
        return None
    return float(np.corrcoef(p, a)[0, 1])


class TuningCorpus:
    """Append-only observation corpus shared across tuning jobs.

    Write side: :meth:`describe_job` binds the current job's workload
    descriptor once, then the executor calls :meth:`add` per finalized
    real measurement and :meth:`flush` per completion drain (buffered —
    one locked read-merge-write per drain, same discipline as the memo
    cache).

    Read side: :meth:`prior_observations` returns observations from the
    k nearest *other* workloads on the same search space, each tagged
    with its workload distance.
    """

    def __init__(self, path=None, *, store: Optional[CacheStore] = None,
                 job_id: Optional[str] = None,
                 hardware: Optional[Dict[str, Any]] = None):
        #: the fingerprint of the hardware this job measures on; None =
        #: this process's (``hardware_descriptor``).  A tuner whose
        #: measurements run elsewhere (the tuning service over a worker
        #: fleet) passes the workers' fingerprint, so the records say
        #: where they were measured and the tuner's process never has to
        #: touch a device to describe them.
        self.hardware = dict(hardware) if hardware is not None else None
        if store is not None:
            self.store = store
        elif path is not None:
            self.store = JsonCacheStore(path)
        else:
            self.store = NullCacheStore()
        self.job_id = job_id or f"job-{os.getpid()}-{int(time.time())}"
        self.descriptor: Optional[Dict[str, Any]] = None
        self._pending: Dict[str, Any] = {}
        self._n_added = 0
        # per-process nonce in every record key: job_ids recur (service
        # crash-resume reuses them; launch/tune.py derives deterministic
        # ones), and the in-process counter restarts at 1, so without the
        # nonce a re-run would overwrite the earlier run's records at the
        # same key indices — put_many merges by key, and "append-only"
        # must mean append-only across processes too
        self._run_nonce = uuid.uuid4().hex[:12]

    # -- write side -----------------------------------------------------------

    def describe_job(self, objective, space) -> Dict[str, Any]:
        """Bind this job's workload descriptor (idempotent)."""
        if self.descriptor is None:
            self.descriptor = {
                "features": task_features(objective),
                "space": space_fingerprint(space),
                "hardware": (dict(self.hardware) if self.hardware is not None
                             else hardware_descriptor()),
                "job_id": self.job_id,
                "timestamp": time.time(),
            }
        return self.descriptor

    def add(self, point: Dict[str, Any], value: float,
            cost_seconds: float = 0.0, fidelity: float = 1.0) -> None:
        """Buffer one completed evaluation under the bound descriptor."""
        if self.descriptor is None:
            raise RuntimeError("TuningCorpus.add before describe_job: the "
                               "workload descriptor must be bound first")
        self._n_added += 1
        key = json.dumps({"job": self.descriptor["job_id"],
                          "run": self._run_nonce,
                          "space": self.descriptor["space"],
                          "n": self._n_added}, sort_keys=True)
        self._pending[key] = {
            "point": dict(point),
            "value": float(value),
            "cost_seconds": float(cost_seconds),
            "fidelity": float(fidelity),
            "workload": self.descriptor,
        }

    def flush(self) -> None:
        if self._pending:
            self.store.put_many(self._pending)
            self._pending = {}

    # -- read side ------------------------------------------------------------

    def records(self) -> List[Dict[str, Any]]:
        recs = list(self.store.load().values())
        recs.extend(self._pending.values())
        return recs

    def neighbors(self, space, features: Dict[str, float], *,
                  k: int = 3, max_distance: float = 0.35,
                  exclude_job: Optional[str] = None,
                  hardware: Optional[Dict[str, Any]] = None,
                  ) -> List[Dict[str, Any]]:
        """The ``k`` nearest other workloads on this search space.

        Returns ``[{"job_id", "distance", "records": [...]}]`` sorted by
        ascending distance; workloads beyond ``max_distance`` are
        dropped entirely (the deliberate-dissimilarity cutoff — better
        no prior than a misleading one).
        """
        fp = space_fingerprint(space)
        if hardware is not None:
            hw = hardware
        elif self.descriptor is not None:  # where this job measures
            hw = self.descriptor["hardware"]
        else:
            hw = self.hardware or hardware_descriptor()
        exclude = exclude_job if exclude_job is not None else self.job_id
        groups: Dict[str, Dict[str, Any]] = {}
        for rec in self.records():
            wl = rec.get("workload") or {}
            if wl.get("space") != fp:
                continue
            jid = wl.get("job_id")
            if jid is None or jid == exclude:
                continue
            g = groups.get(jid)
            if g is None:
                d = workload_distance(features, wl.get("features") or {})
                if wl.get("hardware") != hw:
                    d = min(1.0, d + _HARDWARE_PENALTY)
                g = groups[jid] = {"job_id": jid, "distance": d,
                                   "records": []}
            g["records"].append(rec)
        near = [g for g in groups.values() if g["distance"] <= max_distance]
        near.sort(key=lambda g: (g["distance"], g["job_id"]))
        return near[:k]

    def prior_observations(self, space, features: Dict[str, float], *,
                           k: int = 3, max_rows: int = 32,
                           max_distance: float = 0.35,
                           exclude_job: Optional[str] = None,
                           ) -> List[Dict[str, Any]]:
        """Flat prior-observation rows for surrogate seeding.

        Rows are ``{"point", "value", "cost_seconds", "fidelity",
        "distance"}`` drawn from the k nearest neighbor workloads, at
        most ``max_rows`` total (quota split evenly, spread across each
        workload's value range so the prior keeps both its peaks and its
        floors).  Failed measurements (non-finite values) and points
        that no longer validate against the space are skipped.
        """
        near = self.neighbors(space, features, k=k,
                              max_distance=max_distance,
                              exclude_job=exclude_job)
        if not near:
            return []
        quota = max(1, max_rows // len(near))
        rows: List[Dict[str, Any]] = []
        for g in near:
            usable = []
            for rec in g["records"]:
                v = rec.get("value")
                if not isinstance(v, (int, float)) or not math.isfinite(v):
                    continue
                point = rec.get("point")
                if not isinstance(point, dict) or not space.validate(point):
                    continue
                usable.append(rec)
            if not usable:
                continue
            usable.sort(key=lambda r: r["value"])
            if len(usable) > quota:
                # evenly spaced over the value-sorted rows: keeps the
                # best, the worst, and the spread in between
                idx = [round(i * (len(usable) - 1) / (quota - 1))
                       for i in range(quota)] if quota > 1 else [len(usable) - 1]
                usable = [usable[i] for i in sorted(set(idx))]
            for rec in usable:
                rows.append({
                    "point": dict(rec["point"]),
                    "value": float(rec["value"]),
                    "cost_seconds": float(rec.get("cost_seconds", 0.0)),
                    "fidelity": float(rec.get("fidelity", 1.0)),
                    "distance": g["distance"],
                })
        return rows[:max_rows]
