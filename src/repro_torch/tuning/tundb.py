"""Persistent kernel-tuning database — the "TopHub" artifact.

A tuning run is expensive (many measured configurations); its *answer*
is tiny (one best config per kernel/shape).  ``TuningDB`` persists those
answers so every later serve/train run starts from the tuned
configuration instead of the heuristic default — the pay-once
amortization argument of *Learning to Optimize Tensor Programs*
(TopHub) and *Auto-tuning TensorFlow Threading Model for CPU Backend*
applied to this repo's own hand-written kernels.

Records are keyed by ``(kernel, shape bucket, hardware fingerprint)``:

* **kernel** — registry name (``flash_attention``, ``decode_attention``,
  ``rmsnorm``, ``ssm_scan``, ``gla_scan``);
* **shape bucket** — the kernel's integer call-shape dims, each rounded
  *up* to the next power of two (``bucket_shape``).  A tuned answer for
  ``Sq=4096`` therefore also serves ``Sq=3000..4096`` — tile choices are
  far less shape-sensitive than the measurement cost of re-tuning every
  exact shape, and the kernels clamp tiles anyway;
* **hardware fingerprint** — backend, device name, compute capability,
  device count, PyTorch and CUDA versions, host (``hardware_fingerprint``).
  A measurement taken on one machine must never silently configure
  another: a fingerprint mismatch is a *miss*, and the caller falls back
  to heuristic defaults.  The fingerprint has other fields than the
  reference package's, so a record written there never matches here.

The record format, the bucketing rule and the keep-best rule are the
reference package's: with the same injected fingerprint both packages
write the same key and read each other's file.

    {"config": {...tile dims...}, "value": <objective>, "fidelity": 1.0,
     "job_id": "...", "timestamp": <epoch s>, "kernel": "...",
     "bucket": {...}, "fingerprint": {...}}

Storage is the shared :class:`~repro_torch.tuning.cache.JsonCacheStore`
(atomic replace writes + ``flock``-guarded read-merge-write), so
concurrent sweep processes merge their answers instead of clobbering each
other.  ``record`` keeps the best value per key (an equal-or-worse result
never overwrites a stored answer).

Consumers reach the DB through the ``Runtime.tuning_db`` hook: the
kernel dispatch layer (``repro_torch.kernels.ops``) consults it with the
actual call shapes and memoises the answer per shape, so the DB is read
once per distinct call shape of a step and never again.  With no DB
configured every code path stays on its defaults.  Records added after a
step was built do not change that step — rebuild the step to pick up new
answers.

A ``TuningDB`` instance hashes/compares by identity, so ``Runtime`` stays
hashable.
"""
from __future__ import annotations

import json
import os
import platform
import time
from typing import Dict, Optional

from repro_torch.tuning.cache import CacheStore, open_store


def _pow2_up(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(0, int(n) - 1).bit_length()


def bucket_shape(dims: Dict[str, int]) -> Dict[str, int]:
    """Shape-bucketing rule: every positive dim rounds up to a power of
    two; zero/negative dims pass through unchanged."""
    return {k: _pow2_up(v) if isinstance(v, int) and v > 0 else v
            for k, v in dims.items()}


def hardware_fingerprint(device=None) -> Dict[str, object]:
    """What a measurement's validity depends on: the machine, not the run.

    ``device`` is ``"cuda"`` or ``"cpu"``; by default the card when there
    is one.  This only describes the machine for the record key, it selects
    no code path.
    """
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    backend = torch.device(device).type
    fp: Dict[str, object] = {
        "backend": backend,
        "device_kind": "cpu",
        "compute_capability": None,
        "device_count": 1,
        "torch": str(torch.__version__),
        "cuda": torch.version.cuda,
        "machine": platform.machine(),
        "cpu_count": os.cpu_count() or 1,
    }
    if backend == "cuda":
        major, minor = torch.cuda.get_device_capability(0)
        fp["device_kind"] = str(torch.cuda.get_device_name(0))
        fp["compute_capability"] = f"{major}.{minor}"
        fp["device_count"] = int(torch.cuda.device_count())
    return fp


class TuningDB:
    """Best-known kernel configs keyed by (kernel, bucket, fingerprint).

    ``path=None`` gives an in-memory DB (NullCacheStore: records live
    for the process, nothing persists) — useful for tests and for
    passing a pre-populated ``store``.
    """

    def __init__(self, path=None, *, store: Optional[CacheStore] = None,
                 fingerprint: Optional[Dict] = None):
        if store is not None and path is not None:
            raise ValueError("pass path= or store=, not both")
        self.path = str(path) if path is not None else None
        self.store: CacheStore = store if store is not None else open_store(path)
        self.fingerprint = (dict(fingerprint) if fingerprint is not None
                            else hardware_fingerprint())
        self._cache: Dict[str, dict] = self.store.load()
        self.lookups = 0
        self.hits = 0

    # identity hash/eq: keeps Runtime hashable (the dataclass-generated
    # Runtime.__eq__ compares fields with ==)
    __hash__ = object.__hash__

    def __eq__(self, other) -> bool:
        return self is other

    def __len__(self) -> int:
        return len(self._cache)

    def _key(self, kernel: str, bucket: Dict[str, int]) -> str:
        return json.dumps(
            {"kernel": kernel, "bucket": bucket, "fp": self.fingerprint},
            sort_keys=True)

    def refresh(self) -> None:
        """Re-read the backing store (merge records other writers added).

        Steps built before the refresh keep their tiles — the ops layer
        memoises what it read (see module docstring).
        """
        for k, v in self.store.load().items():
            self._cache[k] = v

    # -- read side -----------------------------------------------------------
    def lookup(self, kernel: str, dims: Dict[str, int]) -> Optional[dict]:
        """Full record for (kernel, bucket(dims), this fingerprint), or None.

        A hardware-fingerprint mismatch is indistinguishable from an
        absent record on purpose: both mean "no trusted answer here" and
        the caller falls back to heuristic defaults.
        """
        self.lookups += 1
        rec = self._cache.get(self._key(kernel, bucket_shape(dims)))
        if rec is not None:
            self.hits += 1
        return rec

    def kernel_config(self, kernel: str, dims: Dict[str, int]) -> Optional[dict]:
        """Just the tuned config dict (what the dispatch layer overrides
        tile defaults with), or None on a miss."""
        rec = self.lookup(kernel, dims)
        return rec.get("config") if rec is not None else None

    # -- write side ----------------------------------------------------------
    def record(self, kernel: str, dims: Dict[str, int], config: Dict,
               value: float, *, fidelity: float = 1.0,
               job_id: Optional[str] = None,
               timestamp: Optional[float] = None) -> bool:
        """Store ``config`` as the best known for (kernel, bucket(dims))
        unless an existing record already beats ``value``.

        Returns True when the record was written (new key, or a strict
        improvement).  Writes go through the store's locked
        read-merge-write, so concurrent sweeps union their keys; two
        writers racing on the *same* key resolve last-writer-wins, which
        is safe here because both candidates were measured and the next
        ``record`` with the better value restores it.
        """
        bucket = bucket_shape(dims)
        key = self._key(kernel, bucket)
        existing = self._cache.get(key)
        if existing is not None and float(existing["value"]) >= float(value):
            return False
        rec = {
            "config": dict(config),
            "value": float(value),
            "fidelity": float(fidelity),
            "job_id": job_id,
            "timestamp": float(time.time() if timestamp is None else timestamp),
            "kernel": kernel,
            "bucket": bucket,
            "fingerprint": dict(self.fingerprint),
        }
        self._cache[key] = rec
        self.store.put(key, rec)
        return True
