"""Disk-backed cache stores for measurement memoization.

A tuning run's dominant cost is the measurement (lower + compile + run),
not the suggestion, so every completed evaluation is worth persisting:
repeated runs, resumed runs, and multiple hosts sharing a filesystem
should never re-measure a configuration.  This module provides the
storage layer behind both the executor's :class:`MemoCache` and the
``RooflineEvaluator``'s compile cache:

* :class:`CacheStore` — the abstract contract: ``load() -> {key: record}``
  plus ``put(key, record)`` / ``put_many(records)``, where keys are
  strings and records are JSON-serializable dicts.
* :class:`JsonCacheStore` — a single JSON file with **atomic writes**
  (write to a sidecar temp file, then ``os.replace``) and
  **cross-process file locking** (POSIX ``flock`` on a ``.lock``
  sidecar), so concurrent writers on one host — or on several hosts
  sharing a POSIX filesystem with coherent locks — merge their entries
  instead of clobbering each other.  Every ``put``/``put_many`` is one
  read-merge-write under the lock: last-writer-wins per key, union
  across keys (batch the puts — the executor's memo cache flushes once
  per completion drain).  Records are validated JSON-serializable at
  ``put`` time (fail loudly beats a silently corrupting ``default=str``
  round trip), and a corrupt/torn cache file is quarantined to a
  ``.corrupt`` sidecar with a warning instead of killing the run.
* :class:`NullCacheStore` — the no-op store used when persistence is
  disabled; keeps callers free of ``if store is not None`` branches.

The on-disk format is a plain JSON object mapping key strings to
records, which is exactly the format the ``RooflineEvaluator`` has
always written — existing cache files load unchanged.
"""
from __future__ import annotations

import contextlib
import json
import os
import pathlib
import warnings
from typing import Any, Dict

try:  # POSIX file locking; degrade to lockless on platforms without it
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX
    fcntl = None


def _round_trip_violation(x: Any, path: str = "record"):
    """First node of ``x`` that would NOT survive a JSON round trip
    *equal* (as a description string), or ``None`` if the whole record
    is canonical JSON.

    Stricter than "json.dumps succeeds": a tuple dumps fine but reloads
    as a list, and a non-string dict key reloads stringified — both are
    silent corruption from a cache's point of view, so only the
    canonical JSON types (str/bool/int/float/None, lists of them, and
    string-keyed dicts of them) pass.  This walk is also cheaper than a
    serialization, so validating at ``put`` time costs no extra dumps.
    """
    if x is None or isinstance(x, (str, bool, int, float)):
        return None
    if isinstance(x, list):
        for i, v in enumerate(x):
            bad = _round_trip_violation(v, f"{path}[{i}]")
            if bad:
                return bad
        return None
    if isinstance(x, dict):
        for k, v in x.items():
            if not isinstance(k, str):
                return (f"{path} has non-string key {k!r} "
                        "(reloads stringified)")
            bad = _round_trip_violation(v, f"{path}[{k!r}]")
            if bad:
                return bad
        return None
    return (f"{path} is a {type(x).__name__} (tuples reload as lists; "
            "arbitrary objects do not reload at all)")


def ensure_serializable(key: str, record: Any) -> None:
    """Reject records that would not survive the JSON round trip equal.

    The store used to serialize with ``default=str``, which silently
    stringified anything JSON could not represent — the record *looked*
    persisted but reloaded corrupted (a numpy scalar came back as
    ``"3.0"``, an object as its repr).  A cache whose hits differ from
    what was stored is worse than no cache, so non-round-trippable
    records now fail loudly at ``put`` time, naming the key and the
    offending field.
    """
    try:
        bad = _round_trip_violation(record)
    except RecursionError:
        bad = "record is self-referential"
    if bad:
        raise TypeError(
            f"cache record for key {key!r} would not survive the JSON "
            f"round trip: {bad}; refusing to persist it — a default=str "
            "fallback would silently corrupt the record on reload")


class CacheStore:
    """Abstract persistent key->record store (string keys, JSON records)."""

    def load(self) -> Dict[str, Any]:
        raise NotImplementedError

    def put(self, key: str, record: Any) -> None:
        raise NotImplementedError

    def put_many(self, records: Dict[str, Any]) -> None:
        for k, v in records.items():
            self.put(k, v)


class NullCacheStore(CacheStore):
    """Persistence disabled: loads empty, drops every put."""

    def load(self) -> Dict[str, Any]:
        return {}

    def put(self, key: str, record: Any) -> None:
        pass

    def put_many(self, records: Dict[str, Any]) -> None:
        pass


class JsonCacheStore(CacheStore):
    """One JSON file, atomic replace writes, ``flock``-guarded merges."""

    def __init__(self, path):
        self.path = pathlib.Path(path)
        self.lock_path = self.path.with_name(self.path.name + ".lock")

    @contextlib.contextmanager
    def _locked(self):
        self.lock_path.parent.mkdir(parents=True, exist_ok=True)
        if fcntl is None:  # pragma: no cover - non-POSIX
            yield
            return
        with open(self.lock_path, "w") as lf:
            fcntl.flock(lf.fileno(), fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lf.fileno(), fcntl.LOCK_UN)

    def _read(self) -> Dict[str, Any]:
        if not self.path.exists():
            return {}
        text = self.path.read_text()
        if not text.strip():
            return {}
        try:
            return json.loads(text)
        except json.JSONDecodeError as e:
            # a torn/corrupt file (host died mid-write on a filesystem
            # where rename is not atomic, disk full, truncation) must not
            # kill the whole tuning run: quarantine it for post-mortem and
            # continue with an empty store — the measurements re-accrue
            quarantine = self.path.with_name(self.path.name + ".corrupt")
            try:
                os.replace(self.path, quarantine)
                where = f"quarantined to {quarantine}"
            except OSError:
                where = "and could not be quarantined"
            warnings.warn(
                f"cache file {self.path} is corrupt ({e}); {where}; "
                "continuing with an empty store", RuntimeWarning,
                stacklevel=3)
            return {}

    def _write(self, data: Dict[str, Any]) -> None:
        tmp = self.path.with_name(self.path.name + ".tmp")
        # no default= fallback: put_many validated every record, and a
        # serializer that silently stringifies is how corrupt caches are
        # born (see ensure_serializable)
        tmp.write_text(json.dumps(data, allow_nan=True))
        os.replace(tmp, self.path)  # atomic: readers never see a torn file

    def load(self) -> Dict[str, Any]:
        with self._locked():
            return self._read()

    def put(self, key: str, record: Any) -> None:
        self.put_many({key: record})

    def put_many(self, records: Dict[str, Any]) -> None:
        """One read-merge-write for the whole batch.

        This is the store's flush unit: callers with many pending puts
        (the executor's memo cache batches one flush per completion
        drain) pay one lock + one file traversal for all of them,
        instead of a full read-merge-write per key.
        """
        if not records:
            return
        for k, rec in records.items():
            ensure_serializable(k, rec)
        with self._locked():
            data = self._read()
            data.update(records)
            self._write(data)


def open_store(path=None) -> CacheStore:
    """``None`` -> :class:`NullCacheStore`; else a :class:`JsonCacheStore`."""
    return NullCacheStore() if path is None else JsonCacheStore(path)
