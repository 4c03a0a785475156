"""Integrity-checked checkpointing of JSON documents.

:class:`JsonCheckpointer` keeps the tuning service's per-job snapshots:
atomic rename commit, sha256 integrity, keep-last-k retention.  It is
stdlib only, so the service daemon and the worker daemons checkpoint
without touching a device.

The reference package's array ``Checkpointer`` (training state: one
directory per step, async save, keep-best, restore onto other shardings)
belongs to the training slice of the port and is not here yet.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import time
from typing import List, Optional


class JsonCheckpointer:
    """Atomic, integrity-checked snapshots of a JSON document.

    The tuning service checkpoints each job's state (spec, status,
    history path) through this: every :meth:`save` writes
    ``snap_<seq>.json`` with an embedded sha256 over its payload and
    commits it by atomic rename, then prunes to ``keep_last``.
    :meth:`load` returns the newest snapshot that passes its integrity
    check — a snapshot truncated by the very crash being recovered from
    is skipped, and the previous good one restores instead.
    """

    def __init__(self, root, *, keep_last: int = 3):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep_last = max(1, int(keep_last))

    def _seqs(self) -> List[int]:
        out = []
        for p in self.root.glob("snap_*.json"):
            try:
                out.append(int(p.stem.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def _path(self, seq: int) -> pathlib.Path:
        return self.root / f"snap_{seq:08d}.json"

    def save(self, doc: dict) -> int:
        """Snapshot ``doc``; returns the sequence number committed."""
        payload = json.dumps(doc, allow_nan=True, sort_keys=True)
        digest = hashlib.sha256(payload.encode("utf-8")).hexdigest()
        seqs = self._seqs()
        seq = (seqs[-1] + 1) if seqs else 0
        final = self._path(seq)
        tmp = final.with_suffix(".tmp")
        tmp.write_text(json.dumps(
            {"sha256": digest, "time": time.time(), "doc": payload}))
        tmp.replace(final)  # atomic commit
        for old in seqs[: max(0, len(seqs) + 1 - self.keep_last)]:
            self._path(old).unlink(missing_ok=True)
        return seq

    def load(self) -> Optional[dict]:
        """Newest snapshot that passes its integrity check, or None."""
        for seq in reversed(self._seqs()):
            try:
                wrapper = json.loads(self._path(seq).read_text())
                payload = wrapper["doc"]
                digest = hashlib.sha256(
                    payload.encode("utf-8")).hexdigest()
                if digest != wrapper["sha256"]:
                    continue  # torn write: fall back to the previous snap
                return json.loads(payload)
            except (OSError, KeyError, ValueError, TypeError):
                continue
        return None
