"""Integrity-checked checkpointing: arrays (training state) and JSON
documents (the tuning service's job snapshots).

Both checkpointers share the idioms: atomic rename commit, sha256
integrity, keep-last-k retention.

* :class:`Checkpointer` — nested dicts of tensors (params + optimizer
  state).  One directory per step::

      <root>/step_00000100/
          shard_000.npz     # flattened (path -> array) leaves
          manifest.json     # paths, shapes, dtypes, sha256, metadata

  The write runs on a background thread (``wait()`` joins it), keep-last-k
  and keep-best retention prune old steps, and a sha256 mismatch on
  restore raises ``IOError``.  Leaf paths are the key strings that
  ``jax.tree_util.keystr`` gives the reference package's tree
  (``"['params']['embed']"``), and the file layout is the reference's, so
  a float32 checkpoint written by either package restores in the other.
  numpy has no bfloat16: a bfloat16 leaf is stored as its ``uint16`` bit
  pattern with ``"bfloat16"`` in the manifest and viewed back on restore,
  bit for bit.

* :class:`JsonCheckpointer` — JSON documents.

The module imports the stdlib only (numpy and torch are imported where the
array checkpointer uses them), so the service daemon and the worker
daemons checkpoint on hosts without the accelerator stack.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import shutil
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional

_BF16 = "bfloat16"


def _map_with_keys(fn, tree, prefix: str = ""):
    """``fn(key, leaf)`` over the leaves of nested dicts, ``key`` spelled as
    ``jax.tree_util.keystr`` spells the leaf's path; keys in sorted order,
    as jax flattens a dict."""
    if isinstance(tree, dict):
        return {k: _map_with_keys(fn, tree[k], f"{prefix}[{k!r}]") for k in sorted(tree)}
    return fn(prefix, tree)


def _to_host(leaf):
    """A copy on the host that later in-place updates of ``leaf`` cannot
    reach; bfloat16 as its bit pattern."""
    import numpy as np
    import torch

    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf)
    t = leaf.detach()
    t = t.clone() if t.device.type == "cpu" else t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _flatten(tree) -> Dict[str, tuple]:
    """path -> (host array, dtype name for the manifest)."""
    import torch

    flat = {}

    def put(key, leaf):
        bf16 = isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
        arr = _to_host(leaf)
        flat[key] = (arr, _BF16 if bf16 else str(arr.dtype))

    _map_with_keys(put, tree)
    return flat


def _from_host(arr, dtype: str, like) -> Any:
    import numpy as np
    import torch

    arr = np.array(arr)  # a contiguous copy of the same rank
    if dtype == _BF16:  # 16-bit patterns (either package's writer) -> bfloat16
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if not isinstance(like, torch.Tensor):
        return t
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf of shape {tuple(t.shape)} restored into "
                         f"one of shape {tuple(like.shape)}")
    return t.to(device=like.device, dtype=like.dtype)


class Checkpointer:
    def __init__(self, root: str, *, keep_last: int = 3, keep_best: int = 1):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.keep_best = keep_best
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None
        self._best: Dict[int, float] = {}  # step -> metric (higher better)

    # -- paths ---------------------------------------------------------------
    def _dir(self, step: int) -> pathlib.Path:
        return self.root / f"step_{step:08d}"

    def steps(self) -> List[int]:
        out = []
        for p in self.root.glob("step_*"):
            if (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree: Any, *, metadata: Optional[dict] = None,
             metric: Optional[float] = None) -> None:
        # copy to the host synchronously (cheap vs the write), write async
        flat = _flatten(tree)
        meta = dict(metadata or {})
        meta.update({"step": step, "time": time.time()})
        if metric is not None:
            self._best[step] = float(metric)
            meta["metric"] = float(metric)
        self.wait()
        self._pending = self._pool.submit(self._write, step, flat, meta)

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _write(self, step: int, flat: Dict[str, tuple], meta: dict) -> None:
        import numpy as np

        final = self._dir(step)
        tmp = self.root / f".tmp_step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        shard_file = tmp / "shard_000.npz"
        np.savez(shard_file, **{k: arr for k, (arr, _) in flat.items()})
        digest = hashlib.sha256(shard_file.read_bytes()).hexdigest()
        manifest = {
            "leaves": {k: {"shape": list(arr.shape), "dtype": dtype}
                       for k, (arr, dtype) in flat.items()},
            "files": {"shard_000.npz": digest},
            "metadata": meta,
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic commit
        self._gc()

    def _gc(self) -> None:
        steps = self.steps()
        protected = set(steps[-self.keep_last:]) if self.keep_last else set()
        if self._best and self.keep_best:
            best = sorted(self._best, key=self._best.get, reverse=True)
            protected |= set(best[: self.keep_best])
        for s in steps:
            if s not in protected:
                shutil.rmtree(self._dir(s), ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def restore(self, step: Optional[int], like: Any, *, shardings: Any = None):
        """Restore into the structure of ``like``: each leaf on the device and
        in the dtype of ``like``'s leaf.  ``step=None`` takes the latest.
        A write still in flight from this checkpointer is waited for first.
        ``shardings`` places leaves on another mesh in the reference
        package; one card has no mesh, so it must be ``None``."""
        import numpy as np

        if shardings is not None:
            raise ValueError("shardings: a single-device restore takes None")
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {self.root}")
        d = self._dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        blob = d / "shard_000.npz"
        digest = hashlib.sha256(blob.read_bytes()).hexdigest()
        if digest != manifest["files"]["shard_000.npz"]:
            raise IOError(f"checkpoint {d} corrupt: sha256 mismatch")
        leaves = manifest["leaves"]
        with np.load(blob) as data:
            out = _map_with_keys(
                lambda key, leaf: _from_host(data[key], leaves[key]["dtype"], leaf), like)
        return out, manifest["metadata"]


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
