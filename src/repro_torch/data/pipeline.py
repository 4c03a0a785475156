"""Deterministic synthetic token pipeline.

Stateless: ``batch_at(step)`` is a pure function of (seed, step), so any
worker can reproduce any batch — this is what makes checkpoint/restart and
elastic rescaling exact (a restored run consumes the identical stream).
Tokens follow a noisy affine bigram process so models have a learnable
signal (train-loss-decreases tests rely on it).

A background prefetch thread overlaps host batch synthesis with device
compute.

Numpy only, transcribed from the reference package's pipeline: the same
(seed, step, shard) gives the same arrays, so a run of either package
consumes the same stream.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


def _mix(a: np.ndarray) -> np.ndarray:
    """splitmix64-style integer hash (vectorized, deterministic)."""
    a = (a + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    a ^= a >> np.uint64(30)
    a = (a * np.uint64(0xBF58476D1CE4E5B9)).astype(np.uint64)
    a ^= a >> np.uint64(27)
    a = (a * np.uint64(0x94D049BB133111EB)).astype(np.uint64)
    return a ^ (a >> np.uint64(31))


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.1  # fraction of purely random tokens


class SyntheticTokens:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int, *, shard: int = 0, num_shards: int = 1) -> Dict:
        """Batch for ``step``; optionally only this host's shard of it."""
        c = self.cfg
        assert c.global_batch % num_shards == 0
        b = c.global_batch // num_shards
        rows = (np.arange(b) + shard * b).astype(np.uint64)
        base = _mix(
            rows[:, None] * np.uint64(1_000_003)
            + np.uint64(step) * np.uint64(7_919)
            + np.uint64(c.seed) * np.uint64(104_729)
        )
        # noisy affine bigram stream: x_{t+1} = 3 x_t + 7 (mod V), with
        # `noise`-fraction random substitutions
        V = c.vocab_size
        toks = np.empty((b, c.seq_len + 1), np.int64)
        toks[:, 0] = base[:, 0] % V
        h = base[:, 0]
        for t in range(1, c.seq_len + 1):
            h = _mix(h + np.uint64(t))
            rand_tok = (h % np.uint64(V)).astype(np.int64)
            is_noise = (h >> np.uint64(40)).astype(np.float64) / float(2 ** 24) < c.noise
            nxt = (toks[:, t - 1] * 3 + 7) % V
            toks[:, t] = np.where(is_noise, rand_tok, nxt)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[Dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of upcoming batches (depth-bounded)."""

    def __init__(self, source: SyntheticTokens, start_step: int = 0, depth: int = 2):
        self.source = source
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
