"""Fault-tolerance runtime: straggler detection, failure injection, and
elastic rescale planning.

At 1000+ nodes these drive the control plane; here the policies are
implemented exactly and exercised single-process (the trainer injects
``WorkerFailure``s and recovers through the checkpoint + rescale path).
Stdlib and numpy only, transcribed from the reference package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


class WorkerFailure(RuntimeError):
    """A (simulated) worker/host loss during a step."""

    def __init__(self, step: int, failed_workers: int = 1):
        super().__init__(f"worker failure at step {step} ({failed_workers} lost)")
        self.step = step
        self.failed_workers = failed_workers


@dataclass
class StragglerDetector:
    """EWMA z-score detector on per-step wall time.

    ``update`` returns True when the step time is a sustained outlier —
    the trainer then flags the replica group for exclusion (elastic path).
    """

    alpha: float = 0.1
    z_threshold: float = 4.0
    warmup: int = 10
    sustained: int = 3

    _mean: float = field(default=0.0, init=False)
    _var: float = field(default=0.0, init=False)
    _n: int = field(default=0, init=False)
    _hits: int = field(default=0, init=False)

    def update(self, step_seconds: float) -> bool:
        self._n += 1
        if self._n <= self.warmup:
            # prime the statistics
            if self._n == 1:
                self._mean = step_seconds
            self._mean += self.alpha * (step_seconds - self._mean)
            self._var += self.alpha * ((step_seconds - self._mean) ** 2 - self._var)
            return False
        std = math.sqrt(max(self._var, 1e-12))
        z = (step_seconds - self._mean) / std
        is_outlier = z > self.z_threshold
        self._hits = self._hits + 1 if is_outlier else 0
        if not is_outlier:  # only absorb normal samples into the baseline
            self._mean += self.alpha * (step_seconds - self._mean)
            self._var += self.alpha * ((step_seconds - self._mean) ** 2 - self._var)
        return self._hits >= self.sustained

    @property
    def baseline(self) -> float:
        return self._mean


class FailureInjector:
    """Deterministic pseudo-random failure schedule for tests/examples."""

    def __init__(self, rate: float = 0.0, seed: int = 0,
                 at_steps: Optional[List[int]] = None):
        self.rate = rate
        self.rng = np.random.default_rng(seed)
        self.at_steps = set(at_steps or [])

    def check(self, step: int) -> None:
        if step in self.at_steps:
            self.at_steps.discard(step)  # each scheduled failure fires once
            raise WorkerFailure(step)
        if self.rate > 0 and self.rng.random() < self.rate:
            raise WorkerFailure(step)


@dataclass(frozen=True)
class ElasticPlan:
    """Rescale decision after losing workers: keep tp, shrink dp to the
    largest power of two that the survivors support; global batch is
    preserved (per-replica batch grows), so the data stream and loss
    trajectory stay comparable."""

    old_dp: int
    new_dp: int
    tp: int

    @classmethod
    def after_failure(cls, dp: int, tp: int, lost_chips: int) -> "ElasticPlan":
        survivors = dp * tp - lost_chips
        new_dp = 1
        while new_dp * 2 * tp <= survivors:
            new_dp *= 2
        if new_dp < 1:
            raise RuntimeError("not enough survivors for even dp=1")
        return cls(old_dp=dp, new_dp=new_dp, tp=tp)

    @property
    def chips(self) -> int:
        return self.new_dp * self.tp
