"""Objective evaluators — the "system under test" side of paper Fig. 4.

* ``WallClockEvaluator`` — the paper-faithful measurement path: apply the
  configuration, run the step on the local device, report measured
  throughput (examples- or tokens-/second).

It implements the explicit evaluator protocol
(``repro_torch.tuning.objective.Evaluator``): ``__call__(point) -> (value,
meta)``, declared via ``returns_meta = True`` so the tuner/executor never
have to sniff return types, and opts into the **fidelity** protocol
(``supports_fidelity``) for multi-fidelity tuning by scaling its
variance-adaptive timing loop; a full-fidelity request takes exactly the
same code path as a plain no-fidelity call.

PyTorch runs eagerly and a CUDA launch returns before the card has done
the work, so every place where the reference package waits for a result
(``jax.block_until_ready``) synchronises the step's device here
(``torch.cuda.synchronize``); without it a CUDA step would time only its
launch.  The reference's ``RooflineEvaluator`` is not ported yet (ROADMAP
A13).
"""
from __future__ import annotations

import math
import time
from typing import Callable, Dict, Optional, Tuple

from repro_torch.tuning.objective import Evaluator


def _cuda_devices(obj, out: set) -> set:
    """The CUDA devices of every tensor in ``obj`` (nested tuples, lists
    and dicts of tensors)."""
    if isinstance(obj, (tuple, list)):
        for o in obj:
            _cuda_devices(o, out)
    elif isinstance(obj, dict):
        for o in obj.values():
            _cuda_devices(o, out)
    elif getattr(obj, "is_cuda", False):
        out.add(obj.device)
    return out


def _wait(out, args) -> None:
    """Wait until the step's work is done on its device: synchronise every
    CUDA device its output or its inputs lie on.  Work on the CPU is
    finished when the call returns."""
    devices = _cuda_devices((out, args), set())
    if devices:
        import torch

        for dev in devices:
            torch.cuda.synchronize(dev)


#: two-sided 95% Student-t critical values by degrees of freedom (1-30);
#: beyond 30 the normal 1.96 is within ~2%
_T95 = (12.706, 4.303, 3.182, 2.776, 2.571, 2.447, 2.365, 2.306, 2.262,
        2.228, 2.201, 2.179, 2.160, 2.145, 2.131, 2.120, 2.110, 2.101,
        2.093, 2.086, 2.080, 2.074, 2.069, 2.064, 2.060, 2.056, 2.052,
        2.048, 2.045, 2.042)


def _t95(df: int) -> float:
    return _T95[df - 1] if 1 <= df <= len(_T95) else 1.96


class WallClockEvaluator(Evaluator):
    """Measured throughput of a step built from the configuration point.

    ``make_step(point) -> (step_fn, args, examples_per_step)``:
    the builder applies the point's backend parameters (Runtime knobs,
    microbatches, ...) and returns a step plus its inputs.

    Measurement is **variance-adaptive**: steps are timed one at a time
    until the 95% confidence half-width of the mean step time is within
    ``rel_halfwidth`` of the mean, or ``max_iters`` measurements were
    taken — so a stable configuration stops after ``min_iters`` steps
    while a jittery one keeps measuring up to the cap.  The caps default
    off the caller's ``iters`` (``min_iters = 2`` — the CI needs two
    samples — and ``max_iters = 4 * iters``), so a harness sized for cheap
    measurements stays cheap: ``iters=3`` usually costs 2 steps and
    never more than 12.  Note the methodology: per-step variance needs a
    per-step device synchronise, so each sample includes one host/device
    round trip that the pipelined loop amortizes across ``iters`` steps —
    for sub-millisecond steps this inflates ``step_seconds`` slightly and
    uniformly.  ``adaptive=False`` is the fixed-``iters`` pipelined loop.

    Fidelity (``supports_fidelity``): a partial measurement scales the
    iteration cap by ``fidelity`` and widens the target CI by
    ``1/fidelity`` — the bottom successive-halving rung is a couple of
    quick steps with a loose interval, the top rung the full adaptive
    loop.  ``fidelity=None``/1.0 is byte-identical to a plain call.

    Cost attribution: ``meta["cost_seconds"]`` is the **measurement-only**
    time (the timing loop), excluding step build and warmup (which also
    absorbs a kernel's first-use build or JIT compile) — a repeat
    measurement of this configuration pays only the timing loop, so
    charging the build to the configuration would mislead cost-aware
    (EI-per-second) acquisition.  The one-time overhead is reported
    separately as ``meta["build_seconds"]``.
    """

    supports_fidelity = True

    def __init__(
        self,
        make_step: Callable[[Dict], Tuple[Callable, tuple, float]],
        *,
        warmup: int = 1,
        iters: int = 3,
        adaptive: bool = True,
        rel_halfwidth: float = 0.05,
        min_iters: Optional[int] = None,
        max_iters: Optional[int] = None,
    ):
        self.make_step = make_step
        self.warmup = warmup
        self.iters = iters
        self.adaptive = adaptive
        self.rel_halfwidth = rel_halfwidth
        # caps scale with the caller's iters so harnesses sized for cheap
        # measurements stay cheap; the CI needs >= 2 samples for a
        # variance estimate, so 2 is the floor either way
        self.max_iters = max(2, 4 * iters if max_iters is None else max_iters)
        self.min_iters = min(self.max_iters,
                             max(2, 2 if min_iters is None else min_iters))

    def _measure(self, step, args, fidelity: float):
        """Adaptive timing loop: per-step seconds list."""
        if not self.adaptive:
            n = max(1, round(self.iters * fidelity))
            t0 = time.perf_counter()
            out = None
            for _ in range(n):
                out = step(*args)
            _wait(out, args)
            return [(time.perf_counter() - t0) / n] * n
        cap = max(self.min_iters, math.ceil(self.max_iters * fidelity))
        target = self.rel_halfwidth / fidelity
        times = []
        while len(times) < cap:
            t0 = time.perf_counter()
            _wait(step(*args), args)
            times.append(time.perf_counter() - t0)
            n = len(times)
            if n < self.min_iters:
                continue
            mean = sum(times) / n
            var = sum((t - mean) ** 2 for t in times) / (n - 1)
            halfwidth = _t95(n - 1) * math.sqrt(var / n)
            if halfwidth <= target * mean:
                break
        return times

    def __call__(self, point: Dict,
                 fidelity: Optional[float] = None) -> Tuple[float, dict]:
        f = 1.0 if fidelity is None else max(min(float(fidelity), 1.0), 1e-3)
        t_build0 = time.perf_counter()
        step, args, examples = self.make_step(point)
        out = None
        for _ in range(self.warmup):
            out = step(*args)
        _wait(out, args)
        build_seconds = time.perf_counter() - t_build0
        times = self._measure(step, args, f)
        n = len(times)
        dt = sum(times) / n
        mean = dt
        hw = 0.0
        if n >= 2:
            var = sum((t - mean) ** 2 for t in times) / (n - 1)
            hw = _t95(n - 1) * math.sqrt(var / n)
        meta = {
            "step_seconds": dt,
            "iters": n,
            "ci_rel_halfwidth": hw / mean if mean > 0 else 0.0,
            "build_seconds": build_seconds,
            # measurement-only cost: what a repeat measurement would pay
            "cost_seconds": float(sum(times)),
        }
        if f < 1.0:  # a full-fidelity request is byte-identical to a
            meta["fidelity"] = f  # plain call, meta included
        return examples / dt, meta
