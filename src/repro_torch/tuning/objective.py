"""Explicit objective protocol for the tuning stack.

An *evaluator* maps a point (dict of backend-parameter values) to
``(value, meta)`` — always a 2-tuple, declared by the class attribute
``returns_meta = True``.  Plain value-returning callables (the common
case in tests and synthetic benchmarks) are adapted with
``FunctionEvaluator``; nothing downstream sniffs the return type with
``isinstance(value, tuple)`` any more.

Fidelity protocol
-----------------

An evaluator that can trade measurement cost for measurement quality
declares ``supports_fidelity = True`` and accepts an optional
``fidelity`` keyword in ``__call__``: a float in ``(0, 1]`` giving the
*fraction of a full measurement* to spend.  What the fraction means is
the evaluator's business — iteration count for a wall-clock harness
(``WallClockEvaluator``), analysis depth for a compile-and-analyze
harness (``RooflineEvaluator``), training epochs for a learned model.
The contract is only that:

* ``fidelity=None`` (or ``1.0``) is a **full measurement**: byte-for-byte
  the same behavior as calling the evaluator with no fidelity argument
  at all — the golden sequential traces are pinned against this, so a
  fidelity-capable evaluator must never let a full-fidelity request
  take a different code path than a plain call;
* lower fidelity costs less and may return a noisier/biased value;
* the evaluator reports the fidelity it actually delivered as
  ``meta["fidelity"]`` (the executor fills it in otherwise).

Evaluators that do *not* opt in are always measured at full fidelity:
the executor silently upgrades a low-fidelity request and records
``meta["fidelity"] = 1.0`` so a fidelity scheduler knows it got (and
paid for) the real thing.

Checkpoint-fork protocol (PBT)
------------------------------

An evaluator whose measurements can *continue from where a previous
step left off* — a wall-clock harness that keeps its warmup, a learned
model that keeps its weights — declares ``supports_fork = True`` and
accepts an optional ``resume_state`` keyword: the opaque blob a
previous step returned as ``meta["fork_state"]``.  The contract:

* ``fork_state`` must be **JSON-serializable** — it rides the remote v2
  task payload and the History checkpoint (a remote worker drops
  non-JSON meta with ``meta_error``, losing the lineage's warm start);
* ``resume_state=None`` (or absent) is a cold-start step, byte-for-byte
  the plain call — the golden traces are pinned against this;
* a step given a ``resume_state`` may be cheaper and/or continue an
  accumulating measurement; it returns the *next* ``fork_state`` so the
  lineage (or an exploit-fork clone of it) can continue.

Evaluators that do not opt in still work under PBT: every step is an
independent measurement of the member's current point (the executor
never forwards ``resume_state`` to them).

Cost attribution
----------------

An evaluator that knows its own measurement cost may declare it as
``meta["cost_seconds"]`` (a finite, non-negative number): the executor
records it as the evaluation's ``cost_seconds`` instead of the measured
wall-clock time.  This is the signal BO's cost-aware (EI-per-second)
acquisition trains its cost model on, so the declared number must be
the *recurring, steady-state* cost of measuring this configuration —
the timing loop — and must exclude one-time overhead that a repeat
measurement would not pay again (build, jit/compile, warmup).
``WallClockEvaluator`` declares exactly that; attribute compile time
separately (e.g. ``meta["build_seconds"]``) if it is worth recording.
Declare a cost whenever the harness can separate true measurement cost
from its own overhead, or when costs are simulated and should stay
deterministic.

This module is dependency-light on purpose: the executor and the core
tuner import it without pulling in torch.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple


class Evaluator:
    """Base class for objectives that return ``(value, meta)``.

    ``value`` is the throughput-like objective (higher is better;
    ``-inf`` marks a failed configuration) and ``meta`` is a
    JSON-serializable dict recorded alongside the evaluation.

    Subclasses that can cheapen a measurement set
    ``supports_fidelity = True`` and accept the optional ``fidelity``
    keyword; subclasses that can continue a measurement from a prior
    step's checkpoint set ``supports_fork = True`` and accept the
    optional ``resume_state`` keyword (see the module docstring for
    both contracts).
    """

    returns_meta = True
    supports_fidelity = False
    supports_fork = False

    def __call__(self, point: Dict,
                 fidelity: Optional[float] = None) -> Tuple[float, dict]:
        raise NotImplementedError


class FunctionEvaluator(Evaluator):
    """Adapt a plain scalar-returning callable to the (value, meta) protocol."""

    def __init__(self, fn: Callable[[Dict], float]):
        self.fn = fn

    def __call__(self, point: Dict,
                 fidelity: Optional[float] = None) -> Tuple[float, dict]:
        value = self.fn(point)
        if isinstance(value, tuple):
            raise TypeError(
                "plain objective callables must return a scalar; to attach "
                "metadata, subclass repro_torch.tuning.objective.Evaluator (or set "
                "returns_meta = True) and return (value, meta) explicitly"
            )
        return float(value), {}


class CountingEvaluator(Evaluator):
    """Wrap an evaluator and count real invocations.

    Memoized results (history or disk-backed memo cache) never reach the
    wrapped objective, so ``calls`` is the number of *actual*
    measurements — the quantity a shared memo cache is supposed to drive
    to zero on a repeated run.  Used by the cache-hit acceptance check in
    ``benchmarks/perf_iterations.py`` and the async-loop tests.
    Forwards ``fidelity``/``resume_state`` iff the wrapped evaluator
    supports the respective protocol.
    """

    def __init__(self, objective):
        self.inner = as_evaluator(objective)
        self.calls = 0

    @property
    def supports_fidelity(self) -> bool:
        return self.inner.supports_fidelity

    @property
    def supports_fork(self) -> bool:
        return getattr(self.inner, "supports_fork", False)

    def __call__(self, point: Dict,
                 fidelity: Optional[float] = None,
                 resume_state: Optional[dict] = None) -> Tuple[float, dict]:
        self.calls += 1
        kwargs = {}
        if resume_state is not None and self.supports_fork:
            kwargs["resume_state"] = resume_state
        if self.inner.supports_fidelity:
            return self.inner(point, fidelity=fidelity, **kwargs)
        return self.inner(point, **kwargs)


def as_evaluator(objective) -> Evaluator:
    """Normalize any objective to the explicit (value, meta) protocol."""
    if getattr(objective, "returns_meta", False):
        return objective
    return FunctionEvaluator(objective)
