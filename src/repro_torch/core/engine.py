"""Algorithm-engine interface (paper Fig. 4: algorithmic engines behind a
selection switch, all sharing the same history / system-under-test path).

Batched ask/tell contract
-------------------------

Engines expose two methods:

* ``ask(n, history) -> list[point]`` — propose up to ``n`` deduplicated
  candidate points.  The batch excludes points already evaluated
  (``history.seen``) and points currently in flight
  (``history.pending``), so a parallel executor can measure the whole
  batch concurrently without wasted repeats.
* ``tell(observations)`` — report measured results back as
  :class:`~repro_torch.core.observation.Observation` records (point, value,
  cost_seconds, fidelity, rung, meta — one object per completed
  measurement, the same schema the tuning service and the checkpoint
  snapshots serialize).  Under the completion-driven tuner loop,
  ``tell`` arrives *incrementally and in completion order*: typically
  one observation at a time, the moment its measurement finishes, which
  may not be the order the points were asked.  Engines must therefore
  tolerate partial and reordered feedback; the default implementation
  (``_tell``) forwards each observation to ``observe`` (the
  single-point state update), which is order-free and what most engines
  need, while engines with speculative batches (Nelder-Mead) buffer
  results and reconcile them against their state machine.  Each
  observation's ``cost_seconds`` is accumulated by the base class so
  engines can become wall-clock-aware (see ``mean_cost_seconds``).

  The historical keyword sprawl — ``tell(points, values, costs=...,
  fidelities=...)`` — remains as a deprecation shim: calls that pass
  ``values`` are converted to observations and emit a
  ``DeprecationWarning``.  The conversion is exact (costs default to
  0.0, fidelities to 1.0, like the old signature), so existing callers
  keep their behavior bit-for-bit.

``ask(1, ...)`` is guaranteed to consume the engine RNG exactly like the
historical single-point ``suggest`` did, so a sequential driver
(``parallelism=1``) reproduces the pre-batching suggestion trace
bit-for-bit for the same seed.  ``suggest`` remains as a thin
compatibility wrapper over ``ask(1, ...)``.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.history import History
from repro_torch.core.observation import Observation
from repro_torch.core.space import SearchSpace


class Engine:
    name = "base"

    #: whether the tuner's transfer pre-filter may over-ask this engine and
    #: measure only the top-ranked fraction of the batch.  Safe for engines
    #: whose asks are independent suggestions (random/GA/BO); engines whose
    #: asks consume irreplaceable state must opt out — Nelder-Mead's
    #: speculative batches require every asked point to eventually be told,
    #: and Exhaustive's one-shot grid iterator never re-proposes a point a
    #: filter dropped.
    prefilter_safe = True

    def __init__(self, space: SearchSpace, seed: int = 0):
        self.space = space
        self.rng = np.random.default_rng(seed)
        self._cost_log: List[float] = []  # measured seconds per told result
        #: set by engines whose ``ask`` pads the tail of an exhausted
        #: candidate pool with unranked random fills (warm-started BO):
        #: the count of *ranked* candidates at the head of the most
        #: recent batch, or ``None`` when the whole batch is ranked (or
        #: the engine makes no such distinction).  The tuner's transfer
        #: pre-filter re-ranks only the ranked head, so a random fill
        #: can never displace a candidate the engine actually ranked.
        self.last_ask_ranked: Optional[int] = None
        #: fraction of the wall-clock budget still left (None = no budget);
        #: updated by the tuner via ``note_budget`` so cost-aware engines can
        #: sharpen their cheap-probe preference as the deadline approaches
        self.budget_fraction_remaining: Optional[float] = None

    # -- batched contract -----------------------------------------------------
    def ask(self, n: int, history: History) -> List[Dict]:
        """Propose up to ``n`` deduplicated candidate points."""
        raise NotImplementedError

    def tell(self, observations: Sequence[Observation],
             values: Optional[Sequence[float]] = None,
             costs: Optional[Sequence[float]] = None,
             fidelities: Optional[Sequence[float]] = None) -> None:
        """Report completed measurements for previously asked points.

        ``observations`` is a sequence of :class:`Observation` records.
        May be called once per completed evaluation (completion order)
        or once per batch; both must leave the engine in the same state.

        ``Observation.fidelity`` (multi-fidelity tuning) marks values
        that came from partial measurements (< 1.0 = cheaper, noisier).
        The base implementation ignores it — engines whose state
        machines want exact values (GA's population, NMS's simplex)
        treat partial values as the ASHA literature does: good enough to
        rank on.  BayesOpt instead reads fidelities straight from the
        history as a surrogate input feature, so its GP never mistakes a
        partial value for an exact one.

        Engines customize by overriding :meth:`_tell`, never ``tell``
        itself: ``tell`` owns the legacy-signature shim (``tell(points,
        values, costs=..., fidelities=...)``, deprecated) and the cost
        accounting, so every engine sees one normalized observation
        stream.
        """
        obs = self._coerce_observations(observations, values, costs,
                                        fidelities)
        self._cost_log.extend(o.cost_seconds for o in obs)
        self._tell(obs)

    def _tell(self, observations: Sequence[Observation]) -> None:
        """Engine-specific state update; default forwards to ``observe``."""
        for o in observations:
            self.observe(o.point, o.value)

    @staticmethod
    def _coerce_observations(observations, values, costs,
                             fidelities) -> List[Observation]:
        if values is not None:  # legacy tell(points, values, ...) signature
            warnings.warn(
                "Engine.tell(points, values, costs=..., fidelities=...) is "
                "deprecated; pass a sequence of repro_torch.core.Observation",
                DeprecationWarning, stacklevel=3)
            points = observations
            return [
                Observation(
                    point=dict(p), value=float(v),
                    cost_seconds=(0.0 if costs is None else float(costs[i])),
                    fidelity=(1.0 if fidelities is None
                              else float(fidelities[i])))
                for i, (p, v) in enumerate(zip(points, values))
            ]
        out = list(observations)
        for o in out:
            if not isinstance(o, Observation):
                raise TypeError(
                    f"tell() takes Observation records, got {type(o).__name__}"
                    " (legacy point/value sequences must pass values= too)")
        return out

    @property
    def mean_cost_seconds(self) -> float:
        """Mean measured evaluation cost — the wall-clock-awareness hook."""
        paid = [c for c in self._cost_log if c > 0]
        return sum(paid) / len(paid) if paid else 0.0

    def note_budget(self, fraction_remaining: Optional[float]) -> None:
        """Tuner hook: report how much of the wall-clock budget is left.

        ``None`` clears budget pressure (no wall-clock budget configured).
        Engines are free to ignore this; BayesOpt's cost-aware acquisition
        uses it to ramp EI-per-second weighting in near the deadline.
        """
        self.budget_fraction_remaining = fraction_remaining

    # -- single-point compatibility shims ------------------------------------
    def suggest(self, history: History) -> Dict:
        """Deprecated single-point API; equivalent to ``ask(1, ...)[0]``."""
        return self.ask(1, history)[0]

    def observe(self, point: Dict, value: float) -> None:  # optional state
        pass

    # -- helpers -------------------------------------------------------------
    def _unseen(self, history: History, point: Dict, tries: int = 64,
                exclude: Optional[Set[Tuple]] = None) -> Dict:
        """Nudge a suggestion off already-evaluated / in-flight grid points.

        ``exclude`` carries the keys of points already emitted in the
        current batch so one ``ask`` never proposes duplicates.
        """
        exclude = exclude or set()

        def taken(p: Dict) -> bool:
            return (history.seen(p) or history.pending(p)
                    or self.space.key(p) in exclude)

        cand = point
        for radius in [1, 1, 2, 2, 3, 4] * (tries // 6 + 1):
            if not taken(cand):
                return cand
            cand = self.space.perturb(self.rng, cand, radius=radius)
        # grid may be nearly exhausted: fall back to random
        for _ in range(tries):
            cand = self.space.sample(self.rng, 1)[0]
            if not taken(cand):
                return cand
        return cand
