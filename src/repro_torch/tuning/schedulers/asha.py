"""Successive-halving rung scheduler for multi-fidelity tuning (ASHA).

The paper's dominant cost is the measurement itself: every probe pays a
full compile+measure cycle.  Most configurations can be rejected from a
cheap short measurement ("Auto-tuning TensorFlow Threading Model",
arXiv:1812.01665; AutoTVM, arXiv:1805.08166), so this module spends the
full measurement budget only on candidates that survive cheap screening:

* the **rung ladder** is a geometric fidelity schedule
  ``f_r = max_fidelity * eta^-(R-1-r)`` (e.g. eta=3, 3 rungs:
  1/9 -> 1/3 -> 1).  Fresh candidates enter at the bottom rung;
* **promotion** is asynchronous (ASHA, arXiv:1810.05934): there are no
  rung barriers — the moment a completed result sits in the top
  ``promote_quantile`` of its rung, it is eligible for resubmission at
  the next fidelity.  ``next_promotion`` scans rungs top-down so deeper
  (more informative) promotions win free workers first;
* a result outside the quantile simply stays where it is.  It is not
  discarded: rungs only grow, ``floor(n * quantile)`` grows with them,
  and a value can become promotable later once enough weaker results
  land below it;
* **preemption**: a promotion that is *in flight* when its source rung's
  cutoff rises above its own value is a dead man walking — its
  higher-fidelity measurement can no longer change the ranking it was
  promoted on.  ``dominated`` identifies such pendings so the driver can
  ``EvaluationExecutor.preempt`` them (cancelled if not yet started;
  recorded normally if a worker got there first — see executor docs for
  the exactly-once guarantee).

The scheduler is deliberately engine-agnostic: it talks in points and
values, sits between ``Tuner.run``'s async loop and the engine, and the
engine keeps seeing plain ``ask``/``tell`` — partial observations reach
BO as rows with a fidelity feature (see ``BayesOpt``), never as exact
values.  It implements the :class:`~repro_torch.tuning.schedulers.base.
TrialScheduler` seam (and is also the inner per-bracket engine of
HyperBand); the historical entry points (``next_promotion`` /
``dominated`` / positional ``on_*``) remain public API.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.tuning.schedulers.base import (CONTINUE, PREEMPT, TrialAction,
                                          TrialScheduler)


@dataclass
class RungState:
    """Bookkeeping for one rung of the ladder."""

    fidelity: float
    #: completed (key, value) measurements at this fidelity
    results: List[Tuple[tuple, float]] = field(default_factory=list)
    #: keys currently promoted out of this rung (in flight or done above)
    promoted: set = field(default_factory=set)
    # counters for the bench/CI rung statistics
    n_started: int = 0
    n_completed: int = 0
    n_promoted: int = 0
    n_preempted: int = 0


class RungScheduler(TrialScheduler):
    """Completion-driven successive halving over an executor's pendings.

    ``eta`` is the reduction factor (fidelity ratio between adjacent
    rungs *and* the default survivor fraction); ``min_fidelity`` bounds
    the bottom rung (the ladder is the longest geometric schedule whose
    bottom stays >= ``min_fidelity``); ``promote_quantile`` is the
    per-rung survivor fraction (default ``1/eta``).
    """

    kind = "asha"

    def __init__(
        self,
        *,
        eta: float = 3.0,
        min_fidelity: float = 0.1,
        max_fidelity: float = 1.0,
        promote_quantile: Optional[float] = None,
    ):
        if eta <= 1.0:
            raise ValueError(f"eta must exceed 1 (got {eta})")
        if not 0.0 < min_fidelity <= max_fidelity <= 1.0:
            raise ValueError(
                f"need 0 < min_fidelity <= max_fidelity <= 1 "
                f"(got {min_fidelity}, {max_fidelity})")
        self.eta = float(eta)
        self.quantile = (1.0 / eta if promote_quantile is None
                         else float(promote_quantile))
        if not 0.0 < self.quantile < 1.0:
            raise ValueError(f"promote_quantile in (0,1) (got {self.quantile})")
        # longest geometric ladder with bottom >= min_fidelity
        n_down = int(math.floor(
            math.log(max_fidelity / min_fidelity) / math.log(eta) + 1e-9))
        fidelities = [max_fidelity * eta ** -(n_down - r)
                      for r in range(n_down)] + [max_fidelity]
        self.rungs: List[RungState] = [RungState(f) for f in fidelities]
        self._points: Dict[tuple, Dict] = {}  # key -> point (for resubmission)
        self._value_at: Dict[Tuple[tuple, int], float] = {}
        self._replayed: Set[Tuple[tuple, int]] = set()

    # -- ladder shape ---------------------------------------------------------
    @property
    def n_rungs(self) -> int:
        return len(self.rungs)

    def fidelity(self, rung: int) -> float:
        return self.rungs[rung].fidelity

    @property
    def base_fidelity(self) -> float:
        return self.rungs[0].fidelity

    def is_top(self, rung: int) -> bool:
        return rung == self.n_rungs - 1

    def rung_for(self, fidelity: float) -> int:
        """Closest rung for a delivered fidelity (ties go up).  Used to
        rebuild rung state from a resumed checkpoint, where only the
        recorded fidelity survives."""
        return min(range(self.n_rungs),
                   key=lambda r: (abs(self.rungs[r].fidelity - fidelity),
                                  -r))

    def replay(self, key: tuple, point: Dict, value: float, fidelity: float,
               *, rung: Optional[int] = None, lineage: Optional[str] = None,
               meta: Optional[dict] = None) -> float:
        """Rebuild state from a checkpointed completion (resume path).

        Records the result at the nearest rung and — crucially — re-marks
        the source rung's ``promoted`` set for results above the bottom
        rung: a rung-r result only ever exists because the key was
        promoted out of rung r-1, and without the mark a resumed run
        would re-promote (and re-measure, re-charge, re-record) it.
        Counters stay untouched beyond ``on_result``'s: stats describe
        *this* run's scheduling work, not the replayed prefix's.

        Returns the budget charged for the record.  Preempted
        placeholders never measured anything and a checkpoint written
        around a preemption race can hold *both* a preempted and a
        completed record for the same (key, rung) — both used to be
        charged (and double-ranked).  Replay now skips preempted
        records and dedupes on (key, rung), charging 0.0 for the skip.
        """
        if meta and meta.get("preempted"):
            return 0.0
        r = self.rung_for(fidelity) if rung is None else int(rung)
        r = min(max(r, 0), self.n_rungs - 1)
        if (key, r) in self._replayed:
            return 0.0
        self._replayed.add((key, r))
        self.on_result(key, point, value, r)
        if r > 0:
            self.rungs[r - 1].promoted.add(key)
        return float(fidelity)

    # -- TrialScheduler seam --------------------------------------------------
    def admit(self, key: tuple, point: Dict) -> Optional[TrialAction]:
        """Fresh candidates enter the bottom rung."""
        return TrialAction(point=dict(point), rung=0,
                           fidelity=self.base_fidelity, kind="start")

    def next_action(self) -> Optional[TrialAction]:
        nxt = self.next_promotion()
        if nxt is None:
            return None
        point, rung = nxt
        return TrialAction(point=point, rung=rung,
                           fidelity=self.fidelity(rung), kind="promote")

    def decide(self, key: tuple, rung: int,
               lineage: Optional[str] = None) -> str:
        return PREEMPT if self.dominated(key, rung) else CONTINUE

    # -- completion-driven protocol ------------------------------------------
    def on_started(self, key: tuple, point: Dict, rung: int,
                   lineage: Optional[str] = None) -> None:
        """A measurement for ``key`` was dispatched at ``rung``."""
        self._points[key] = dict(point)
        self.rungs[rung].n_started += 1

    def on_result(self, key: tuple, point: Dict, value: float, rung: int,
                  *, fidelity: Optional[float] = None,
                  meta: Optional[dict] = None,
                  lineage: Optional[str] = None) -> None:
        """A measurement completed at ``rung`` (any completion order)."""
        state = self.rungs[rung]
        state.results.append((key, float(value)))
        state.n_completed += 1
        self._points[key] = dict(point)
        self._value_at[(key, rung)] = float(value)

    def _cutoff(self, rung: int) -> Tuple[Optional[float], int]:
        """(weakest promotable value, k) at ``rung``; (None, 0) while the
        rung is too small to rank anything."""
        finite = sorted((v for _, v in self.rungs[rung].results
                         if math.isfinite(v)), reverse=True)
        k = int(len(self.rungs[rung].results) * self.quantile)
        if k <= 0 or not finite:
            return None, 0
        k = min(k, len(finite))
        return finite[k - 1], k

    def next_promotion(self) -> Optional[Tuple[Dict, int]]:
        """Best promotable (point, target_rung), deepest rung first, or
        ``None`` when no rung currently has a promotable survivor."""
        for rung in range(self.n_rungs - 2, -1, -1):
            state = self.rungs[rung]
            cut, _k = self._cutoff(rung)
            if cut is None:
                continue
            best_key, best_val = None, -math.inf
            for key, value in state.results:
                if (value >= cut and value > best_val
                        and key not in state.promoted
                        and math.isfinite(value)):
                    best_key, best_val = key, value
            if best_key is not None:
                state.promoted.add(best_key)
                state.n_promoted += 1
                return dict(self._points[best_key]), rung + 1
        return None

    def dominated(self, key: tuple, target_rung: int) -> bool:
        """True when an in-flight promotion *to* ``target_rung`` has been
        outclassed: its source-rung value fell below the source rung's
        current cutoff, so finishing the expensive measurement cannot be
        justified by the ranking that scheduled it.

        The cutoff is not strictly monotone — ``k = floor(n * quantile)``
        can increment on weak arrivals and pull the cutoff *down* — so a
        candidate preempted against a transiently high cutoff may become
        promotable again and be rescheduled.  That is churn, not lost
        work: a cancelled preemption measured nothing (see
        ``EvaluationExecutor.preempt``), so the retry is the candidate's
        first actual measurement at that rung."""
        if target_rung <= 0:  # bottom-rung entries carry no prior value
            return False
        src = target_rung - 1
        value = self._value_at.get((key, src))
        if value is None:
            return False
        cut, _k = self._cutoff(src)
        return cut is not None and value < cut

    def on_preempted(self, key: tuple, target_rung: int,
                     lineage: Optional[str] = None) -> None:
        """A promotion was cancelled before it started: return the key to
        its source rung's unpromoted pool (rungs grow, so it may become
        promotable again later).  The preemption is counted on the
        *target* rung — the rung whose ``n_started`` it cancels — so the
        per-rung stats reconcile: started = completed + preempted +
        still-in-flight."""
        if target_rung <= 0:
            return
        self.rungs[target_rung - 1].promoted.discard(key)
        self.rungs[target_rung].n_preempted += 1

    # -- observability --------------------------------------------------------
    def stats(self) -> List[dict]:
        """Per-rung counters for the bench/CI artifact."""
        return [
            {"rung": r, "fidelity": round(s.fidelity, 6),
             "started": s.n_started, "completed": s.n_completed,
             "promoted": s.n_promoted, "preempted": s.n_preempted}
            for r, s in enumerate(self.rungs)
        ]

    def snapshot(self) -> List[dict]:
        """Full per-rung *state* (stats + result/promotion sets), in
        JSON-able form.  The tuning service ships this over the wire in
        ``job_status`` replies, and the resume tests pin it equal between
        a crashed-and-replayed scheduler and a never-crashed one.  Keys
        (grid-key tuples) are rendered as lists for JSON."""
        return [
            dict(row,
                 results=sorted(([list(k), v] for k, v
                                 in self.rungs[row["rung"]].results),
                                key=repr),
                 promoted=sorted((list(k) for k
                                  in self.rungs[row["rung"]].promoted),
                                 key=repr))
            for row in self.stats()
        ]
