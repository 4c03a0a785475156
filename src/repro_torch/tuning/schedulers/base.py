"""The ``TrialScheduler`` seam: one driver loop, many allocation policies.

``Tuner._run_multi_fidelity`` used to *be* ASHA — the rung ladder's
promotion scan, preemption test and budget accounting were welded into
the async loop.  This package extracts the seam that loop and
``RungScheduler`` already implied, so HyperBand's bracket hedging and
PBT's exploit/explore forks plug into the *same* driver instead of
forking it.

Lifecycle contract (what the driver calls, in order)
----------------------------------------------------

1. ``replay(key, point, value, fidelity, ...)`` — once per checkpointed
   completion on resume, *before* the loop starts.  Returns the budget
   actually charged for the record (``0.0`` for duplicates and
   preempted placeholders), so resumed spend reconciles exactly once.
2. ``next_action()`` — while the executor has capacity: the scheduler's
   highest-priority follow-up work (an ASHA **promote**, a PBT next
   step or exploit/explore **fork**).  ``None`` means "nothing queued —
   offer me fresh candidates".
3. ``fresh_quota(capacity)`` / ``admit(key, point)`` — how many fresh
   engine candidates the scheduler will take, and the concrete
   :class:`TrialAction` (entry rung/fidelity/lineage) for each one.
   ``admit`` may return ``None`` to refuse a point (e.g. a full PBT
   population).
4. ``on_started(key, point, rung, lineage=...)`` — the action was
   dispatched to the executor.
5. ``decide(key, rung, lineage=...)`` — per in-flight task, each loop
   turn (only when preemption is enabled): ``"continue"`` or
   ``"preempt"``.  A ``"preempt"`` verdict goes to
   ``EvaluationExecutor.preempt``, which resolves the race three ways —
   ``cancelled`` (never started: the driver calls ``on_preempted``),
   ``running`` (let-it-finish: the verdict converges via that step's
   own ``on_result``) or ``done`` (completion won the race: recorded
   exactly once, never preempted).  The other two verdicts of the
   conceptual decide→{continue, promote, preempt, fork} lifecycle are
   spelled through ``next_action``: completion-driven schedulers don't
   interrupt a trial to promote or fork it, they queue the follow-up.
6. ``on_result(key, point, value, rung, fidelity=..., meta=...,
   lineage=...)`` — a measurement completed (any completion order).
   ``fidelity`` is what was actually delivered (budget accounting);
   ``meta`` may carry an evaluator ``fork_state`` checkpoint blob.
7. ``on_preempted(key, rung, lineage=...)`` — a ``decide``-issued
   preempt landed as ``cancelled``: nothing was measured.
8. ``stats()`` / ``snapshot()`` — observability: flat counter rows for
   bench/CI artifacts, and full JSON-able state for ``job_status`` and
   the resume-equality tests.

Exactly-once: the driver records a trial's history row iff
``on_result`` fired for it, and ``on_preempted`` fires only for the
``cancelled`` arm — a preempt that lands after the task completed is a
completion, not a preemption, for the scheduler too.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

#: ``decide`` verdicts.
CONTINUE = "continue"
PREEMPT = "preempt"


@dataclass
class TrialAction:
    """One unit of work the scheduler wants dispatched.

    ``rung`` is the scheduler's own coordinate for the trial (ASHA rung,
    HyperBand *global* rung = bracket offset + inner rung, PBT step
    index); the driver hands it back verbatim in ``on_result`` /
    ``decide`` / ``on_preempted``.  ``state`` is an opaque
    JSON-serializable evaluator checkpoint (``resume_state``) for
    checkpoint-fork schedulers; ``lineage`` names the trial's ancestry
    for History provenance, replay routing, and memo-key isolation of
    stateful steps.  ``kind`` is observability only ("start", "promote",
    "step", "fork").
    """

    point: Dict
    rung: int = 0
    fidelity: Optional[float] = None
    state: Optional[dict] = field(default=None, repr=False)
    lineage: Optional[str] = None
    kind: str = "start"


class TrialScheduler:
    """Base class: a no-op scheduler that admits everything at rung 0.

    Subclasses override the lifecycle hooks they care about; the base
    implementations are the degenerate "measure every candidate once at
    full fidelity" policy, so a subclass only implements its actual
    allocation logic.  See the module docstring for the full contract.
    """

    #: short policy name — config value, ``job_status`` display key
    kind: str = "trial"

    # -- admission ------------------------------------------------------------
    def fresh_quota(self, capacity: int) -> int:
        """How many *fresh* engine candidates to accept this turn (the
        driver never offers more than its free capacity)."""
        return capacity

    def admit(self, key: tuple, point: Dict) -> Optional[TrialAction]:
        """Entry action for a fresh candidate, or ``None`` to refuse it."""
        return TrialAction(point=dict(point))

    # -- scheduler-driven work ------------------------------------------------
    def next_action(self) -> Optional[TrialAction]:
        """Highest-priority queued follow-up (promotion / step / fork)."""
        return None

    # -- trial lifecycle ------------------------------------------------------
    def on_started(self, key: tuple, point: Dict, rung: int,
                   lineage: Optional[str] = None) -> None:
        pass

    def on_result(self, key: tuple, point: Dict, value: float, rung: int,
                  *, fidelity: Optional[float] = None,
                  meta: Optional[dict] = None,
                  lineage: Optional[str] = None) -> None:
        pass

    def decide(self, key: tuple, rung: int,
               lineage: Optional[str] = None) -> str:
        """``"continue"`` or ``"preempt"`` for an in-flight trial."""
        return CONTINUE

    def on_preempted(self, key: tuple, rung: int,
                     lineage: Optional[str] = None) -> None:
        pass

    # -- resume ---------------------------------------------------------------
    def replay(self, key: tuple, point: Dict, value: float, fidelity: float,
               *, rung: Optional[int] = None, lineage: Optional[str] = None,
               meta: Optional[dict] = None) -> float:
        """Rebuild state from one checkpointed completion; return the
        budget charged for it (0.0 when the record is a duplicate or a
        preempted placeholder)."""
        if meta and meta.get("preempted"):
            return 0.0
        return float(fidelity)

    # -- observability --------------------------------------------------------
    def stats(self) -> List[dict]:
        """Flat counter rows for bench/CI artifacts and status displays."""
        return []

    def snapshot(self):
        """Full JSON-able state (``job_status`` wire / resume equality)."""
        return self.stats()
