"""Scheduler zoo: budget-allocation policies behind one driver seam.

``Tuner._run_multi_fidelity`` is a scheduler-agnostic async driver; the
policy deciding *which trial gets the next worker slot and at what
fidelity* lives here, behind :class:`TrialScheduler`:

* :class:`RungScheduler` (``asha``) — successive halving on one
  geometric fidelity ladder; the default and the golden-traced policy;
* :class:`HyperBandScheduler` (``hyperband``) — several ASHA brackets
  with staggered min-fidelities, hedging against uninformative cheap
  measurements, budget split completion-driven;
* :class:`PBTScheduler` (``pbt``) — steady-state population with
  exploit/explore forks and evaluator checkpoint-fork support.

``build_scheduler`` maps a ``MultiFidelityConfig`` to an instance.
"""
from __future__ import annotations

from repro_torch.tuning.schedulers.asha import RungScheduler, RungState
from repro_torch.tuning.schedulers.base import (CONTINUE, PREEMPT, TrialAction,
                                          TrialScheduler)
from repro_torch.tuning.schedulers.hyperband import HyperBandScheduler
from repro_torch.tuning.schedulers.pbt import PBTScheduler

SCHEDULER_KINDS = ("asha", "hyperband", "pbt")


def build_scheduler(mf, *, space=None, seed: int = 0) -> TrialScheduler:
    """Instantiate the scheduler a ``MultiFidelityConfig`` names.

    ``space`` is required for PBT (the perturbation neighborhood);
    ``seed`` makes PBT's exploit/explore draws reproducible.
    """
    kind = getattr(mf, "scheduler", "asha") or "asha"
    if kind == "asha":
        return RungScheduler(eta=mf.eta, min_fidelity=mf.min_fidelity,
                             promote_quantile=mf.promote_quantile)
    if kind == "hyperband":
        hb = getattr(mf, "hyperband", None)
        return HyperBandScheduler(
            eta=mf.eta, min_fidelity=mf.min_fidelity,
            promote_quantile=mf.promote_quantile,
            brackets=getattr(hb, "brackets", None))
    if kind == "pbt":
        if space is None:
            raise ValueError("PBT needs the search space for explore")
        pbt = getattr(mf, "pbt", None)
        step = getattr(pbt, "step_fidelity", None)
        return PBTScheduler(
            space,
            population=getattr(pbt, "population", 6),
            exploit_quantile=getattr(pbt, "exploit_quantile", 0.25),
            perturb_prob=getattr(pbt, "perturb_prob", 0.25),
            step_fidelity=float(step) if step else mf.min_fidelity,
            seed=seed)
    raise ValueError(
        f"unknown scheduler {kind!r} (expected one of {SCHEDULER_KINDS})")


__all__ = [
    "CONTINUE", "PREEMPT", "SCHEDULER_KINDS", "TrialAction", "TrialScheduler",
    "RungScheduler", "RungState", "HyperBandScheduler", "PBTScheduler",
    "build_scheduler",
]
