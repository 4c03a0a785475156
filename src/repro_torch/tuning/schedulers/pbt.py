"""Population-Based Training over tuning configs (arXiv:1711.09846).

PBT keeps a steady-state **population** of trials stepping forever
(until the budget runs out): each completed step re-ranks the
population, the bottom quantile is culled, and every cull is replaced
by **exploit + explore** — clone a random top-quantile member (its
point *and* its evaluator checkpoint, the ``fork_state`` blob) and
perturb the clone's point.  Unlike ASHA/HyperBand there is no ladder:
the ``rung`` coordinate is the member's **step index**, every step runs
at one fixed ``step_fidelity``, and a trial's identity is its
``lineage`` (``m<k>``), not its point — the point *mutates* along the
lineage.

Checkpoint-fork protocol
------------------------

An evaluator that can continue a measurement from where a previous step
left off declares ``supports_fork = True``, accepts a ``resume_state=``
keyword (the blob a previous step returned as ``meta["fork_state"]``,
JSON-serializable — it rides the remote v2 task payload and the History
checkpoint), and returns the next blob in its own ``meta``.  Stateless
evaluators work too: every step is then an independent measurement of
the member's current point, which still gives exploit/explore over the
search space — just without warm-started measurements.

Exactly-once under preemption: a doomed member (culled while its step
is in flight) is preempted via ``decide()``.  If the preempt lands as
``cancelled`` the step measured nothing and ``on_preempted`` forks the
replacement; if the step completed first, its ``on_result`` sees the
doom mark and forks then.  Either way exactly one fork replaces the
member and the step is recorded at most once.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.tuning.schedulers.base import (CONTINUE, PREEMPT, TrialAction,
                                          TrialScheduler)

_IDLE, _QUEUED, _RUNNING = "idle", "queued", "running"


class _Member:
    __slots__ = ("lineage", "point", "value", "state", "steps",
                 "status", "doomed", "parent")

    def __init__(self, lineage: str, point: Dict, *,
                 state: Optional[dict] = None, steps: int = 0,
                 value: Optional[float] = None,
                 parent: Optional[str] = None):
        self.lineage = lineage
        self.point = dict(point)
        self.value = value          # latest step's objective value
        self.state = state          # latest fork_state blob (opaque)
        self.steps = steps          # completed steps; next step's rung
        self.status = _IDLE
        self.doomed = False
        self.parent = parent


class PBTScheduler(TrialScheduler):
    """Steady-state exploit/explore population.

    ``space`` supplies the perturbation neighborhood (each dim's value
    list) and is only duck-typed (``dims`` with ``name``/``values``).
    ``exploit_quantile`` is both the cull fraction (bottom) and the
    donor pool fraction (top); ``perturb_prob`` is the per-dimension
    mutation probability (at least one dim always moves, or explore
    would be a no-op clone).
    """

    kind = "pbt"

    def __init__(
        self,
        space,
        *,
        population: int = 6,
        exploit_quantile: float = 0.25,
        perturb_prob: float = 0.25,
        step_fidelity: float = 1.0,
        seed: int = 0,
    ):
        if population < 2:
            raise ValueError(f"population must be >= 2 (got {population})")
        if not 0.0 < exploit_quantile < 0.5:
            raise ValueError(
                f"exploit_quantile in (0, 0.5) (got {exploit_quantile})")
        if not 0.0 < perturb_prob <= 1.0:
            raise ValueError(f"perturb_prob in (0, 1] (got {perturb_prob})")
        if not 0.0 < step_fidelity <= 1.0:
            raise ValueError(f"step_fidelity in (0, 1] (got {step_fidelity})")
        self._space = space
        self.population = int(population)
        self.exploit_quantile = float(exploit_quantile)
        self.perturb_prob = float(perturb_prob)
        self.step_fidelity = float(step_fidelity)
        self._rng = random.Random(int(seed) * 2654435761 % (2 ** 31) + 17)
        self._members: Dict[str, _Member] = {}   # insertion-ordered
        self._n_lineages = 0
        self._n_admitted = 0
        #: admission count at the last under-populated defer (see
        #: ``next_action``); None = not currently deferring
        self._deferred_at: Optional[int] = None
        self._replayed: Set[Tuple[str, int]] = set()
        self.n_forks = 0
        self.n_preempted = 0
        self.n_steps = 0

    # -- population ranking ---------------------------------------------------
    def _valued(self) -> List[_Member]:
        return [m for m in self._members.values() if m.value is not None]

    def _k(self, n: int) -> int:
        return max(1, int(n * self.exploit_quantile))

    def _bottom(self) -> List[_Member]:
        """Cull candidates: bottom quantile, only once the whole
        population has a value to rank (never cull against unknowns)."""
        if len(self._members) < self.population:
            return []
        valued = self._valued()
        if len(valued) < len(self._members):
            return []
        ranked = sorted(valued, key=lambda m: (m.value, m.lineage))
        return ranked[:self._k(len(ranked))]

    def _donor(self) -> Optional[_Member]:
        """A random top-quantile member (exploit source)."""
        valued = [m for m in self._valued() if not m.doomed]
        if not valued:
            return None
        ranked = sorted(valued, key=lambda m: (m.value, m.lineage),
                        reverse=True)
        return self._rng.choice(ranked[:self._k(len(ranked))])

    def _perturb(self, point: Dict) -> Dict:
        """Explore: mutate each dim with ``perturb_prob`` — numeric dims
        step to a neighboring grid value, categoricals resample.  At
        least one dim always moves."""
        new = dict(point)
        dims = [d for d in self._space.dims if len(list(d.values)) > 1]
        if not dims:
            return new
        moved = False
        for d in dims:
            if self._rng.random() >= self.perturb_prob:
                continue
            new[d.name] = self._neighbor(d, new.get(d.name))
            moved = True
        if not moved:
            d = self._rng.choice(dims)
            new[d.name] = self._neighbor(d, new.get(d.name))
        return new

    def _neighbor(self, dim, current):
        vals = list(dim.values)
        try:
            i = vals.index(current)
        except ValueError:
            i = None
        numeric = all(isinstance(v, (int, float))
                      and not isinstance(v, bool) for v in vals)
        if numeric and i is not None:
            j = i + (1 if self._rng.random() < 0.5 else -1)
            if not 0 <= j < len(vals):
                j = i - (j - i)
            return vals[j]
        j = self._rng.randrange(len(vals))
        if i is not None and j == i:
            j = (j + 1) % len(vals)
        return vals[j]

    def _fork_from(self, donor: _Member) -> _Member:
        lin = f"m{self._n_lineages}"
        self._n_lineages += 1
        child = _Member(lin, self._perturb(donor.point),
                        state=donor.state, steps=donor.steps,
                        value=None, parent=donor.lineage)
        self._members[lin] = child
        self.n_forks += 1
        return child

    def _replace(self, member: _Member) -> Optional[_Member]:
        donor = self._donor()
        if donor is None or donor.lineage == member.lineage:
            return None
        self._members.pop(member.lineage, None)
        return self._fork_from(donor)

    # -- TrialScheduler seam --------------------------------------------------
    def fresh_quota(self, capacity: int) -> int:
        """Fresh engine candidates only seed the initial population;
        afterwards all new blood arrives by exploit/explore forks."""
        return max(0, min(capacity, self.population - len(self._members)))

    def admit(self, key: tuple, point: Dict) -> Optional[TrialAction]:
        if len(self._members) >= self.population:
            return None
        lin = f"m{self._n_lineages}"
        self._n_lineages += 1
        self._n_admitted += 1
        self._deferred_at = None  # admission works: keep preferring it
        self._members[lin] = _Member(lin, point)
        return self._action(self._members[lin], kind="start")

    def _action(self, member: _Member, kind: str = "step") -> TrialAction:
        member.status = _QUEUED
        return TrialAction(point=dict(member.point), rung=member.steps,
                           fidelity=self.step_fidelity, state=member.state,
                           lineage=member.lineage, kind=kind)

    def next_action(self) -> Optional[TrialAction]:
        if len(self._members) < self.population:
            # under-populated: yield the capacity to fresh admission
            # (the driver only asks the engine with what next_action
            # left over, so stepping now would starve the seeding).
            # If a whole driver cycle passes with no admission at all —
            # engine exhausted, every candidate a duplicate — stop
            # waiting and step the members we have.
            if self._deferred_at != self._n_admitted:
                self._deferred_at = self._n_admitted
                return None
        # a replayed checkpoint may resurrect culled lineages: shed the
        # weakest idle extras before stepping anyone
        while len(self._members) > self.population:
            idle = [m for m in self._members.values() if m.status == _IDLE]
            if not idle:
                break
            worst = min(idle, key=lambda m: (m.value is not None,
                                             m.value if m.value is not None
                                             else 0.0, m.lineage))
            self._members.pop(worst.lineage)
        bottom = {m.lineage for m in self._bottom()}
        # least-stepped idle member first: the population advances in
        # rough lockstep, so ranking always compares peers (a member
        # allowed to run ahead would win on accumulated steps alone)
        order = {lin: i for i, lin in enumerate(self._members)}
        idle = sorted((m for m in self._members.values()
                       if m.status == _IDLE),
                      key=lambda m: (m.steps, order[m.lineage]))
        for member in idle:
            if member.value is not None and member.lineage in bottom:
                forked = self._replace(member)
                if forked is not None:
                    return self._action(forked, kind="fork")
            return self._action(member)
        return None

    def on_started(self, key: tuple, point: Dict, rung: int,
                   lineage: Optional[str] = None) -> None:
        member = self._members.get(lineage or "")
        if member is not None:
            member.status = _RUNNING

    def on_result(self, key: tuple, point: Dict, value: float, rung: int,
                  *, fidelity: Optional[float] = None,
                  meta: Optional[dict] = None,
                  lineage: Optional[str] = None) -> None:
        self.n_steps += 1
        member = self._members.get(lineage or "")
        if member is None:
            return  # step of a lineage culled while racing; value recorded
        member.status = _IDLE
        member.value = float(value)
        member.steps = max(member.steps, int(rung) + 1)
        if meta and meta.get("fork_state") is not None:
            member.state = meta["fork_state"]
        if member.doomed:  # culled while running; fork now, exactly once
            member.doomed = False
            self._replace(member)
            return
        # re-rank: doom in-flight bottom-quantile members so decide()
        # preempts their (now pointless) steps
        for m in self._bottom():
            if m.status == _RUNNING:
                m.doomed = True

    def decide(self, key: tuple, rung: int,
               lineage: Optional[str] = None) -> str:
        member = self._members.get(lineage or "")
        if member is not None and member.doomed and member.status == _RUNNING:
            return PREEMPT
        return CONTINUE

    def on_preempted(self, key: tuple, rung: int,
                     lineage: Optional[str] = None) -> None:
        """The doomed member's step was cancelled unstarted: fork its
        replacement immediately (the other arm of the race is
        ``on_result``'s doom check)."""
        self.n_preempted += 1
        member = self._members.get(lineage or "")
        if member is None:
            return
        member.status = _IDLE
        member.doomed = False
        self._replace(member)

    def replay(self, key: tuple, point: Dict, value: float, fidelity: float,
               *, rung: Optional[int] = None, lineage: Optional[str] = None,
               meta: Optional[dict] = None) -> float:
        """Rebuild the population from checkpointed steps.  The latest
        step per lineage wins (point/value/fork_state); duplicates of
        one (lineage, step) and preempted placeholders charge nothing."""
        if meta and meta.get("preempted"):
            return 0.0
        lin = lineage or "m?"
        step = 0 if rung is None else int(rung)
        if (lin, step) in self._replayed:
            return 0.0
        self._replayed.add((lin, step))
        member = self._members.get(lin)
        if member is None:
            member = self._members[lin] = _Member(lin, point)
            if lin.startswith("m"):
                try:
                    self._n_lineages = max(self._n_lineages,
                                           int(lin[1:]) + 1)
                except ValueError:
                    pass
        if step + 1 >= member.steps or member.value is None:
            member.point = dict(point)
            member.value = float(value)
            member.steps = max(member.steps, step + 1)
            if meta and meta.get("fork_state") is not None:
                member.state = meta["fork_state"]
        return float(fidelity)

    # -- observability --------------------------------------------------------
    def stats(self) -> List[dict]:
        values = sorted(m.value for m in self._valued())
        n = len(values)
        median = (None if n == 0 else
                  values[n // 2] if n % 2 else
                  0.5 * (values[n // 2 - 1] + values[n // 2]))
        return [{
            "members": len(self._members),
            "steps": self.n_steps,
            "forks": self.n_forks,
            "preempted": self.n_preempted,
            "best": max(values) if values else None,
            "median": median,
        }]

    def snapshot(self) -> dict:
        return {
            "population": self.population,
            "forks": self.n_forks,
            "preempted": self.n_preempted,
            "steps": self.n_steps,
            "members": [
                {"lineage": m.lineage, "point": dict(m.point),
                 "value": m.value, "steps": m.steps, "status": m.status,
                 "doomed": m.doomed, "parent": m.parent,
                 "has_state": m.state is not None}
                for m in self._members.values()
            ],
        }
