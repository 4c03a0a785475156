"""Genetic-algorithm engine (paper §2.2).

Faithful to the paper's description: at each iteration the history is
reordered by a fitness function, the inputs of the two fittest pairs are
selected as parents, a child is produced by *crossover* (each component
copied from one of the two parents) and *mutation* (components flipped to
purely random values with small probability).

``ask(n, ...)`` emits a *generation*: n distinct children bred from the
current two fittest parents, which is the natural unit of parallel
measurement for a GA.

Under the completion-driven tuner loop the GA becomes *steady-state*:
results are told (and land in the shared history) one at a time in
completion order, and each replacement child is bred from the two
fittest individuals *at that moment* — there is no generation barrier,
so a strong early-finishing individual starts parenting immediately.
The engine itself stays stateless between calls: parent selection reads
the history, which is exactly what makes out-of-order insertion safe.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.core.engine import Engine
from repro_torch.core.history import History
from repro_torch.core.space import SearchSpace


class GeneticAlgorithm(Engine):
    name = "ga"

    def __init__(
        self,
        space: SearchSpace,
        seed: int = 0,
        n_init: int = 6,
        mutation_rate: float = 0.15,
        tournament: int = 0,  # 0 => paper's plain two-fittest selection
    ):
        super().__init__(space, seed)
        self.n_init = min(n_init, max(2, space.grid_size() // 2))
        self.mutation_rate = mutation_rate
        self.tournament = tournament
        self._init_points = None

    def _select_parents(self, history: History):
        order = sorted(
            (e for e in history.evals if np.isfinite(e.value)),
            key=lambda e: -e.value,
        )
        if len(order) < 2:
            return None
        if self.tournament:
            def pick():
                return max(
                    self.rng.choice(order,
                                    size=min(self.tournament, len(order)),
                                    replace=False),
                    key=lambda e: e.value,
                )
            return pick().point, pick().point
        return order[0].point, order[1].point

    def _breed(self, pa: Dict, pb: Dict) -> Dict:
        child = {}
        for d in self.space.dims:
            # crossover: copy the component from one of the two parents
            child[d.name] = pa[d.name] if self.rng.random() < 0.5 else pb[d.name]
            # mutation: occasionally a purely random value
            if self.rng.random() < self.mutation_rate:
                child[d.name] = d.values[self.rng.integers(len(d.values))]
        return child

    def ask(self, n: int, history: History) -> List[Dict]:
        if self._init_points is None:
            self._init_points = self.space.sample_lhs(self.rng, self.n_init)
        batch: List[Dict] = []
        keys = set()
        while len(batch) < n:
            idx = len(history) + history.n_pending() + len(batch)
            if idx < self.n_init:
                p = self._unseen(history, self._init_points[idx], exclude=keys)
            else:
                parents = self._select_parents(history)
                if parents is None:
                    p = self._unseen(history, self.space.sample(self.rng, 1)[0],
                                     exclude=keys)
                else:
                    p = self._unseen(history, self._breed(*parents),
                                     exclude=keys)
            keys.add(self.space.key(p))
            batch.append(p)
        return batch
