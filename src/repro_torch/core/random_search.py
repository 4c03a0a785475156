"""Random-search baseline (not in the paper's trio; sanity reference)."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.engine import Engine
from repro_torch.core.history import History


class RandomSearch(Engine):
    name = "random"

    def ask(self, n: int, history: History) -> List[Dict]:
        batch: List[Dict] = []
        keys = set()
        for _ in range(n):
            p = self._unseen(history, self.space.sample(self.rng, 1)[0],
                             exclude=keys)
            keys.add(self.space.key(p))
            batch.append(p)
        return batch
