"""Exhaustive grid sweep (paper §4.3 Fig. 6 + the §1 cost argument)."""
from __future__ import annotations

from typing import Dict, Iterator, List

from repro_torch.core.engine import Engine
from repro_torch.core.history import History
from repro_torch.core.space import SearchSpace


class Exhaustive(Engine):
    name = "exhaustive"

    #: asks are a stateful enumeration, not independent suggestions: each
    #: ask consumes the one-shot grid iterator, so a point the transfer
    #: pre-filter discarded would never be re-proposed and the "exhaustive"
    #: sweep would silently skip part of the grid.  Opt out entirely.
    prefilter_safe = False

    def __init__(self, space: SearchSpace, seed: int = 0):
        super().__init__(space, seed)
        self._it: Iterator[Dict] = space.enumerate()

    def ask(self, n: int, history: History) -> List[Dict]:
        batch: List[Dict] = []
        while len(batch) < n:
            try:
                p = next(self._it)
            except StopIteration:
                break  # grid exhausted; [] tells the tuner to stop cleanly
            # skip grid points the history already holds (or that are in
            # flight): a resumed sweep continues where the crash left off
            # instead of burning budget re-recording memoized repeats
            if history.lookup(p) is not None or history.pending(p):
                continue
            batch.append(p)
        return batch
