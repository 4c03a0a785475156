"""Nelder-Mead simplex engine on the integer-stepped grid (paper §2.2;
TensorTuner's algorithm).

Standard reflection / expansion / contraction / shrink in the unit-cube
encoding, with every probe snapped to the grid.  The engine is a state
machine driven by ``ask``/``tell`` so it plugs into the same iteration
loop as BO and GA; NMS's known failure mode — clustering around local
optima and never touching parameter-range extremes — is exactly what the
paper's Table 2 measures.

Batching: NMS is inherently sequential, so ``ask(n>1, ...)`` pads the
primary probe with *speculative* candidates — the expansion and both
contraction probes that would follow a reflection, or the whole
precomputed shrink queue.

Completion-order reconciliation: under the completion-driven tuner loop,
``tell`` arrives one result at a time in *completion* order, so a
speculative probe can land before the primary it was speculating past.
``tell`` therefore stashes every reported result in a buffer and drains
the buffer through the state machine for as long as the value the
machine expects next is available.  A probe that completes late (or was
never needed) simply stays buffered and is consumed the moment the
machine reaches it — or never, which is free, since the tuner's history
memoizes it anyway.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.engine import Engine
from repro_torch.core.history import History
from repro_torch.core.space import SearchSpace

ALPHA, GAMMA, RHO, SIGMA = 1.0, 2.0, 0.5, 0.5


class NelderMead(Engine):
    name = "nms"
    # the speculative-batch state machine expects every asked probe to be
    # told eventually; dropping probes (transfer pre-filter) would wedge it
    prefilter_safe = False

    def __init__(self, space: SearchSpace, seed: int = 0, init_radius: float = 0.25):
        super().__init__(space, seed)
        d = space.n_dims
        x0 = self.rng.random(d)
        verts = [x0]
        for i in range(d):
            v = x0.copy()
            v[i] = np.clip(v[i] + (init_radius if v[i] < 0.5 else -init_radius), 0, 1)
            verts.append(v)
        self._pending: List[np.ndarray] = verts  # vertices awaiting values
        self._simplex: List[Tuple[np.ndarray, float]] = []
        self._phase = "init"
        self._xr: Optional[np.ndarray] = None
        self._fr: Optional[float] = None
        self._xprobe: Optional[np.ndarray] = None
        self._shrink_queue: List[np.ndarray] = []
        self._told: Dict[Tuple, Tuple[Dict, float]] = {}  # completion buffer

    # -- state machine --------------------------------------------------------
    def _order(self):
        self._simplex.sort(key=lambda t: -t[1])  # best (max) first

    def _centroid(self) -> np.ndarray:
        pts = [x for x, _ in self._simplex[:-1]]
        return np.mean(pts, axis=0)

    def _primary(self) -> Dict:
        """The one point the state machine needs next."""
        if self._phase == "init":
            return self.space.decode(self._pending[len(self._simplex)])
        if self._phase in ("reflect", "expand", "contract", "shrink"):
            return self.space.decode(self._xprobe)
        raise RuntimeError(self._phase)

    def ask(self, n: int, history: History) -> List[Dict]:
        if self._phase == "init":
            # the remaining simplex vertices are a natural batch
            lo = len(self._simplex)
            hi = min(lo + n, len(self._pending))
            batch, keys = [], set()
            for x in self._pending[lo:hi]:
                p = self.space.decode(x)
                k = self.space.key(p)
                if k not in keys:  # distinct vertices may snap to one cell
                    keys.add(k)
                    batch.append(p)
            return batch

        primary = self._primary()
        batch = [primary]
        keys = {self.space.key(primary)}

        def spec(x: np.ndarray) -> None:
            p = self.space.decode(x)
            k = self.space.key(p)
            if k not in keys:
                keys.add(k)
                batch.append(p)

        if self._phase == "reflect" and n > 1 and len(self._simplex) >= 2:
            # speculate on every outcome of the reflection step
            xc = self._centroid()
            xr = self.space.encode(primary)  # grid-snapped reflection point
            spec(np.clip(xc + GAMMA * (xr - xc), 0, 1))        # expansion
            spec(np.clip(xc + RHO * (xr - xc), 0, 1))          # outside contraction
            spec(np.clip(xc + RHO * (self._simplex[-1][0] - xc), 0, 1))  # inside
        elif self._phase == "shrink":
            for x in self._shrink_queue:  # precomputed: measure them all
                spec(x)
        return batch[:n]

    def _tell(self, observations) -> None:
        for o in observations:
            self._told.setdefault(self.space.key(o.point), (o.point, o.value))
        # drain: consume buffered results for as long as the state machine's
        # next expected point has already been measured (handles primaries
        # and speculative probes completing in any order)
        while True:
            exp = self._primary()
            k = self.space.key(exp)
            if k not in self._told:
                break  # next expected value still in flight / never asked
            p, v = self._told.pop(k)
            self.observe(p, v)

    def observe(self, point: Dict, value: float) -> None:
        if not np.isfinite(value):
            value = -np.inf
        x = self.space.encode(point)
        if self._phase == "init":
            self._simplex.append((x, value))
            if len(self._simplex) == len(self._pending):
                self._start_reflect()
            return

        if self._phase == "reflect":
            self._order()
            f_best = self._simplex[0][1]
            f_second_worst = self._simplex[-2][1]
            f_worst = self._simplex[-1][1]
            self._xr, self._fr = x, value
            if value > f_best:
                xc = self._centroid()
                self._xprobe = np.clip(xc + GAMMA * (self._xr - xc), 0, 1)
                self._phase = "expand"
            elif value > f_second_worst:
                self._simplex[-1] = (self._xr, value)
                self._start_reflect()
            else:
                xc = self._centroid()
                base = self._xr if value > f_worst else self._simplex[-1][0]
                self._xprobe = np.clip(xc + RHO * (base - xc), 0, 1)
                self._phase = "contract"
            return

        if self._phase == "expand":
            if value > self._fr:
                self._simplex[-1] = (x, value)
            else:
                self._simplex[-1] = (self._xr, self._fr)
            self._start_reflect()
            return

        if self._phase == "contract":
            f_worst = self._simplex[-1][1]
            if value > max(f_worst, self._fr if self._fr is not None else -np.inf):
                self._simplex[-1] = (x, value)
                self._start_reflect()
            else:  # shrink toward best
                self._order()
                best = self._simplex[0][0]
                self._shrink_queue = [
                    np.clip(best + SIGMA * (xi - best), 0, 1)
                    for xi, _ in self._simplex[1:]
                ]
                self._simplex = [self._simplex[0]]
                self._phase = "shrink"
                self._xprobe = self._shrink_queue.pop(0)
            return

        if self._phase == "shrink":
            self._simplex.append((x, value))
            if self._shrink_queue:
                self._xprobe = self._shrink_queue.pop(0)
            else:
                self._start_reflect()
            return

    def _start_reflect(self):
        self._order()
        xc = self._centroid()
        worst = self._simplex[-1][0]
        self._xprobe = np.clip(xc + ALPHA * (xc - worst), 0, 1)
        self._phase = "reflect"
