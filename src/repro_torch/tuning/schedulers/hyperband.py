"""HyperBand: bracket hedging over ASHA ladders (arXiv:1603.06560).

ASHA's single ladder bakes in one answer to "how cheap can a screening
measurement be before its ranking stops predicting the full-fidelity
ranking?".  When low fidelities are informative, a deep ladder wins by
screening widely; when they are noise, a shallow ladder (or plain full
measurement) wins by not wasting budget on them.  HyperBand hedges:
run several brackets — ASHA ladders with *staggered* minimum
fidelities, from the deepest geometric ladder down to a single
full-fidelity rung — and split the measurement budget across them.

This implementation keeps the substrate completion-driven (no
synchronized bracket rounds, matching our ASHA):

* each bracket ``s`` (``s = s_max .. 0``) is an inner
  :class:`RungScheduler` with ``min_fidelity = max_fidelity * eta^-s``;
  ``s = 0`` degenerates to one full-fidelity rung;
* **budget split is completion-driven**: a fresh candidate is admitted
  to the bracket with the least fidelity-spend so far, so brackets
  converge to equal budget shares (HyperBand's ``B/(s_max+1)``) without
  a precomputed schedule.  Spend is charged at dispatch (the ladder
  fidelity), trued-up to the delivered fidelity at completion, and
  refunded on a cancelled preemption;
* promotions are served from the *least-spent* bracket first, so a
  bracket that fell behind (e.g. all its trials were preempted) catches
  up the moment it has promotable work;
* trials carry their bracket as ``lineage="b<idx>"`` (History
  provenance + replay routing) and a **global rung id** = bracket
  offset + inner rung, so the driver and executor stay
  bracket-oblivious.  Results themselves are stateless and keyed by
  (point, fidelity) alone — two brackets that measure the same point at
  the same fidelity share the memo hit, which is a feature, not a
  collision.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.tuning.schedulers.asha import RungScheduler
from repro_torch.tuning.schedulers.base import (CONTINUE, PREEMPT, TrialAction,
                                          TrialScheduler)


class HyperBandScheduler(TrialScheduler):
    """Multiple ASHA brackets with staggered min-fidelities.

    ``brackets`` caps how many ladders to run (default: the full
    ``s_max + 1`` the fidelity range supports; always the *deepest*
    ladders first, since the shallow ones are subsets).
    """

    kind = "hyperband"

    def __init__(
        self,
        *,
        eta: float = 3.0,
        min_fidelity: float = 0.1,
        max_fidelity: float = 1.0,
        promote_quantile: Optional[float] = None,
        brackets: Optional[int] = None,
    ):
        # the deepest ladder the fidelity range supports fixes s_max
        deepest = RungScheduler(eta=eta, min_fidelity=min_fidelity,
                                max_fidelity=max_fidelity,
                                promote_quantile=promote_quantile)
        s_max = deepest.n_rungs - 1
        n = s_max + 1 if brackets is None else int(brackets)
        if not 1 <= n <= s_max + 1:
            raise ValueError(
                f"brackets must be in [1, {s_max + 1}] for "
                f"min_fidelity={min_fidelity} (got {brackets})")
        self.eta = float(eta)
        self.brackets: List[RungScheduler] = [deepest]
        for s in range(s_max - 1, s_max - n, -1):
            self.brackets.append(RungScheduler(
                eta=eta,
                min_fidelity=max_fidelity * eta ** -s if s else max_fidelity,
                max_fidelity=max_fidelity,
                promote_quantile=promote_quantile))
        # global rung id = bracket offset + inner rung
        self._offsets: List[int] = []
        off = 0
        for b in self.brackets:
            self._offsets.append(off)
            off += b.n_rungs
        self._spend: List[float] = [0.0] * len(self.brackets)

    # -- bracket plumbing -----------------------------------------------------
    def _locate(self, rung: int) -> tuple:
        """Global rung id -> (bracket index, inner rung)."""
        for i in range(len(self.brackets) - 1, -1, -1):
            if rung >= self._offsets[i]:
                inner = min(rung - self._offsets[i],
                            self.brackets[i].n_rungs - 1)
                return i, inner
        return 0, 0

    def _bracket_of(self, lineage: Optional[str],
                    rung: Optional[int]) -> Optional[int]:
        """Replay routing: lineage ("b<idx>") first, global rung second."""
        if lineage and lineage.startswith("b"):
            try:
                i = int(lineage[1:])
                if 0 <= i < len(self.brackets):
                    return i
            except ValueError:
                pass
        if rung is not None:
            return self._locate(int(rung))[0]
        return None

    @property
    def base_fidelity(self) -> float:
        return self.brackets[0].base_fidelity

    # -- TrialScheduler seam --------------------------------------------------
    def admit(self, key: tuple, point: Dict) -> Optional[TrialAction]:
        """Fresh candidates feed the least-spent bracket (completion-
        driven budget split: brackets equalize spend asymptotically)."""
        i = min(range(len(self.brackets)), key=lambda j: (self._spend[j], j))
        b = self.brackets[i]
        self._spend[i] += b.base_fidelity  # planned; trued-up at on_result
        return TrialAction(point=dict(point), rung=self._offsets[i],
                           fidelity=b.base_fidelity,
                           lineage=f"b{i}", kind="start")

    def next_action(self) -> Optional[TrialAction]:
        for i in sorted(range(len(self.brackets)),
                        key=lambda j: (self._spend[j], j)):
            nxt = self.brackets[i].next_promotion()
            if nxt is None:
                continue
            point, inner = nxt
            fid = self.brackets[i].fidelity(inner)
            self._spend[i] += fid  # planned; trued-up at on_result
            return TrialAction(point=point, rung=self._offsets[i] + inner,
                               fidelity=fid, lineage=f"b{i}", kind="promote")
        return None

    def on_started(self, key: tuple, point: Dict, rung: int,
                   lineage: Optional[str] = None) -> None:
        i, inner = self._locate(rung)
        self.brackets[i].on_started(key, point, inner)

    def on_result(self, key: tuple, point: Dict, value: float, rung: int,
                  *, fidelity: Optional[float] = None,
                  meta: Optional[dict] = None,
                  lineage: Optional[str] = None) -> None:
        i, inner = self._locate(rung)
        b = self.brackets[i]
        if fidelity is not None:  # true up planned -> delivered spend
            self._spend[i] += float(fidelity) - b.fidelity(inner)
        b.on_result(key, point, value, inner)

    def decide(self, key: tuple, rung: int,
               lineage: Optional[str] = None) -> str:
        i, inner = self._locate(rung)
        return PREEMPT if self.brackets[i].dominated(key, inner) else CONTINUE

    def on_preempted(self, key: tuple, rung: int,
                     lineage: Optional[str] = None) -> None:
        i, inner = self._locate(rung)
        self._spend[i] -= self.brackets[i].fidelity(inner)  # measured nothing
        self.brackets[i].on_preempted(key, inner)

    def replay(self, key: tuple, point: Dict, value: float, fidelity: float,
               *, rung: Optional[int] = None, lineage: Optional[str] = None,
               meta: Optional[dict] = None) -> float:
        if meta and meta.get("preempted"):
            return 0.0
        i = self._bracket_of(lineage, rung)
        if i is None:  # pre-lineage checkpoint: deepest ladder hosts it
            i = 0
        inner = (self.brackets[i].rung_for(fidelity) if rung is None
                 else min(max(int(rung) - self._offsets[i], 0),
                          self.brackets[i].n_rungs - 1))
        charged = self.brackets[i].replay(key, point, value, fidelity,
                                          rung=inner, meta=meta)
        self._spend[i] += charged
        return charged

    # -- observability --------------------------------------------------------
    def stats(self) -> List[dict]:
        """Per-rung rows across all brackets; rungs are *global* ids and
        every row names its bracket, so generic rung renderers still
        work and bracket-aware ones can group."""
        rows = []
        for i, b in enumerate(self.brackets):
            for row in b.stats():
                rows.append(dict(row, rung=self._offsets[i] + row["rung"],
                                 bracket=i))
        return rows

    def snapshot(self) -> dict:
        return {
            "brackets": [
                {"bracket": i,
                 "min_fidelity": round(b.base_fidelity, 6),
                 "spend": round(self._spend[i], 6),
                 "rungs": b.snapshot()}
                for i, b in enumerate(self.brackets)
            ],
        }
