"""Bayesian optimization engine (paper §2.2).

GP surrogate (gp.py) + acquisition maximization over a candidate set.
Acquisitions:

* ``smsego`` (paper default) — for each candidate, the optimistic estimate
  mu + c*sigma is compared against the best evaluation observed so far;
  the candidate maximizing the potential *extension* of the best value is
  selected (the single-objective S-metric-selection gain).
* ``ei``  — expected improvement (closed form).
* ``ucb`` — upper confidence bound.

The candidate set is the full grid when small, otherwise random samples
plus local perturbations of the incumbent (exploitation neighborhood).

``ask(n, ...)`` fits the surrogate once and returns the top-n candidates
by acquisition value (deduplicated, unseen), so a parallel executor can
measure a whole acquisition batch per GP fit; ``ask(1, ...)`` selects
exactly the argmax the single-point path always did.

Suggestion path
---------------

Under the completion-driven tuner loop every completed measurement
triggers a fresh ``ask``, so suggestion cost (the *ask time*) is on the
critical path:

* the GP is **persistent** across asks and refits are **warm-started**
  from the previous hyperparameters (short refinement schedule) once the
  training set reaches ``warm_start_min_n`` rows — below that the
  posterior is still moving fast enough that stale hyperparameters hurt;
  above it each Adam step pays a full Cholesky, which is exactly where 30
  warm steps beat 120 cold ones;
* acquisition scoring + ranking runs as one fused call
  (``GaussianProcess.acquisition_rank``) on the GP's device — the
  posterior never round-trips to numpy.  ``jit_acquisition=False``
  selects the vectorized numpy scoring path over ``posterior()`` instead
  (same ranking, no fusion).

The GP runs on ``device`` (``"cpu"`` unless the caller passes another,
e.g. through ``TunerConfig.engine_kwargs``); the engine never probes for
a card.

Cost-aware acquisition (``cost_aware=True``) divides the positive
acquisition mass by a per-candidate predicted measurement cost from a
second GP fit on log ``cost_seconds`` (EI-per-second, Snoek et al.,
2012).  When the tuner reports wall-clock budget pressure via
``note_budget``, the weighting ramps in as the deadline approaches, so
the engine prefers cheap probes exactly when the remaining budget can
only afford them.  Per-ask suggestion latency is recorded on
``ask_seconds``.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.engine import Engine
from repro_torch.core.gp import GaussianProcess
from repro_torch.core.history import History
from repro_torch.core.space import SearchSpace

_SQRT2 = math.sqrt(2.0)

try:  # erf over arrays without a Python loop
    from scipy.special import erf as _erf
except ImportError:  # pragma: no cover - scipy-less fallback
    def _erf(z):
        # Abramowitz & Stegun 7.1.26 — vectorized, |err| < 1.5e-7
        z = np.asarray(z, np.float64)
        sign = np.sign(z)
        t = 1.0 / (1.0 + 0.3275911 * np.abs(z))
        poly = t * (0.254829592 + t * (-0.284496736 + t * (
            1.421413741 + t * (-1.453152027 + t * 1.061405429))))
        return sign * (1.0 - poly * np.exp(-z * z))


def _norm_cdf(z):
    return 0.5 * (1.0 + _erf(np.asarray(z) / _SQRT2))


def _norm_pdf(z):
    return np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)


def _pearson(pred, actual) -> Optional[float]:
    p = np.asarray(pred, np.float64)
    a = np.asarray(actual, np.float64)
    if p.size != a.size or p.size < 2:
        return None
    if float(p.std()) == 0.0 or float(a.std()) == 0.0:
        return None
    return float(np.corrcoef(p, a)[0, 1])


@dataclass
class TransferPrior:
    """Prior observations from neighbor workloads (transfer warm-start).

    Built from :meth:`TuningCorpus.prior_observations` rows: encoded
    points + values + per-row workload distances.  The engine seeds its
    surrogate with these rows under inflated observation noise
    (:meth:`noise_scale` — proportional to workload distance, growing
    quadratically as real observations accumulate so the prior fades),
    and :meth:`predict` gives the cheap Nadaraya-Watson estimate the
    negative-transfer guard compares against the first real
    measurements.
    """

    points: List[Dict]
    X: np.ndarray           # encoded (k, d), no fidelity column
    y: np.ndarray           # (k,)
    distances: np.ndarray   # (k,) workload distance per row, in [0, 1]
    fidelities: np.ndarray = field(default=None)  # (k,), default all-1

    def __post_init__(self):
        self.X = np.asarray(self.X, np.float64)
        self.y = np.asarray(self.y, np.float64)
        self.distances = np.asarray(self.distances, np.float64)
        if self.fidelities is None:
            self.fidelities = np.ones_like(self.y)
        else:
            self.fidelities = np.asarray(self.fidelities, np.float64)

    @classmethod
    def from_rows(cls, space: SearchSpace, rows: List[Dict]) -> "TransferPrior":
        """Build from corpus ``prior_observations`` rows."""
        pts = [dict(r["point"]) for r in rows]
        return cls(
            points=pts,
            X=space.encode_many(pts),
            y=np.asarray([r["value"] for r in rows], np.float64),
            distances=np.asarray([r.get("distance", 0.0) for r in rows],
                                 np.float64),
            fidelities=np.asarray([r.get("fidelity", 1.0) for r in rows],
                                  np.float64),
        )

    def __len__(self) -> int:
        return int(self.y.shape[0])

    def best_point(self) -> Dict:
        return dict(self.points[int(np.argmax(self.y))])

    def predict(self, Xq: np.ndarray) -> np.ndarray:
        """Nadaraya-Watson estimate at encoded query points (RBF weights
        in the unit-cube encoding) — cheap enough for guard checks and
        candidate pre-filtering without a GP fit."""
        Xq = np.atleast_2d(np.asarray(Xq, np.float64))
        d2 = ((Xq[:, None, :] - self.X[None, :, :]) ** 2).sum(-1)
        w = np.exp(-d2 / (2.0 * 0.25 ** 2))
        den = w.sum(axis=1)
        num = w @ self.y
        return np.where(den > 1e-12, num / np.maximum(den, 1e-12),
                        float(self.y.mean()))

    def noise_scale(self, n_real: int, decay: int) -> np.ndarray:
        """Per-row observation-noise inflation (>= 1): base inflation
        proportional to workload distance, times a quadratic ramp in the
        real-observation count so prior rows fade as evidence arrives."""
        ramp = 1.0 + 9.0 * (n_real / max(decay, 1)) ** 2
        return (1.0 + 3.0 * self.distances) * ramp


class BayesOpt(Engine):
    name = "bo"

    def __init__(
        self,
        space: SearchSpace,
        seed: int = 0,
        n_init: int = 8,
        acquisition: str = "smsego",
        kappa: float = 2.0,
        max_candidates: int = 4096,
        kernel: str = "matern52",
        cost_aware: bool = False,
        jit_acquisition: bool = True,
        warm_start: bool = True,
        warm_start_min_n: int = 64,
        fidelity_feature: bool = False,
        transfer_prior: Optional[TransferPrior] = None,
        transfer_decay: int = 24,
        transfer_guard_n: int = 3,
        device="cpu",
    ):
        super().__init__(space, seed)
        self.n_init = min(n_init, max(2, space.grid_size() // 2))
        self.acquisition = acquisition
        self.kappa = kappa
        self.max_candidates = max_candidates
        self.kernel = kernel
        self.cost_aware = cost_aware
        self.jit_acquisition = jit_acquisition
        self.warm_start = warm_start
        self.warm_start_min_n = warm_start_min_n
        #: where the GP's tensors live (host-side control code: "cpu")
        self.device = device
        #: multi-fidelity mode: append each observation's fidelity as an
        #: extra GP input column (candidates are scored at fidelity 1.0),
        #: so partial measurements inform the surrogate without being
        #: mistaken for exact values.  Off by default: the single-fidelity
        #: suggestion trace stays bit-for-bit identical.
        self.fidelity_feature = fidelity_feature
        #: transfer warm-start: prior observations from neighbor workloads
        #: (None = cold start, the historical bit-for-bit path)
        self.transfer_prior = (transfer_prior if transfer_prior is not None
                               and len(transfer_prior) > 0 else None)
        self.transfer_decay = transfer_decay
        self.transfer_guard_n = transfer_guard_n
        self._prior_dropped = False   # negative-transfer guard tripped/retired
        self._prior_checked = False   # guard runs once
        self._prior_best_point = (self.transfer_prior.best_point()
                                  if self.transfer_prior is not None else None)
        self._init_points = None
        self._gp: Optional[GaussianProcess] = None
        self._cost_gp: Optional[GaussianProcess] = None
        self._grid_cache = None  # small grids: (points, encodings), immutable
        # per-ask observability (consumed by benchmarks + the CI gate)
        self.ask_seconds: List[float] = []

    def _candidates(self, history: History):
        """Return ``(cands, Xs)``: candidate points + their encodings.

        Small grids are enumerated and encoded exactly once per engine
        (the grid is immutable); each ask just slices out the unseen
        rows, keeping host-side Python work off the per-completion
        suggestion path.
        """
        if self.space.grid_size() <= self.max_candidates:
            if self._grid_cache is None:
                pts = list(self.space.enumerate())
                self._grid_cache = (pts, self.space.encode_many(pts))
            pts, enc = self._grid_cache
            idx = [i for i, p in enumerate(pts) if not history.seen(p)]
            if not idx:
                return pts, enc
            return [pts[i] for i in idx], enc[idx]
        cands = self.space.sample(self.rng, self.max_candidates // 2)
        # local neighborhood of the incumbent (exploitation half); in
        # fidelity mode the incumbent must be a full measurement — a
        # partial value's optimistic bias would center exploitation on
        # measurement noise (same guard as y_best in _ask)
        if (self._prior_best_point is not None
                and not np.isfinite(history.values()).any()):
            # transfer mode before the first finite real measurement:
            # exploit around the neighbor workload's best (the no-prior
            # path never reaches here without >= 2 finite values)
            best = self._prior_best_point
        else:
            best = history.best(full_fidelity_only=self.fidelity_feature and bool(
                np.any((history.fidelities() >= 1.0)
                       & np.isfinite(history.values())))).point
        for _ in range(self.max_candidates // 2):
            cands.append(self.space.perturb(self.rng, best, radius=2))
        seen_keys = set()
        out = []
        for c in cands:
            k = self.space.key(c)
            if k not in seen_keys and not history.seen(c):
                seen_keys.add(k)
                out.append(c)
        out = out or cands
        return out, self.space.encode_many(out)

    # -- surrogate maintenance ------------------------------------------------
    def _fit_surrogate(self, X: np.ndarray, y: np.ndarray,
                       noise_scale: Optional[np.ndarray] = None
                       ) -> GaussianProcess:
        """Refit the persistent GP, warm-starting from the previous fit.

        Warm-start policy: cold refits below ``warm_start_min_n`` rows
        (keeps the small-history suggestion trace stable), warm
        refinement above
        (each Adam step pays a Cholesky there, so 30 warm steps beat
        120 cold ones).  ``noise_scale`` (transfer mode) inflates
        per-row observation noise for prior-workload rows.
        """
        if self._gp is None:
            self._gp = GaussianProcess(kind=self.kernel, device=self.device)
        params0 = (self._gp.params
                   if self.warm_start and X.shape[0] >= self.warm_start_min_n
                   else None)
        self._gp.fit(X, y, params0=params0, noise_scale=noise_scale)
        return self._gp

    def _fit_cost_model(self, X: np.ndarray,
                        history: History) -> Optional[GaussianProcess]:
        """GP over log measurement cost; None until >= 2 costs were paid."""
        if not self.cost_aware:
            return None
        costs = history.costs()
        paid = costs > 0
        if paid.sum() < 2 or float(costs[paid].std()) == 0.0:
            return None
        filled = np.where(paid, costs, costs[paid].mean())
        log_cost = np.log(np.maximum(filled, 1e-6))
        if self._cost_gp is None:
            self._cost_gp = GaussianProcess(kind=self.kernel, device=self.device)
        # same warm-start policy as the value GP: cold while small (the
        # cost posterior is still moving fast), warm refinement above
        params0 = (self._cost_gp.params
                   if self.warm_start and X.shape[0] >= self.warm_start_min_n
                   else None)
        self._cost_gp.fit(X, log_cost, params0=params0)
        return self._cost_gp

    def _cost_alpha(self) -> float:
        """EI-per-second exponent: full strength without budget info, else
        ramping 0 -> 1 as the wall-clock budget nears exhaustion."""
        frac = self.budget_fraction_remaining
        if frac is None:
            return 1.0
        return float(np.clip(1.0 - frac, 0.0, 1.0))

    # -- acquisition scoring --------------------------------------------------
    def _rank_numpy(self, gp: GaussianProcess, Xs: np.ndarray, y_best: float,
                    cost_gp: Optional[GaussianProcess]) -> np.ndarray:
        """Vectorized numpy scoring over ``posterior()`` (no fusion)."""
        post = gp.posterior(Xs)
        if self.acquisition == "ucb":
            acq = post.mu + self.kappa * post.sigma
        elif self.acquisition == "ei":
            z = (post.mu - y_best) / np.maximum(post.sigma, 1e-12)
            acq = (post.mu - y_best) * _norm_cdf(z) + post.sigma * _norm_pdf(z)
        elif self.acquisition == "smsego":
            # single-objective SMSego gain: how far the optimistic estimate
            # extends the best observation (epsilon-dominance guard keeps
            # pure-exploitation candidates from pinning the search)
            optimistic = post.mu + self.kappa * post.sigma
            eps = 1e-3 * max(abs(y_best), 1.0)
            gain = optimistic - (y_best + eps)
            acq = np.where(gain > 0, gain, gain * 1e-3)  # soft penalty below best
        else:
            raise ValueError(self.acquisition)
        if cost_gp is not None:
            rel = (np.exp(cost_gp.posterior(Xs).mu)
                   / max(self.mean_cost_seconds, 1e-9))
            rel = np.clip(rel, 1e-2, 1e2) ** self._cost_alpha()
            acq = np.where(acq > 0, acq / rel, acq * rel)
        return np.argsort(-acq, kind="stable")

    def _rank(self, gp: GaussianProcess, Xs: np.ndarray, y_best: float,
              cost_gp: Optional[GaussianProcess]) -> np.ndarray:
        if not self.jit_acquisition:
            return self._rank_numpy(gp, Xs, y_best, cost_gp)
        order, _ = gp.acquisition_rank(
            Xs, self.acquisition, y_best, kappa=self.kappa,
            cost_gp=cost_gp, cost_alpha=self._cost_alpha(),
            mean_cost=self.mean_cost_seconds)
        return order

    def ask(self, n: int, history: History) -> List[Dict]:
        t0 = time.perf_counter()
        self.last_ask_ranked = None  # set by _ask_transfer when it pads
        try:
            return self._ask(n, history)
        finally:
            self.ask_seconds.append(time.perf_counter() - t0)

    # -- transfer warm-start --------------------------------------------------
    def _active_prior(self, history: History) -> Optional[TransferPrior]:
        """The transfer prior if it should still shape this ask, else None.

        The prior retires after ``transfer_decay`` real observations (by
        then its inflated noise has drowned it anyway), and is dropped
        permanently — negative-transfer guard — if its predictions
        anti-correlate with the first ``transfer_guard_n`` finite real
        measurements.
        """
        if self.transfer_prior is None or self._prior_dropped:
            return None
        if len(history) >= self.transfer_decay:
            self._prior_dropped = True
            return None
        if not self._prior_checked:
            X, y = history.encoded()
            finite = np.isfinite(y)
            if int(finite.sum()) >= self.transfer_guard_n:
                self._prior_checked = True
                agree = _pearson(self.transfer_prior.predict(X[finite]),
                                 y[finite])
                if agree is not None and agree < 0.0:
                    self._prior_dropped = True
                    return None
        return self.transfer_prior

    def _ask_transfer(self, n: int, history: History,
                      prior: TransferPrior) -> List[Dict]:
        """Ask with the surrogate seeded by prior-workload observations.

        No LHS init phase: the prior already covers the space, which is
        where the warm start's measurement savings come from.  Prior rows
        enter the GP under inflated per-row noise; the cost model stays
        off while the prior is active (prior rows carry no cost on this
        hardware, and the cost GP must share the value GP's training
        inputs).
        """
        batch: List[Dict] = []
        keys = set()

        def emit(point: Dict) -> None:
            keys.add(self.space.key(point))
            batch.append(point)

        n_real = len(history)
        if n_real:
            X, y = history.encoded()
        else:
            X = np.zeros((0, prior.X.shape[1]))
            y = np.zeros((0,))
        finite = np.isfinite(y)
        # failed real configs get the worst value on hand (pessimism)
        floor = float(y[finite].min()) if finite.any() else float(prior.y.min())
        y_real = np.where(finite, y, floor)
        Xall = np.concatenate([prior.X, X], axis=0)
        yall = np.concatenate([prior.y, y_real])
        noise = np.concatenate([prior.noise_scale(n_real, self.transfer_decay),
                                np.ones(y_real.shape[0])])
        if self.fidelity_feature:
            fid = np.concatenate([prior.fidelities, history.fidelities()]
                                 if n_real else [prior.fidelities])
            Xall = np.concatenate([Xall, fid[:, None]], axis=1)

        gp = self._fit_surrogate(Xall, yall, noise_scale=noise)
        cands, Xs = self._candidates(history)
        if self.fidelity_feature:
            Xs = np.concatenate([Xs, np.ones((Xs.shape[0], 1))], axis=1)
        # incumbent: best finite real measurement, else the prior's best
        y_best = (float(y[finite].max()) if finite.any()
                  else float(prior.y.max()))
        order = self._rank(gp, Xs, y_best, None)

        for i in order:
            if len(batch) == n:
                break
            c = cands[int(i)]
            k = self.space.key(c)
            if k in keys or history.seen(c) or history.pending(c):
                continue
            emit(dict(c))
        # everything past this index is an unranked random fill, not an
        # acquisition-ranked suggestion: report the boundary so the
        # tuner's pre-filter never promotes a fill over a ranked point
        self.last_ask_ranked = len(batch)
        while len(batch) < n:  # candidate set exhausted: random fill
            emit(self._unseen(history, self.space.sample(self.rng, 1)[0],
                              exclude=keys))
        return batch

    def _ask(self, n: int, history: History) -> List[Dict]:
        prior = self._active_prior(history)
        if prior is not None:
            return self._ask_transfer(n, history, prior)
        if self._init_points is None:
            self._init_points = self.space.sample_lhs(self.rng, self.n_init)
        batch: List[Dict] = []
        keys = set()

        def emit(point: Dict) -> None:
            keys.add(self.space.key(point))
            batch.append(point)

        # LHS init phase (possibly only the head of the batch)
        while (len(batch) < n
               and len(history) + history.n_pending() + len(batch) < self.n_init):
            idx = len(history) + history.n_pending() + len(batch)
            emit(self._unseen(history, self._init_points[idx], exclude=keys))
        if len(batch) == n:
            return batch

        X, y = history.encoded()
        finite = np.isfinite(y)
        if finite.sum() < 2:
            while len(batch) < n:
                emit(self._unseen(history, self.space.sample(self.rng, 1)[0],
                                  exclude=keys))
            return batch
        # failed configs (OOM etc.) get the worst finite value (pessimism)
        y = np.where(finite, y, y[finite].min())
        if self.fidelity_feature:
            # fidelity is an input feature: the GP learns how partial
            # measurements relate to full ones instead of treating a
            # cheap noisy value as ground truth
            X = np.concatenate([X, history.fidelities()[:, None]], axis=1)

        gp = self._fit_surrogate(X, y)
        cost_gp = self._fit_cost_model(X, history)
        cands, Xs = self._candidates(history)
        if self.fidelity_feature:
            # candidates are scored as full measurements
            Xs = np.concatenate([Xs, np.ones((Xs.shape[0], 1))], axis=1)
            # ... and the incumbent must be one too: a partial value's
            # optimistic bias would otherwise set a y_best no full
            # measurement can beat, collapsing the acquisition
            full = finite & (history.fidelities() >= 1.0)
            y_best = float(np.max(y[full])) if full.any() else float(np.max(y))
        else:
            y_best = float(np.max(y))
        order = self._rank(gp, Xs, y_best, cost_gp)

        # top-n by acquisition; stable sort so n=1 picks np.argmax's candidate
        for i in order:
            if len(batch) == n:
                break
            c = cands[int(i)]
            k = self.space.key(c)
            if k in keys or (len(batch) > 0 and
                             (history.seen(c) or history.pending(c))):
                continue
            emit(dict(c))
        while len(batch) < n:  # candidate set exhausted: random fill
            emit(self._unseen(history, self.space.sample(self.rng, 1)[0],
                              exclude=keys))
        return batch
