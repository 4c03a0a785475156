"""Gaussian-process surrogate (paper §2.2) in PyTorch.

ARD RBF / Matérn-5/2 kernels; hyperparameters (log-lengthscales, log
signal variance, log noise) fit by maximising the log marginal likelihood
with Adam on its closed-form gradient, ½·tr((K⁻¹ − ααᵀ)·∂K/∂θ) (the GP
itself is white-box — the *objective* is the black box).  Cholesky-based
posterior, y standardised internally in float64 numpy, the GP computed in
float32.

This is the host-side control code of the BO engine: tens to hundreds of
training rows, one Cholesky and one inverse per Adam step.  The fit runs
on the host in numpy whatever the ``device`` (each step is a handful of
operations on tiny arrays, where eager tensors' per-operation cost would
dominate); the posterior and the ranking run where ``device`` says,
``"cpu"`` by default; nothing here probes for a card.  It fits on the
live rows only: nothing compiles per shape, so there is no shape
bucketing and no padding mask.

Failed factorisations keep the fallback chain of the reference GP: a
matrix that is not positive definite factors to NaN (``cholesky_ex`` with
``info > 0`` becomes NaN instead of raising), the NaN travels through the
Adam steps and the clipping box into a non-finite NLL, and the fit falls
back to a cold refit, then to safe defaults; a non-finite posterior or
acquisition is retried once with a noise floor of 1e-1.

Warm starts: ``fit(X, y, params0=...)`` resumes Adam from a previous
fit's hyperparameters and runs the short ``warm_steps`` schedule (120
cold / 30 warm by default).

``acquisition_rank`` fuses posterior + acquisition (EI / UCB / SMSego,
optionally cost-aware EI-per-second against a second cost GP) + ranking
in one call that returns sorted candidate indices; the (n, m) covariance
stays on the GP's device.

The GP sets no global thread setting: the number of threads is one of
the knobs the tuner tunes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_JITTER = 1e-5
_DTYPE = torch.float32

# Adam's epsilon and the hyperparameter box of the reference fit
_ADAM_EPS = 1e-8
_BOX = {"log_ls": (math.log(1e-2), math.log(1e2)),
        "log_sigma2": (math.log(1e-3), math.log(1e3)),
        "log_noise": (math.log(1e-4), math.log(1.0))}
_SAFE_NOISE = math.log(1e-1)
_KEYS = ("log_ls", "log_sigma2", "log_noise")


def _sqdist(X1: torch.Tensor, X2: torch.Tensor, ls: torch.Tensor) -> torch.Tensor:
    a = X1 / ls
    b = X2 / ls
    return ((a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :]
            - 2.0 * a @ b.T).clamp_min(0.0)


def kernel_fn(kind: str, X1, X2, ls, sigma2) -> torch.Tensor:
    d2 = _sqdist(X1, X2, ls)
    if kind == "rbf":
        return sigma2 * torch.exp(-0.5 * d2)
    if kind == "matern52":
        d = torch.sqrt(d2 + 1e-12)
        s = math.sqrt(5.0) * d
        return sigma2 * (1.0 + s + s * s / 3.0) * torch.exp(-s)
    raise ValueError(kind)


def _gram(kind: str, X, ls, sigma2, noise) -> torch.Tensor:
    """Gram matrix plus the (per-row) observation noise on its diagonal."""
    K = kernel_fn(kind, X, X, ls, sigma2)
    return K + torch.diag_embed(noise.expand(X.shape[0]))


def _cholesky(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; NaN where the factorisation failed.

    ``torch.linalg.cholesky`` raises on a matrix that is not positive
    definite; the fallback chain needs the NaN that the reference's
    factorisation returns instead, and needs it in the gradient too, so
    the NaN is added rather than substituted."""
    L, info = torch.linalg.cholesky_ex(K)
    bad = torch.where(info > 0, torch.tensor(math.nan, dtype=L.dtype, device=L.device),
                      torch.tensor(0.0, dtype=L.dtype, device=L.device))
    return L + bad


def _chol_alpha(params: Dict, X, y, kind: str, noise_row=None):
    ls = torch.exp(params["log_ls"])
    sigma2 = torch.exp(params["log_sigma2"])
    noise = torch.exp(params["log_noise"]) + _JITTER
    if noise_row is not None:
        # per-row observation-noise scale (>= 1), used by transfer warm
        # starts to down-weight prior-workload rows
        noise = noise * noise_row
    Lc = _cholesky(_gram(kind, X, ls, sigma2, noise))
    alpha = torch.cholesky_solve(y[:, None], Lc, upper=False)[:, 0]
    return Lc, alpha, ls, sigma2


def _neg_mll(params: Dict, X, y, kind: str, noise_row=None) -> torch.Tensor:
    n = X.shape[0]
    Lc, alpha, _, _ = _chol_alpha(params, X, y, kind, noise_row)
    mll = (-0.5 * (y @ alpha)
           - torch.log(torch.diagonal(Lc)).sum()
           - 0.5 * n * math.log(2 * math.pi))
    return -mll


def _pack(params: Dict) -> np.ndarray:
    """(log_ls..., log_sigma2, log_noise) as one host vector."""
    return np.concatenate([params[k].detach().cpu().numpy().reshape(-1) for k in _KEYS])


def _sq_diffs(X: np.ndarray) -> np.ndarray:
    """Per-dimension squared differences (x_ik - x_jk)², as (n·n, d)."""
    diff = X[:, None, :] - X[None, :, :]
    return (diff * diff).reshape(-1, X.shape[1])


def _neg_mll_grad(theta: np.ndarray, D2: np.ndarray, y: np.ndarray, kind: str,
                  noise_row: Optional[np.ndarray] = None) -> np.ndarray:
    """Closed-form gradient of ``_neg_mll`` with respect to ``_pack``'s vector.

    ∂NLL/∂θ = ½·tr((K⁻¹ − ααᵀ)·∂K/∂θ), with r² = Σ_k (x_ik − x_jk)²/ℓ_k²,
    ∂K/∂log ℓ_k = ∂K/∂r² · (−2 (x_ik − x_jk)²/ℓ_k²), ∂K/∂log σ² = K
    without the noise, and ∂K/∂log noise = diag(exp(log_noise) · noise_row).
    A factorisation that fails gives NaN, as ``_cholesky`` does."""
    n, d = y.shape[0], D2.shape[1]
    ils2 = np.exp(-2.0 * theta[:d])
    r2 = (D2 @ ils2).reshape(n, n)
    sigma2, noise0 = np.exp(theta[d]), np.exp(theta[d + 1])
    if kind == "rbf":
        K0 = sigma2 * np.exp(-0.5 * r2)
        dK_dr2 = -0.5 * K0
    elif kind == "matern52":
        s = math.sqrt(5.0) * np.sqrt(r2 + 1e-12)
        e = np.exp(-s)
        K0 = sigma2 * (1.0 + s + s * s / 3.0) * e
        dK_dr2 = (-5.0 / 6.0) * sigma2 * (1.0 + s) * e
    else:
        raise ValueError(kind)
    scale = 1.0 if noise_row is None else noise_row
    K = K0.copy()
    K.flat[::n + 1] += (noise0 + _JITTER) * scale
    L, info = torch.linalg.cholesky_ex(torch.from_numpy(K))
    if info:
        return np.full_like(theta, math.nan)
    Kinv = torch.cholesky_inverse(L).numpy()
    alpha = Kinv @ y
    A = Kinv - np.outer(alpha, alpha)
    g_ls = -((A * dK_dr2).reshape(-1) @ D2) * ils2
    g_noise = 0.5 * noise0 * np.sum(np.diagonal(A) * scale)
    return np.concatenate([g_ls, [0.5 * np.vdot(A, K0), g_noise]]).astype(theta.dtype)


def _fit(params0: Dict, X, y, kind: str, steps: int, lr: float,
         noise_row=None) -> Dict:
    """Adam on the negative MLL, written out: β = (0.9, 0.999), bias
    correction by the step count, ε outside the square root, the
    hyperparameters clipped into their box after every step.

    Runs on the host in numpy, in the dtype of ``X``, on the gradient of
    ``_neg_mll_grad`` (its factor and inverse by torch on CPU tensors that
    share the arrays' memory): tens of rows make every step a handful of
    tiny array operations, where the per-operation cost of eager tensors
    would dominate.  Returns tensors on ``X``'s device."""
    Xn, yn = X.detach().cpu().numpy(), y.detach().cpu().numpy()
    row = None if noise_row is None else noise_row.detach().cpu().numpy()
    D2 = _sq_diffs(Xn)
    theta = _pack(params0).astype(Xn.dtype)
    d = theta.shape[0] - 2
    lo, hi = np.array([_BOX[k] for k in ("log_ls",) * d + _KEYS[1:]], Xn.dtype).T
    m, v = np.zeros_like(theta), np.zeros_like(theta)
    b1, b2 = Xn.dtype.type(0.9), Xn.dtype.type(0.999)
    for t in range(1, steps + 1):
        g = _neg_mll_grad(theta, D2, yn, kind, row)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        step = theta - lr * (m / (1 - b1 ** t)) / (np.sqrt(v / (1 - b2 ** t)) + _ADAM_EPS)
        theta = np.clip(step, lo, hi)
    as_tensor = lambda a: torch.tensor(a, dtype=X.dtype, device=X.device)
    return {"log_ls": as_tensor(theta[:d]), "log_sigma2": as_tensor(theta[d]),
            "log_noise": as_tensor(theta[d + 1])}


def _posterior_core(params: Dict, X, y, Xs, kind: str, noise_row=None):
    Lc, alpha, ls, sigma2 = _chol_alpha(params, X, y, kind, noise_row)
    Ks = kernel_fn(kind, X, Xs, ls, sigma2)  # (n, m)
    mu = Ks.T @ alpha
    v = torch.linalg.solve_triangular(Lc, Ks, upper=False)
    var = sigma2 - (v * v).sum(0)
    return mu, var.clamp_min(1e-12)


def _acq_rank(params: Dict, X, y, Xs, y_mean, y_std, y_best, kappa, eps,
              cost_params: Dict, cost_y, cost_mean, cost_std,
              cost_alpha, mean_cost,
              kind: str, acquisition: str, cost_aware: bool,
              noise_row=None, cost_noise_row=None):
    """Fused posterior + acquisition + ranking.

    Returns ``(order, acq)``: candidate indices sorted by descending
    acquisition (a stable ascending sort of ``-acq``, so ties keep
    candidate order) and the raw de-standardised acquisition values."""
    mu_s, var_s = _posterior_core(params, X, y, Xs, kind, noise_row)
    mu = mu_s * y_std + y_mean
    sigma = torch.sqrt(var_s) * y_std
    if acquisition == "ucb":
        acq = mu + kappa * sigma
    elif acquisition == "ei":
        z = (mu - y_best) / sigma.clamp_min(1e-12)
        cdf = 0.5 * (1.0 + torch.special.erf(z / math.sqrt(2.0)))
        pdf = torch.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)
        acq = (mu - y_best) * cdf + sigma * pdf
    elif acquisition == "smsego":
        # single-objective SMSego gain: how far the optimistic estimate
        # extends the best observation (epsilon-dominance guard keeps
        # pure-exploitation candidates from pinning the search)
        optimistic = mu + kappa * sigma
        gain = optimistic - (y_best + eps)
        acq = torch.where(gain > 0, gain, gain * 1e-3)  # soft penalty below best
    else:
        raise ValueError(acquisition)
    if cost_aware:
        # EI-per-second (Snoek et al., 2012): divide the positive
        # acquisition mass by the predicted measurement cost, relative to
        # the mean observed cost so the units cancel; ``cost_alpha`` in
        # [0, 1] ramps the trade-off in as the wall clock runs out.
        cmu_s, _ = _posterior_core(cost_params, X, cost_y, Xs, kind, cost_noise_row)
        log_cost = cmu_s * cost_std + cost_mean
        rel = torch.exp(log_cost) / mean_cost.clamp_min(1e-9)
        rel = rel.clamp(1e-2, 1e2) ** cost_alpha
        acq = torch.where(acq > 0, acq / rel, acq * rel)
    order = torch.argsort(-acq, stable=True)
    return order, acq


@dataclass
class GPResult:
    mu: np.ndarray
    sigma: np.ndarray


class GaussianProcess:
    """Fit on (X in [0,1]^d, y); query posterior at candidate points.

    ``device`` places the GP's tensors; it is ``"cpu"`` unless the caller
    says otherwise (the BO engine passes its own ``device`` keyword
    through).  ``fit(..., params0=prev.params)`` warm-starts the
    hyperparameter optimisation with the short ``warm_steps`` schedule.
    """

    def __init__(self, kind: str = "matern52", fit_steps: int = 120,
                 warm_steps: int = 30, lr: float = 0.05, device="cpu"):
        self.kind = kind
        self.fit_steps = fit_steps
        self.warm_steps = warm_steps
        self.lr = lr
        self.device = torch.device(device)
        self._params = None
        self._X = None          # (n, d)
        self._y = None          # (n,), standardised
        self._noise_row = None  # (n,) per-row noise scale, or None
        self._y_mean = 0.0
        self._y_std = 1.0
        #: observability: did the most recent fit() warm-start from params0?
        self.last_fit_was_warm = False

    @property
    def params(self) -> Optional[Dict]:
        """Fitted hyperparameters (warm-start handle for the next fit)."""
        return self._params

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64), dtype=_DTYPE, device=self.device)

    def _scalar(self, x: float) -> torch.Tensor:
        return torch.tensor(x, dtype=_DTYPE, device=self.device)

    def fit(self, X: np.ndarray, y: np.ndarray,
            params0: Optional[Dict] = None,
            noise_scale: Optional[np.ndarray] = None) -> "GaussianProcess":
        yn = np.asarray(y, np.float64)
        self._y_mean = float(yn.mean())
        self._y_std = float(yn.std() + 1e-9)
        y_std = (yn - self._y_mean) / self._y_std
        Xt, yt = self._tensor(X), self._tensor(y_std)
        nrow = None if noise_scale is None else self._tensor(noise_scale)
        self._noise_row = nrow
        d = Xt.shape[1]
        cold = {
            "log_ls": torch.full((d,), math.log(0.3), dtype=_DTYPE, device=self.device),
            "log_sigma2": self._scalar(0.0),
            "log_noise": self._scalar(math.log(1e-3)),
        }
        warm = params0 is not None
        self.last_fit_was_warm = warm
        init = params0 if warm else cold
        steps = self.warm_steps if warm else self.fit_steps
        fitted = _fit(init, Xt, yt, self.kind, steps, self.lr, nrow)
        # fp32 robustness: if the fitted hyperparameters make the Cholesky
        # blow up (near-singular K), fall back to safe defaults with a
        # larger noise floor; a diverged warm start additionally gets a
        # full cold refit before giving up.
        with torch.no_grad():
            nll = _neg_mll(fitted, Xt, yt, self.kind, nrow)
        if not bool(torch.isfinite(nll)):
            if warm:
                fitted = _fit(cold, Xt, yt, self.kind, self.fit_steps, self.lr, nrow)
                with torch.no_grad():
                    nll = _neg_mll(fitted, Xt, yt, self.kind, nrow)
            if not bool(torch.isfinite(nll)):
                fitted = {
                    "log_ls": torch.full_like(cold["log_ls"], math.log(0.3)),
                    "log_sigma2": torch.zeros_like(cold["log_sigma2"]),
                    "log_noise": torch.full_like(cold["log_noise"], math.log(1e-2)),
                }
        self._params = fitted
        self._X, self._y = Xt, yt
        return self

    def _safe(self) -> Dict:
        safe = dict(self._params)
        safe["log_noise"] = torch.full_like(self._params["log_noise"], _SAFE_NOISE)
        return safe

    def posterior(self, Xs: np.ndarray) -> GPResult:
        assert self._params is not None, "fit first"
        Xst = self._tensor(Xs)

        def run(params):
            with torch.no_grad():
                mu, var = _posterior_core(params, self._X, self._y, Xst, self.kind,
                                          self._noise_row)
            return mu.cpu().numpy(), var.cpu().numpy()

        mu, var = run(self._params)
        if not np.isfinite(mu).all():  # last-resort refit with big noise
            mu, var = run(self._safe())
        mu = np.nan_to_num(mu, nan=0.0) * self._y_std + self._y_mean
        sigma = np.sqrt(np.clip(np.nan_to_num(var, nan=1.0), 1e-12, None)) * self._y_std
        return GPResult(mu, sigma)

    def acquisition_rank(self, Xs: np.ndarray, acquisition: str,
                         y_best: float, kappa: float = 2.0,
                         cost_gp: Optional["GaussianProcess"] = None,
                         cost_alpha: float = 1.0,
                         mean_cost: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
        """Rank candidates by acquisition in one fused call.

        Returns ``(order, acq)``: ``order`` walks indices of ``Xs`` by
        descending acquisition.  ``cost_gp`` (a GP fit on log measurement
        cost over the same training inputs) switches on EI-per-second
        weighting.
        """
        assert self._params is not None, "fit first"
        Xst = self._tensor(Xs)
        eps = 1e-3 * max(abs(y_best), 1.0)
        cost_aware = cost_gp is not None
        if cost_aware:
            assert cost_gp._y.shape == self._y.shape, \
                "cost GP must be fit on the same training inputs"
            cparams, cy = cost_gp._params, cost_gp._y
            cnrow = cost_gp._noise_row
            cmean, cstd = cost_gp._y_mean, cost_gp._y_std
        else:
            cparams, cy, cnrow, cmean, cstd = None, None, None, 0.0, 1.0
        s = self._scalar

        def rank(params):
            with torch.no_grad():
                order, acq = _acq_rank(
                    params, self._X, self._y, Xst,
                    s(self._y_mean), s(self._y_std), s(y_best), s(kappa), s(eps),
                    cparams, cy, s(cmean), s(cstd), s(cost_alpha), s(mean_cost),
                    self.kind, acquisition, cost_aware, self._noise_row, cnrow)
            return order.cpu().numpy(), acq.cpu().numpy()

        order, acq = rank(self._params)
        if not np.isfinite(acq).all():  # same fp32 last resort as posterior():
            order, acq = rank(self._safe())  # re-rank with a big noise floor
        return order, acq

    @property
    def lengthscales(self) -> np.ndarray:
        return np.exp(self._params["log_ls"].cpu().numpy())
