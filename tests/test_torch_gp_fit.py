"""The port's GP fit (``repro_torch.core.gp._fit``): a closed-form gradient
of the negative MLL under a written-out Adam, on the host.

Tolerances (stated once): the closed-form gradient equals
``torch.autograd.grad`` of ``_neg_mll`` to 1e-8 relative (norm-wise) in
float64; a float64 fit equals the same Adam driven by autograd gradients
to 1e-8 absolute on every hyperparameter (a constant column's lengthscale
stays exactly at its start).  The grid is
``test_torch_gp.py``'s (both kernels, n in {3, 17, 40}, d in {1, 3, 6}),
each case plain, with a per-row noise scale (transfer warm starts) and
with a fidelity column (d + 1 inputs).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import BayesOpt, GaussianProcess, History, IntDim, SearchSpace
from repro_torch.core import gp as T

# the test processes share the host's cores (see test_torch_gp.py)
torch.set_num_threads(1)

F64 = torch.float64
KEYS = ("log_ls", "log_sigma2", "log_noise")
CASES = [(k, n, d, variant) for k in ("rbf", "matern52") for n in (3, 17, 40)
         for d in (1, 3, 6) for variant in ("plain", "noise_row", "fidelity")]


def _case(n, d, variant, seed=0):
    """(X, standardised y, noise_row or None, params) in float64."""
    rng = np.random.default_rng(1000 * n + d + seed)
    X = rng.random((n, d))
    y = np.sin(3 * X[:, 0]) + X[:, -1] ** 2 - 0.5 * X[:, d // 2] + 0.1 * rng.standard_normal(n)
    row = None
    if variant == "fidelity":  # the BO engine's extra input: the fraction measured
        X = np.concatenate([X, rng.choice([0.25, 0.5, 1.0], size=(n, 1))], axis=1)
    elif variant == "noise_row":
        row = 1.0 + 3.0 * rng.random(n)
    ys = (y - y.mean()) / (y.std() + 1e-9)
    D = X.shape[1]
    params = {"log_ls": torch.tensor(np.log(0.2 + 0.3 * rng.random(D)), dtype=F64),
              "log_sigma2": torch.tensor(0.2, dtype=F64),
              "log_noise": torch.tensor(math.log(1e-2), dtype=F64)}
    t = lambda a: None if a is None else torch.tensor(a, dtype=F64)
    return t(X), t(ys), t(row), params


def _autograd(params, X, y, kind, row):
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    g = torch.autograd.grad(T._neg_mll(leaves, X, y, kind, row), [leaves[k] for k in KEYS])
    return np.concatenate([a.reshape(-1).numpy() for a in g])


def _closed_form(params, X, y, kind, row):
    return T._neg_mll_grad(T._pack(params), T._sq_diffs(X.numpy()), y.numpy(), kind,
                           None if row is None else row.numpy())


@pytest.mark.parametrize("kind,n,d,variant", CASES)
def test_closed_form_gradient_equals_autograd_in_float64(kind, n, d, variant):
    X, y, row, params = _case(n, d, variant)
    want = _autograd(params, X, y, kind, row)
    got = _closed_form(params, X, y, kind, row)
    assert got.dtype == np.float64 and got.shape == want.shape == (X.shape[1] + 2,)
    assert np.linalg.norm(got - want) <= 1e-8 * np.linalg.norm(want)


def _adam_on_autograd(params0, X, y, kind, steps, lr, row):
    """The same Adam written against autograd gradients: the schedule the
    closed-form fit must keep."""
    p = {k: v.clone() for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v = {k: torch.zeros_like(a) for k, a in p.items()}
    for t in range(1, steps + 1):
        leaves = {k: a.clone().requires_grad_(True) for k, a in p.items()}
        grads = torch.autograd.grad(T._neg_mll(leaves, X, y, kind, row),
                                    [leaves[k] for k in KEYS])
        for k, g in zip(KEYS, grads):
            m[k] = 0.9 * m[k] + 0.1 * g
            v[k] = 0.999 * v[k] + 0.001 * g * g
            step = p[k] - lr * (m[k] / (1 - 0.9 ** t)) / (torch.sqrt(v[k] / (1 - 0.999 ** t)) + 1e-8)
            p[k] = step.clamp(*T._BOX[k])
    return p


@pytest.mark.parametrize("kind,n,variant", [(k, n, v) for k in ("rbf", "matern52")
                                            for n in (3, 17) for v in ("plain", "noise_row", "fidelity")])
def test_float64_fit_equals_adam_on_autograd(kind, n, variant):
    """120 cold steps from the GP's cold start: Adam's β, bias correction,
    ε and the box after every step are the ones it had.

    A column that is constant (at n = 3 the fidelity draws are all 1.0)
    has a gradient of exactly zero in closed form, so its lengthscale
    stays where it started; autograd leaves rounding there (~1e-16) that
    Adam's normalisation turns into a drift, so that entry is held to its
    start instead of to the autograd run."""
    X, y, row, _ = _case(n, 3, variant)
    cold = {"log_ls": torch.full((X.shape[1],), math.log(0.3), dtype=F64),
            "log_sigma2": torch.tensor(0.0, dtype=F64),
            "log_noise": torch.tensor(math.log(1e-3), dtype=F64)}
    got = T._fit(cold, X, y, kind, 120, 0.05, row)
    want = _adam_on_autograd(cold, X, y, kind, 120, 0.05, row)
    constant = (X == X[0]).all(0)
    assert torch.equal(got["log_ls"][constant], cold["log_ls"][constant])
    want["log_ls"] = torch.where(constant, cold["log_ls"], want["log_ls"])
    for k in KEYS:
        assert got[k].dtype == F64 and got[k].shape == cold[k].shape
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-8)


def test_fit_and_ask_take_no_autograd_path(monkeypatch):
    """With autograd disabled outright, a GP fits and BO suggests: the fast
    path is the one taken."""
    def refuse(*a, **k):
        raise AssertionError("autograd on the GP fit path")

    monkeypatch.setattr(torch.autograd, "grad", refuse)
    monkeypatch.setattr(torch.autograd, "backward", refuse)
    monkeypatch.setattr(torch.Tensor, "backward", refuse)
    X, y, _, _ = _case(17, 3, "plain")
    gp = GaussianProcess().fit(X.numpy(), y.numpy())
    assert all(torch.isfinite(v).all() for v in gp.params.values())
    assert gp.params["log_ls"].dtype == torch.float32

    space = SearchSpace([IntDim("x", 0, 15), IntDim("z", 0, 12)])
    eng, h = BayesOpt(space, seed=3, n_init=4), History(space)
    for _ in range(7):
        p = eng.ask(1, h)[0]
        h.add(p, float(-(p["x"] - 9) ** 2 + p["z"]))
    assert eng._gp is not None and len(h) == 7


def test_failed_factorisation_gives_nan_gradients_and_the_safe_defaults(monkeypatch):
    """A factorisation that fails (``info > 0``) is a NaN gradient, never an
    exception; a fit on it lands on the safe defaults, as the reference's
    chain does."""
    X, y, _, params = _case(11, 3, "plain")
    nan = dict(params, log_sigma2=torch.tensor(math.nan, dtype=F64))
    assert np.isnan(_closed_form(nan, X, y, "matern52", None)).all()

    real = torch.linalg.cholesky_ex

    def not_pd(K, *a, **k):
        L, info = real(K, *a, **k)
        return L, torch.ones_like(info)

    monkeypatch.setattr(torch.linalg, "cholesky_ex", not_pd)
    assert np.isnan(_closed_form(params, X, y, "matern52", None)).all()
    gp = GaussianProcess().fit(X.numpy(), y.numpy())
    assert torch.equal(gp.params["log_ls"], torch.full((3,), math.log(0.3)))
    assert float(gp.params["log_sigma2"]) == 0.0
    assert float(torch.exp(gp.params["log_noise"])) == pytest.approx(1e-2)
