"""The port's GP surrogate (``repro_torch.core.gp``) against the reference's
(``repro.core.gp``) on the CPU, float32 on both sides, same numpy inputs.

Tolerances (stated once): negative MLL relative 1e-5, its gradient
relative 1e-3 (norm-wise), posterior mean and variance absolute 1e-4,
fitted NLL relative 1e-3 (cold and warm fits), acquisition values
absolute 1e-4 on standardised values (divided by the GP's ``y_std``).

Where float32 cannot resolve a quantity to its tolerance, no float32
implementation can agree with another to it.  Each comparison therefore
also computes the quantity in float64 (the port's code on float64
tensors) and holds the port to the stated tolerance wherever the
reference's own float32 value lies within a tenth of it from the float64
value (the case is *in scope*).  Elsewhere (an ill-conditioned Gram
matrix: dense 1-D inputs, a fit that drives the noise to its floor) the
port's value must be finite, and for each quantity a test asserts that
at least two thirds of the grid is in scope.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gp as J
from repro.core.bayesopt import _norm_cdf as j_norm_cdf
from repro_torch.core import BayesOpt, GaussianProcess, History, IntDim, Observation, SearchSpace
from repro_torch.core import Tuner, TunerConfig
from repro_torch.core import gp as T
from repro_torch.core.bayesopt import _erf, _norm_cdf, _norm_pdf

# the test processes share the host's cores: one intra-op thread each keeps
# the GP's many small operations from oversubscribing them
torch.set_num_threads(1)

CASES = [(k, n, d) for k in ("rbf", "matern52") for n in (3, 17, 40) for d in (1, 3, 6)]
F32, F64 = torch.float32, torch.float64
KEYS = ("log_ls", "log_sigma2", "log_noise")


def _data(n, d, noise=0.0, seed=0):
    """The reference tests' toy landscape, widened to any d; ``noise`` adds
    measurement noise (what a tuner's timings carry)."""
    rng = np.random.default_rng(1000 * n + d + seed)
    X = rng.random((n, d))
    y = np.sin(3 * X[:, 0]) + X[:, -1] ** 2 - 0.5 * X[:, d // 2] + noise * rng.standard_normal(n)
    return X, y


def _std(y):
    return (y - y.mean()) / (y.std() + 1e-9)


def _params(d, log_sigma2=0.2):
    return {"log_ls": np.full((d,), np.log(0.3), np.float32),
            "log_sigma2": np.float32(log_sigma2), "log_noise": np.float32(np.log(1e-3))}


def _jp(p):
    return {k: jnp.asarray(np.asarray(v), jnp.float32) for k, v in p.items()}


def _tp(p, dtype=F32):
    return {k: torch.tensor(np.asarray(v), dtype=dtype) for k, v in p.items()}


def _t(a, dtype=F32):
    return torch.tensor(np.asarray(a, np.float64), dtype=dtype)


def _flat(g):
    return np.concatenate([np.atleast_1d(np.asarray(g[k], np.float64)) for k in KEYS])


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                 / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-30))


def _held(port_err, ref_err64, tol):
    """The rule of the module docstring; True when the case is in scope."""
    assert np.isfinite(port_err)
    if ref_err64 <= tol / 10:
        assert port_err <= tol, (port_err, tol)
        return True
    return False


def _mostly_in_scope(flags):
    assert sum(flags) >= 2 * len(flags) / 3, (sum(flags), len(flags))


def _ref_inputs(X, ys):
    """The reference's (X, y, mask) for a fit on live rows only."""
    return (jnp.asarray(X, jnp.float32), jnp.asarray(ys, jnp.float32),
            jnp.ones(X.shape[0], jnp.float32))


def _mll_case(kind, n, d):
    """(in scope?) for the negative MLL and for its gradient."""
    X, y = _data(n, d)
    ys = _std(y)
    p = _params(d)
    Xj, yj, mask = _ref_inputs(X, ys)
    ref = float(J._neg_mll(_jp(p), Xj, yj, mask, kind))
    ref_g = _flat(jax.grad(J._neg_mll)(_jp(p), Xj, yj, mask, kind))

    out = {}
    for dt in (F32, F64):
        tp = {k: v.requires_grad_(True) for k, v in _tp(p, dt).items()}
        loss = T._neg_mll(tp, _t(X, dt), _t(ys, dt), kind)
        loss.backward()
        out[dt] = (loss.item(), _flat({k: v.grad.numpy() for k, v in tp.items()}))
    (mine, g), (exact, g64) = out[F32], out[F64]

    return (_held(abs(mine - ref) / abs(ref), abs(ref - exact) / abs(exact), 1e-5),
            _held(_rel(g, ref_g), _rel(ref_g, g64), 1e-3))


@pytest.mark.parametrize("kind,n,d", CASES)
def test_neg_mll_and_gradient_match_reference(kind, n, d):
    _mll_case(kind, n, d)


def test_neg_mll_and_gradient_are_in_scope_for_most_cases():
    flags = [_mll_case(*c) for c in CASES]
    _mostly_in_scope([f[0] for f in flags])
    _mostly_in_scope([f[1] for f in flags])


def _posterior_case(kind, n, d):
    X, y = _data(n, d)
    ys = _std(y)
    Xs = np.random.default_rng(5).random((64, d))
    p = _params(d)
    Xj, yj, mask = _ref_inputs(X, ys)
    mu_r, var_r = (np.asarray(a, np.float64) for a in
                   J._posterior(_jp(p), Xj, yj, mask, jnp.asarray(Xs, jnp.float32), kind))
    got = {dt: [a.numpy().astype(np.float64) for a in
                T._posterior_core(_tp(p, dt), _t(X, dt), _t(ys, dt), _t(Xs, dt), kind)]
           for dt in (F32, F64)}
    return [_held(np.abs(got[F32][i] - ref).max(), np.abs(ref - got[F64][i]).max(), 1e-4)
            for i, ref in enumerate((mu_r, var_r))]


@pytest.mark.parametrize("kind,n,d", CASES)
def test_posterior_matches_reference_at_fixed_params(kind, n, d):
    _posterior_case(kind, n, d)


def test_posterior_is_in_scope_for_most_cases():
    _mostly_in_scope([f for c in CASES for f in _posterior_case(*c)])


def _ref_nll(gp, kind):
    return float(J._neg_mll(gp.params, gp._X, gp._y, gp._mask, kind))


def _fit64(X, y, kind, params0, steps):
    ys = _std(np.asarray(y, np.float64))
    fitted = T._fit(_tp(params0, F64), _t(X, F64), _t(ys, F64), kind, steps, 0.05)
    return float(T._neg_mll(fitted, _t(X, F64), _t(ys, F64), kind))


def _fit_cases():
    """(reference, port, float64, start) NLL of the cold and the warm fit
    of each case."""
    out = {}
    for kind, n, d in CASES:
        X, y = _data(n, d, noise=0.1)
        rng = np.random.default_rng(7 * n + d)
        X2 = np.concatenate([X, rng.random((4, d))])
        y2 = np.concatenate([y, np.sin(3 * X2[-4:, 0]) + 0.1 * rng.standard_normal(4)])
        cold = _params(d, log_sigma2=0.0)
        ref = J.GaussianProcess(kind=kind).fit(X, y)
        mine = GaussianProcess(kind=kind).fit(X, y)
        # the warm fits start from the same place: the reference's cold fit
        start = {k: np.asarray(v) for k, v in ref.params.items()}
        ref_w = J.GaussianProcess(kind=kind).fit(X2, y2, params0=ref.params)
        mine_w = GaussianProcess(kind=kind).fit(X2, y2, params0=_tp(start))
        rows = []
        for r, m, XX, yy, p0, steps in ((ref, mine, X, y, cold, 120),
                                        (ref_w, mine_w, X2, y2, start, 30)):
            a, b = _ref_nll(r, kind), float(T._neg_mll(m.params, m._X, m._y, kind))
            exact = _fit64(XX, yy, kind, p0, steps)
            start_nll = float(T._neg_mll(_tp(p0), m._X, m._y, kind))
            rows.append((a, b, exact, start_nll))
        out[(kind, n, d)] = rows
    return out


_FITS = {}


def _fits():
    if not _FITS:
        _FITS.update(_fit_cases())
    return _FITS


@pytest.mark.parametrize("kind,n,d", CASES)
def test_fit_matches_reference(kind, n, d):
    """Cold fit (120 Adam steps) and warm fit (30 steps from the same
    hyperparameters, 4 more rows): fitted NLL relative 1e-3."""
    for ref, mine, exact, start_nll in _fits()[(kind, n, d)]:
        assert mine < start_nll  # the fit made progress
        _held(abs(mine - ref) / abs(ref), abs(ref - exact) / abs(exact), 1e-3)


def test_fit_is_in_scope_for_most_cases():
    _mostly_in_scope([abs(ref - exact) / abs(exact) <= 1e-4
                      for rows in _fits().values() for ref, _, exact, _ in rows])


def test_noise_row_matches_reference():
    """Per-row noise scales (transfer warm starts) enter the Gram diagonal
    the same way: NLL, posterior and the row a fitted GP keeps."""
    kind, (X, y) = "matern52", _data(17, 3)
    ys = _std(y)
    scale = 1.0 + 3.0 * np.linspace(0, 1, 17)
    p = _params(3)
    Xj, yj, mask = _ref_inputs(X, ys)
    nr = jnp.asarray(scale, jnp.float32)
    ref = float(J._neg_mll(_jp(p), Xj, yj, mask, kind, nr))
    mine = float(T._neg_mll(_tp(p), _t(X), _t(ys), kind, _t(scale)))
    assert abs(mine - ref) / abs(ref) <= 1e-5
    Xs = np.random.default_rng(3).random((32, 3))
    mu_r, var_r = J._posterior(_jp(p), Xj, yj, mask, jnp.asarray(Xs, jnp.float32), kind, nr)
    mu_m, var_m = T._posterior_core(_tp(p), _t(X), _t(ys), _t(Xs), kind, _t(scale))
    np.testing.assert_allclose(mu_m.numpy(), np.asarray(mu_r), atol=1e-4)
    np.testing.assert_allclose(var_m.numpy(), np.asarray(var_r), atol=1e-4)

    gp = GaussianProcess(kind=kind).fit(X, y, noise_scale=scale)
    np.testing.assert_array_equal(gp._noise_row.numpy(), scale.astype(np.float32))
    assert GaussianProcess(kind=kind).fit(X, y)._noise_row is None


def _pair(kind="matern52", n=12, d=2, seed=11):
    """A reference GP and a port GP on the same data, both set to the same
    fixed hyperparameters after fitting (so only the acquisition differs)."""
    rng = np.random.default_rng(seed)
    X = rng.random((n, d))
    y = 10.0 * np.sin(4 * X[:, 0]) + 3.0 * X[:, 1]
    p = _params(d, log_sigma2=0.3)
    p["log_noise"] = np.float32(np.log(1e-2))
    ref = J.GaussianProcess(kind=kind).fit(X, y)
    mine = GaussianProcess(kind=kind).fit(X, y)
    ref._params, mine._params = _jp(p), _tp(p)
    return ref, mine, X, y, rng.random((200, d))


@pytest.mark.parametrize("acquisition,cost_alpha", [
    ("ei", None), ("ucb", None), ("smsego", None),
    ("ei", 0.0), ("ei", 0.5), ("ei", 1.0)])
def test_acquisition_values_match_reference(acquisition, cost_alpha):
    ref, mine, X, y, Xs = _pair()
    kw = {}
    if cost_alpha is not None:
        cost = np.log(0.2 + 5.0 * X[:, 0])
        ref_c = J.GaussianProcess().fit(X, cost)
        mine_c = GaussianProcess().fit(X, cost)
        pc = _params(2)
        ref_c._params, mine_c._params = _jp(pc), _tp(pc)
        kw = dict(cost_alpha=cost_alpha, mean_cost=float(np.exp(cost).mean()))
    y_best = float(y.max())
    _, acq_r = ref.acquisition_rank(Xs, acquisition, y_best,
                                    cost_gp=ref_c if kw else None, **kw)
    order, acq_m = mine.acquisition_rank(Xs, acquisition, y_best,
                                         cost_gp=mine_c if kw else None, **kw)
    assert acq_m.shape == (len(Xs),) and sorted(order.tolist()) == list(range(len(Xs)))
    np.testing.assert_allclose(acq_m / mine._y_std, np.asarray(acq_r) / ref._y_std, atol=1e-4)
    # the order is the stable descending order of the values it returns
    np.testing.assert_array_equal(order, np.argsort(-acq_m, kind="stable"))


@pytest.mark.parametrize("acquisition", ["smsego", "ucb"])
def test_fused_rank_and_numpy_rank_give_the_same_suggestions(acquisition):
    """smsego / ucb are mul / add on the posterior: the fused torch rank and
    ``_rank_numpy`` over ``posterior()`` make the same suggestion sequence."""
    space = SearchSpace([IntDim("x", 0, 15), IntDim("z", 0, 12)])
    fused = BayesOpt(space, seed=7, acquisition=acquisition)
    plain = BayesOpt(space, seed=7, acquisition=acquisition, jit_acquisition=False)

    def obj(p):
        return float(np.exp(-((p["x"] - 9) / 4) ** 2) * 20 + 0.5 * p["z"])

    h_f, h_p = History(space), History(space)
    for _ in range(14):
        pf, pp = fused.ask(1, h_f)[0], plain.ask(1, h_p)[0]
        assert pf == pp
        for eng, h, p in ((fused, h_f, pf), (plain, h_p, pp)):
            eng.tell([Observation(point=p, value=obj(p))])
            h.add(p, obj(p))


def test_fused_ei_values_equal_numpy_ei():
    rng = np.random.default_rng(11)
    X = rng.random((10, 2))
    y = np.sin(4 * X[:, 0]) + X[:, 1]
    gp = GaussianProcess().fit(X, y)
    Xs = rng.random((17, 2))
    y_best = float(y.max())
    _, acq = gp.acquisition_rank(Xs, "ei", y_best)
    post = gp.posterior(Xs)
    z = (post.mu - y_best) / np.maximum(post.sigma, 1e-12)
    expect = (post.mu - y_best) * _norm_cdf(z) + post.sigma * _norm_pdf(z)
    np.testing.assert_allclose(acq, expect, rtol=1e-4, atol=1e-6)


def test_acquisition_rank_nonfinite_fallback(monkeypatch):
    """A non-finite fused acquisition is retried once with the noise floor
    of 1e-1 that posterior() uses; NaNs are never ranked."""
    rng = np.random.default_rng(0)
    X = rng.random((9, 2))
    y = np.sin(3 * X[:, 0])
    gp = GaussianProcess().fit(X, y)
    Xs = rng.random((6, 2))
    noise_per_call = []
    real = T._acq_rank

    def flaky(params, *args):
        noise_per_call.append(float(torch.exp(params["log_noise"])))
        order, acq = real(params, *args)
        if len(noise_per_call) == 1:
            return order, torch.full_like(acq, math.nan)
        return order, acq

    monkeypatch.setattr(T, "_acq_rank", flaky)
    order, acq = gp.acquisition_rank(Xs, "ei", float(y.max()))
    assert len(noise_per_call) == 2
    assert noise_per_call[1] == pytest.approx(0.1)
    assert np.isfinite(acq).all()
    assert sorted(order.tolist()) == list(range(len(Xs)))


def test_failed_factorisation_gives_nan_and_the_fallback_chain_runs(monkeypatch):
    """``cholesky_ex`` failures become NaN (never an exception), a diverged
    warm start refits cold, and a failed cold refit lands on the safe
    defaults — the reference's chain, step by step."""
    K = torch.tensor([[1.0, 2.0], [2.0, 1.0]])
    with pytest.raises(RuntimeError):
        torch.linalg.cholesky(K)
    assert torch.isnan(T._cholesky(K)).all()

    X, y = _data(11, 3)
    nan = {"log_ls": np.full(3, np.nan, np.float32), "log_sigma2": np.float32(np.nan),
           "log_noise": np.float32(np.nan)}
    cold = GaussianProcess().fit(X, y)
    warm = GaussianProcess().fit(X, y, params0=_tp(nan))
    assert warm.last_fit_was_warm
    for k in KEYS:  # the NaN warm start fell back to exactly the cold fit
        torch.testing.assert_close(warm.params[k], cold.params[k], rtol=0, atol=0)
    ref = J.GaussianProcess().fit(X, y, params0=_jp(nan))
    assert all(np.isfinite(np.asarray(v)).all() for v in ref.params.values())

    monkeypatch.setattr(T, "_fit", lambda p, *a, **k: {kk: v * math.nan for kk, v in p.items()})
    monkeypatch.setattr(J, "_fit", lambda p, *a, **k: {kk: v * jnp.nan for kk, v in p.items()})
    safe = GaussianProcess().fit(X, y)
    safe_ref = J.GaussianProcess().fit(X, y)
    for k in KEYS:
        np.testing.assert_array_equal(safe.params[k].numpy(), np.asarray(safe_ref.params[k]))
    assert float(torch.exp(safe.params["log_noise"])) == pytest.approx(1e-2)


def test_erf_and_normal_cdf_match_math_erf():
    z = np.linspace(-4.0, 4.0, 161)
    np.testing.assert_allclose(_erf(z), [math.erf(v) for v in z], atol=2e-7)
    expect = np.array([0.5 * (1.0 + math.erf(v / math.sqrt(2))) for v in z])
    got = _norm_cdf(z)
    assert isinstance(got, np.ndarray) and got.shape == z.shape
    np.testing.assert_allclose(got, expect, atol=2e-7)
    np.testing.assert_array_equal(got, j_norm_cdf(z))
    np.testing.assert_allclose(_norm_pdf(z), np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi))


def test_device_is_cpu_unless_the_caller_says_otherwise():
    assert GaussianProcess().device == torch.device("cpu")
    X, y = _data(9, 2)
    gp = GaussianProcess(device="cpu").fit(X, y)
    assert gp._X.device.type == "cpu" and gp.params["log_ls"].device.type == "cpu"
    space = SearchSpace([IntDim("x", 0, 9), IntDim("z", 0, 4)])
    t = Tuner(lambda p: float(p["x"] - p["z"]), space,
              TunerConfig(algorithm="bo", budget=4, seed=0, verbose=False,
                          engine_kwargs={"device": "cpu", "n_init": 2}))
    t.run()
    t.close()
    assert t.engine.device == "cpu" and t.engine._gp.device == torch.device("cpu")


def test_gp_leaves_global_thread_settings_alone():
    before = (torch.get_num_threads(), torch.get_num_interop_threads())
    X, y = _data(17, 3)
    GaussianProcess().fit(X, y).acquisition_rank(np.random.default_rng(1).random((50, 3)),
                                                 "ei", float(y.max()))
    assert (torch.get_num_threads(), torch.get_num_interop_threads()) == before
