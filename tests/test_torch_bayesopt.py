"""The port's BO engine (``repro_torch.core.bayesopt``) against the
reference's (``repro.core.bayesopt``) on the CPU.

Teacher-forced parity on the golden BO traces: at every step *k* of
``bo:0`` and ``bo:3`` a reference engine and a port engine are given the
same history (the golden prefix) and asked for one point.  The port's
point must equal the golden point *k*: the LHS head exactly, and every
GP-ranked step.  The test also computes the reference's own gap between
its best and second-best acquisition value (standardised, tolerance
1e-4, the acquisition tolerance of ``test_torch_gp.py``), because that
is where parity is well-posed.  On these traces 7 of the 20 GP-ranked
steps have a larger gap (the later steps rank SMSego's soft penalty
below the incumbent, a thousandth of a gain); the port matches at all
20.
Full trace equality through the ``Tuner`` is in ``test_torch_tuner.py``.

``TransferPrior`` is numpy on both sides and compared exactly.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.core import History as JHistory
from repro.core import Observation as JObservation
from repro.core import SearchSpace as JSearchSpace
from repro.core.bayesopt import BayesOpt as JBayesOpt
from repro.core.bayesopt import TransferPrior as JTransferPrior
from repro_torch.core import (BayesOpt, GaussianProcess, History, IntDim, Observation,
                              SearchSpace, TransferPrior, Tuner, TunerConfig)

# the test processes share the host's cores: one intra-op thread each keeps
# the GP's many small operations from oversubscribing them
torch.set_num_threads(1)

GOLDEN = json.loads(
    (pathlib.Path(__file__).parent / "golden" / "ask_tell_traces.json").read_text())
ACQ_TOL = 1e-4
PACKAGES = {"ref": (JBayesOpt, JSearchSpace, JHistory, JObservation),
            "port": (BayesOpt, SearchSpace, History, Observation)}


def _teacher_forced(pkg, seed, k, **kw):
    """A fresh engine of ``pkg`` told the first ``k`` golden evaluations."""
    Eng, Space, Hist, Obs = PACKAGES[pkg]
    trace = GOLDEN["traces"][f"bo:{seed}"]
    space = Space.from_dicts(GOLDEN["space"])
    eng, h = Eng(space, seed=seed, **kw), Hist(space)
    for p, v in zip(trace["points"][:k], trace["values"][:k]):
        eng.tell([Obs(point=p, value=v)])
        h.add(p, v)
    return eng, h


def _ref_gap(eng, h):
    """The reference's standardised gap between its two best candidates at
    the ask it just made (None in the LHS head)."""
    if eng._gp is None or len(h) < eng.n_init:
        return None
    _, Xs = eng._candidates(h)
    y_best = float(np.nanmax(h.values()))
    order, acq = eng._gp.acquisition_rank(Xs, eng.acquisition, y_best, kappa=eng.kappa)
    return float(acq[order[0]] - acq[order[1]]) / eng._gp._y_std


STEPS = [(seed, k) for seed in (0, 3) for k in range(18)]


@pytest.mark.parametrize("seed,k", STEPS)
def test_teacher_forced_ask_equals_golden_point(seed, k):
    golden = GOLDEN["traces"][f"bo:{seed}"]["points"][k]
    ref, h_ref = _teacher_forced("ref", seed, k)
    mine, h_mine = _teacher_forced("port", seed, k)
    ref_pick, my_pick = ref.ask(1, h_ref)[0], mine.ask(1, h_mine)[0]
    assert ref_pick == golden  # the reference reproduces its own trace
    assert my_pick == golden
    gap = _ref_gap(ref, h_ref)
    if k < ref.n_init:
        assert gap is None and mine._gp is None  # LHS head: no GP yet
    else:
        assert gap is not None and mine._gp is not None


def test_gp_ranked_steps_include_well_posed_ones():
    """Parity at a GP-ranked step is well-posed where the reference's own
    top-1 vs top-2 gap exceeds the acquisition tolerance: the traces hold
    such steps (the asserting test above holds at every step)."""
    gaps = []
    for seed, k in STEPS:
        ref, h = _teacher_forced("ref", seed, k)
        ref.ask(1, h)
        g = _ref_gap(ref, h)
        if g is not None:
            gaps.append(g)
    assert len(gaps) == 20
    assert sum(g > ACQ_TOL for g in gaps) >= 5, gaps


def test_sampled_candidate_sets_draw_like_the_reference():
    """A grid larger than ``max_candidates``: the LHS design, then random
    samples plus perturbations of the incumbent, drawn from the engine's
    numpy generator in the reference's order."""
    space = [{"type": "int", "name": "x", "min": 0, "max": 63},
             {"type": "int", "name": "z", "min": 0, "max": 63}]
    out = {}
    for pkg in ("ref", "port"):
        Eng, Space, Hist, Obs = PACKAGES[pkg]
        sp = Space.from_dicts(space)
        eng, h = Eng(sp, seed=5, max_candidates=256, n_init=4), Hist(sp)
        first = eng.ask(1, h)
        for i, p in enumerate(sp.sample(np.random.default_rng(1), 6)):
            h.add(p, float(-(p["x"] - 40) ** 2 - i))
        out[pkg] = (first, eng._init_points, [eng._candidates(h)[0] for _ in range(3)])
    assert out["port"] == out["ref"]


# ---------------------------------------------------------------------------
# cost-aware and fidelity-feature asks
# ---------------------------------------------------------------------------

_COST_SPACE = [{"type": "int", "name": "x", "min": 0, "max": 19}]
_COST_OBSERVED = (1, 4, 7, 12, 15, 18)


def _two_peak_value(p):
    x = p["x"]
    return float(10.0 * np.exp(-((x - 4) / 3.0) ** 2)
                 + 10.6 * np.exp(-((x - 15) / 3.0) ** 2))


def _step_cost(p):
    return 40.0 if p["x"] >= 10 else 0.2


def _cost_pick(pkg, **kw):
    Eng, Space, Hist, Obs = PACKAGES[pkg]
    space = Space.from_dicts(_COST_SPACE)
    eng, h = Eng(space, seed=0, acquisition="ei", n_init=2, **kw), Hist(space)
    for x in _COST_OBSERVED:
        p = {"x": x}
        eng.tell([Obs(point=p, value=_two_peak_value(p), cost_seconds=_step_cost(p))])
        h.add(p, _two_peak_value(p), _step_cost(p))
    return eng, eng.ask(1, h)[0]


def test_cost_aware_ask_matches_reference():
    _, plain = _cost_pick("port")
    aware_eng, aware = _cost_pick("port", cost_aware=True)
    assert plain["x"] >= 10 and aware["x"] < 10  # EI-per-second prefers the cheap peak
    assert aware_eng._cost_gp is not None
    assert plain == _cost_pick("ref")[1]
    assert aware == _cost_pick("ref", cost_aware=True)[1]


def test_cost_aware_rank_is_exact_reweighting():
    space = SearchSpace.from_dicts(_COST_SPACE)
    pts = [{"x": x} for x in _COST_OBSERVED]
    X = space.encode_many(pts)
    y = np.array([_two_peak_value(p) for p in pts])
    cost = np.array([_step_cost(p) for p in pts])
    gp, cost_gp = GaussianProcess().fit(X, y), GaussianProcess().fit(X, np.log(cost))
    Xs = space.encode_many([p for p in space.enumerate() if p["x"] not in _COST_OBSERVED])
    _, plain = gp.acquisition_rank(Xs, "ei", float(y.max()))
    _, aware = gp.acquisition_rank(Xs, "ei", float(y.max()), cost_gp=cost_gp,
                                   cost_alpha=1.0, mean_cost=float(cost.mean()))
    rel = np.clip(np.exp(cost_gp.posterior(Xs).mu) / cost.mean(), 1e-2, 1e2)
    np.testing.assert_allclose(aware, np.where(plain > 0, plain / rel, plain * rel),
                               rtol=1e-3, atol=1e-7)
    order0, _ = gp.acquisition_rank(Xs, "ei", float(y.max()), cost_gp=cost_gp,
                                    cost_alpha=0.0, mean_cost=float(cost.mean()))
    np.testing.assert_array_equal(order0, gp.acquisition_rank(Xs, "ei", float(y.max()))[0])


def test_fidelity_feature_asks_match_reference():
    """Partial measurements enter the GP with their fidelity as an input
    column; candidates are scored at fidelity 1 against a full incumbent."""
    space = GOLDEN["space"]

    def history(pkg):
        Eng, Space, Hist, Obs = PACKAGES[pkg]
        sp = Space.from_dicts(space)
        eng, h = Eng(sp, seed=1, fidelity_feature=True, n_init=4), Hist(sp)
        pts = sp.sample(np.random.default_rng(2), 10)
        for i, p in enumerate(pts):
            f = (0.25, 0.5, 1.0)[i % 3]
            v = float(p["inter_op"] * 2 + p["intra_op"] * 0.1 + p["build"]) * (0.5 + 0.5 * f)
            eng.tell([Obs(point=p, value=v, fidelity=f)])
            h.add(p, v, fidelity=f)
        return eng, h

    (mine, h_m), (ref, h_r) = history("port"), history("ref")
    assert mine.ask(2, h_m) == ref.ask(2, h_r)
    assert mine._gp._X.shape[1] == len(space) + 1  # the fidelity column


# ---------------------------------------------------------------------------
# transfer prior
# ---------------------------------------------------------------------------

def _rows(space, n=16, seed=3, distance=0.1):
    pts = space.sample(np.random.default_rng(seed), n)
    return [{"point": p, "value": float(p["inter_op"] - abs(p["intra_op"] - 40) / 5.0
                                        + 3 * p["build"]),
             "distance": distance, "fidelity": 1.0} for p in pts]


def test_transfer_prior_matches_reference_exactly():
    space, jspace = (S.from_dicts(GOLDEN["space"]) for S in (SearchSpace, JSearchSpace))
    rows = _rows(space)
    mine, ref = TransferPrior.from_rows(space, rows), JTransferPrior.from_rows(jspace, rows)
    Xq = space.encode_many(space.sample(np.random.default_rng(9), 40))
    np.testing.assert_array_equal(mine.predict(Xq), ref.predict(Xq))
    for n_real in (0, 5, 30):
        np.testing.assert_array_equal(mine.noise_scale(n_real, 24), ref.noise_scale(n_real, 24))
    assert mine.best_point() == ref.best_point() and len(mine) == len(ref) == 16
    np.testing.assert_array_equal(mine.X, ref.X)

    # the first transfer ask (no LHS design, the prior covers the space)
    eng = BayesOpt(space, seed=0, transfer_prior=mine)
    jeng = JBayesOpt(jspace, seed=0, transfer_prior=ref)
    first = eng.ask(1, History(space))
    assert first == jeng.ask(1, JHistory(jspace))
    assert eng._init_points is None and eng.last_ask_ranked == 1


def test_transfer_asks_follow_the_reference_until_the_prior_retires():
    space, jspace = (S.from_dicts(GOLDEN["space"]) for S in (SearchSpace, JSearchSpace))
    rows = _rows(space, n=24)
    eng = BayesOpt(space, seed=0, transfer_prior=TransferPrior.from_rows(space, rows),
                   transfer_decay=6)
    jeng = JBayesOpt(jspace, seed=0, transfer_prior=JTransferPrior.from_rows(jspace, rows),
                     transfer_decay=6)
    h, jh = History(space), JHistory(jspace)

    def obj(p):
        return float(50.0 * np.exp(-((p["inter_op"] - 11) / 5.0) ** 2)
                     + 0.3 * p["intra_op"] + 7.0 * p["build"])

    for _ in range(8):
        p, q = eng.ask(1, h)[0], jeng.ask(1, jh)[0]
        assert p == q
        eng.tell([Observation(point=p, value=obj(p))])
        jeng.tell([JObservation(point=q, value=obj(q))])
        h.add(p, obj(p))
        jh.add(q, obj(q))
    assert eng._prior_dropped and jeng._prior_dropped


# ---------------------------------------------------------------------------
# engine policies (port only)
# ---------------------------------------------------------------------------

def test_engine_warm_start_policy():
    space = SearchSpace([IntDim("x", 0, 63), IntDim("z", 0, 7)])

    def drive(engine, n_iters):
        h = History(space)
        for _ in range(n_iters):
            p = engine.ask(1, h)[0]
            v = float(p["x"] * 0.1 - (p["z"] - 3) ** 2)
            engine.tell([Observation(point=p, value=v, cost_seconds=0.05)])
            h.add(p, v, 0.05)
        return h

    eng = BayesOpt(space, seed=0, warm_start_min_n=12)
    drive(eng, 11)
    assert not eng._gp.last_fit_was_warm
    more = BayesOpt(space, seed=0, warm_start_min_n=12)
    drive(more, 16)
    assert more._gp.last_fit_was_warm
    off = BayesOpt(space, seed=0, warm_start=False, warm_start_min_n=12)
    drive(off, 16)
    assert not off._gp.last_fit_was_warm
    assert len(more.ask_seconds) == 16 and all(s >= 0 for s in more.ask_seconds)
    assert not hasattr(more, "jit_misses")


def test_cost_gp_follows_warm_start_policy():
    aware, _ = _cost_pick("port", cost_aware=True, warm_start_min_n=4)
    assert not aware._cost_gp.last_fit_was_warm  # first fit: cold
    h = History(aware.space)
    for x in _COST_OBSERVED:
        h.add({"x": x}, _two_peak_value({"x": x}), _step_cost({"x": x}))
    aware.ask(1, h)
    assert aware._cost_gp.last_fit_was_warm
    off, _ = _cost_pick("port", cost_aware=True, warm_start=False, warm_start_min_n=4)
    off.ask(1, h)
    assert not off._cost_gp.last_fit_was_warm


def test_cost_aware_budget_ramp():
    eng = BayesOpt(SearchSpace([IntDim("x", 0, 19)]), seed=0, cost_aware=True)
    assert eng._cost_alpha() == 1.0
    for frac, alpha in ((1.0, 0.0), (0.25, 0.75), (0.0, 1.0), (-0.5, 1.0), (1.5, 0.0),
                        (None, 1.0)):
        eng.note_budget(frac)
        assert eng._cost_alpha() == pytest.approx(alpha)


def test_default_tuner_config_is_bo_and_runs_on_the_cpu():
    space = SearchSpace([IntDim("x", 0, 19), IntDim("z", 0, 5)])
    t = Tuner(lambda p: float(p["x"] * 0.3 + p["z"]), space,
              TunerConfig(budget=12, seed=1, verbose=False))
    assert t.config.algorithm == "bo" and isinstance(t.engine, BayesOpt)
    h = t.run()
    t.close()
    assert len(h) == 12 and len(t.engine.ask_seconds) == 12
    assert t.engine._gp.device.type == "cpu"


def test_cost_aware_tuner_run_end_to_end():
    space = SearchSpace([IntDim("x", 0, 19), IntDim("z", 0, 5)])
    t = Tuner(lambda p: float(p["x"] * 0.3 + p["z"]), space,
              TunerConfig(algorithm="bo", budget=12, seed=1, verbose=False,
                          cost_aware=True, wall_clock_budget=30.0))
    assert t.engine.cost_aware is True
    h = t.run()
    t.close()
    assert len(h) == 12
    assert 0.0 <= t.engine.budget_fraction_remaining <= 1.0
    with pytest.raises(ValueError, match="cost_aware"):
        Tuner(lambda p: float(p["x"]), space,
              TunerConfig(algorithm="ga", budget=3, verbose=False, cost_aware=True))
