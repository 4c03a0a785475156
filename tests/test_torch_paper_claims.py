"""The paper's claims on the surrogate workloads, the port against the
reference (faster variants of ``fig5_tuning_curves``).

Tier-1, in one process (the surrogate's noise hashes with Python's salted
``hash()``, the same in both packages only there):

* GA, Nelder-Mead and random search give the reference's traces, points
  and values, at budget 25 on all five workloads;
* BO's initial design is the reference's, and its best at budget 25 lies
  within 2 % of the reference's best: 2 % is the surrogate's noise, and
  after the design the port's float32 GP can rank candidates otherwise
  (the float32 finding of ROADMAP Queue C).  Both BO runs are made in one
  fresh interpreter with a fixed ``PYTHONHASHSEED`` (the caller's, else
  0): the comparison then reads only the two packages' code, never the
  history of the test worker, whose hash salt is its own;
* every engine completes its budget (``test_all_engines_complete_budget``,
  as the reference has it).

The 50-iteration claims keep the reference's ``slow`` marker
(``tests/test_paper_claims.py``):

  1. BO delivers the best (or tied-best) throughput on the majority of
     workloads within a 50-iteration budget.
  2. BO samples (near-)100% of every parameter's tunable range; GA covers
     the least; NMS sits between (Table 2).
"""
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmarks import workloads as ref_workloads
from repro.core import SearchSpace as RefSearchSpace
from repro.core import Tuner as RefTuner
from repro.core import TunerConfig as RefTunerConfig
from repro_torch.benchmarks.workloads import MEASURED_WORKLOADS, surrogate_objective
from repro_torch.core import SearchSpace, Tuner, TunerConfig

ALGOS = ("bo", "ga", "nms")
NAMES = [w["name"] for w in MEASURED_WORKLOADS]
BUDGET = 25


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny GP ops on every core of a host shared by test workers thrash it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(workload, algo, seed, budget=50):
    space = SearchSpace.from_dicts(workload["space"])
    obj = surrogate_objective(workload)
    t = Tuner(obj, space, TunerConfig(algorithm=algo, budget=budget,
                                      seed=seed, verbose=False))
    return t.run()


@functools.lru_cache(maxsize=None)
def _port(i, algo, seed=0, budget=BUDGET):
    return _run(MEASURED_WORKLOADS[i], algo, seed, budget)


@functools.lru_cache(maxsize=None)
def _ref(i, algo, seed=0, budget=BUDGET):
    w = ref_workloads.MEASURED_WORKLOADS[i]
    space = RefSearchSpace.from_dicts(w["space"])
    t = RefTuner(ref_workloads.surrogate_objective(w), space,
                 RefTunerConfig(algorithm=algo, budget=budget, seed=seed, verbose=False))
    return t.run()


def _trace(h):
    return [(e.point, e.value) for e in h.evals]


HERE = os.path.dirname(os.path.abspath(__file__))
_BO_CHILD = """
import json, sys, torch
torch.set_num_threads(1)
import test_torch_paper_claims as t
print(json.dumps([[t._trace(t._port(i, "bo")), t._trace(t._ref(i, "bo"))]
                  for i in range(len(t.NAMES))]))
"""


@functools.lru_cache(maxsize=None)
def _bo_pairs():
    """``(port trace, reference trace)`` of BO on each workload, both run
    in one fresh interpreter at one hash seed."""
    root = os.path.dirname(HERE)
    env = dict(os.environ, PYTHONHASHSEED=os.environ.get("PYTHONHASHSEED", "0"),
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(root, "src"), root, HERE]))
    out = subprocess.run([sys.executable, "-c", _BO_CHILD], env=env, capture_output=True,
                         text=True, timeout=900, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("algo", ["ga", "nms", "random"])
@pytest.mark.parametrize("i", range(len(NAMES)), ids=NAMES)
def test_deterministic_engines_trace_the_reference(i, algo):
    got, want = _trace(_port(i, algo)), _trace(_ref(i, algo))
    assert len(got) == BUDGET
    assert got == want


@pytest.mark.parametrize("i", range(len(NAMES)), ids=NAMES)
def test_bo_design_equals_reference_and_best_within_noise(i):
    port, ref = _bo_pairs()[i]
    n_init = 8
    assert port[:n_init] == ref[:n_init]
    assert len(port) == BUDGET
    best = lambda trace: max(v for _, v in trace)
    assert abs(best(port) - best(ref)) <= 0.02 * best(ref)


@pytest.mark.parametrize("workload", MEASURED_WORKLOADS, ids=NAMES)
def test_all_engines_complete_budget(workload):
    i = NAMES.index(workload["name"])
    for algo in ALGOS:
        h = _port(i, algo)
        assert len(h) == 25
        assert np.isfinite(h.best().value)


@pytest.mark.slow
def test_bo_wins_majority_of_workloads():
    wins = 0
    for w in MEASURED_WORKLOADS:
        scores = {a: np.mean([_run(w, a, s).best().value for s in (0, 1)])
                  for a in ALGOS}
        top = max(scores.values())
        if scores["bo"] >= top - 1e-2 * abs(top):
            wins += 1
    assert wins >= (len(MEASURED_WORKLOADS) + 1) // 2, f"BO won only {wins}"


@pytest.mark.slow
def test_exploration_ordering_bo_ge_nms():
    """Table 2: BO coverage ~100%, >= NMS coverage on average."""
    w = MEASURED_WORKLOADS[0]
    cov = {}
    for algo in ALGOS:
        h = _run(w, algo, seed=0)
        fr = h.sampled_range_fraction()
        cov[algo] = np.mean(list(fr.values()))
    assert cov["bo"] >= 0.9
    assert cov["bo"] >= cov["nms"] - 0.05
    assert cov["bo"] >= cov["ga"] - 0.05
