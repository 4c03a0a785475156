"""The port's tuner stack (``repro_torch.core``, ``tuning.executor``,
``tuning.schedulers``) against the reference package on the CPU.

These modules are transcriptions of numpy / stdlib code, so the bar is
exact: the port's ``Tuner`` reproduces the golden ask/tell traces bit for
bit at ``parallelism=1``, and a port run equals a reference run record for
record (points, values, fidelities, rungs) — BO included: its GP runs in
float32 on both sides, and these traces reproduce exactly.
"""
import json
import math
import pathlib
import time

import pytest
import torch

from repro.core import SearchSpace as JSearchSpace
from repro.core import Tuner as JTuner
from repro.core import TunerConfig as JTunerConfig
from repro.tuning.objective import Evaluator as JEvaluator
from repro_torch.core import SearchSpace, Tuner, TunerConfig
from repro_torch.tuning.executor import EvaluationExecutor
from repro_torch.tuning.objective import Evaluator

# the test processes share the host's cores: one intra-op thread each keeps
# the GP's many small operations from oversubscribing them
torch.set_num_threads(1)

GOLDEN = json.loads(
    (pathlib.Path(__file__).parent / "golden" / "ask_tell_traces.json").read_text())

PORTED = ["bo", "ga", "nms", "random", "exhaustive"]


def golden_space(cls=SearchSpace):
    return cls.from_dicts(GOLDEN["space"])


def golden_objective(p):
    a, b, c = p["inter_op"], p["intra_op"], p["build"]
    return float(50.0 * pow(2.718281828, -((a - 11) / 5.0) ** 2)
                 + 0.3 * b - 0.004 * (b - 25) ** 2 + 7.0 * c)


def _records(h):
    return [(e.point, e.value, e.fidelity, getattr(e, "rung", None)) for e in h.evals]


@pytest.mark.parametrize("loop", ["async", "batch"])
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("algo", PORTED)
def test_parallelism_1_reproduces_golden_trace(algo, seed, loop):
    trace = GOLDEN["traces"][f"{algo}:{seed}"]
    t = Tuner(golden_objective, golden_space(),
              TunerConfig(algorithm=algo, budget=18, seed=seed, verbose=False,
                          parallelism=1, loop=loop))
    h = t.run()
    t.close()
    assert h.points() == trace["points"]
    assert [e.value for e in h.evals] == trace["values"]


@pytest.mark.parametrize("algo", PORTED)
def test_port_tuner_equals_reference_tuner_record_for_record(algo):
    def run(T, C, space):
        t = T(golden_objective, space,
              C(algorithm=algo, budget=30, seed=11, verbose=False, parallelism=1))
        h = t.run()
        t.close()
        return _records(h), h.best().point

    assert run(Tuner, TunerConfig, golden_space()) == \
        run(JTuner, JTunerConfig, golden_space(JSearchSpace))


def _fidelity_evaluator(base):
    class Partial(base):
        """Deterministic value that grows with the fidelity of the
        measurement, so the rung schedulers have something to rank."""
        supports_fidelity = True

        def __call__(self, point, fidelity=None):
            f = 1.0 if fidelity is None else float(fidelity)
            return golden_objective(point) * (0.5 + 0.5 * f), {"cost_seconds": f}

    return Partial()


@pytest.mark.parametrize("scheduler", ["asha", "hyperband"])
@pytest.mark.parametrize("algo", ["ga", "random"])
def test_multi_fidelity_schedulers_equal_reference(algo, scheduler):
    def run(T, C, space, ev):
        cfg = C(algorithm=algo, budget=12, seed=4, verbose=False, parallelism=1,
                multi_fidelity=True)
        cfg.multi_fidelity.scheduler = scheduler
        t = T(ev, space, cfg)
        h = t.run()
        t.close()
        return _records(h)

    mine = run(Tuner, TunerConfig, golden_space(), _fidelity_evaluator(Evaluator))
    ref = run(JTuner, JTunerConfig, golden_space(JSearchSpace), _fidelity_evaluator(JEvaluator))
    assert mine == ref
    assert any(f < 1.0 for _, _, f, _ in mine)  # partial rungs were used


def test_executor_orders_results_and_memoizes():
    space = golden_space()
    calls = []

    def obj(p):
        calls.append(space.key(p))
        return float(p["inter_op"])

    ex = EvaluationExecutor(obj, space, parallelism=2, backend="thread")
    pts = [{"inter_op": i, "intra_op": 0, "build": 1} for i in (3, 1, 2)]
    assert [r.value for r in ex.evaluate(pts)] == [3.0, 1.0, 2.0]
    again = ex.evaluate(pts)
    assert [r.value for r in again] == [3.0, 1.0, 2.0]
    assert all(r.meta.get("memoized") for r in again) and len(calls) == 3
    ex.close()


def test_executor_failure_isolation():
    space = golden_space()

    def obj(p):
        if p["inter_op"] % 2 == 0:
            raise RuntimeError("CUDA error: out of memory")
        return 1.0

    ex = EvaluationExecutor(obj, space, parallelism=3, backend="thread")
    out = ex.evaluate([{"inter_op": i, "intra_op": 0, "build": 1} for i in range(1, 9)])
    assert [r.value for r in out] == [1.0, -math.inf] * 4
    assert all("error" in r.meta for r in out if r.value == -math.inf)
    assert ex.evaluate([{"inter_op": 9, "intra_op": 0, "build": 1}])[0].value == 1.0
    ex.close()


def test_executor_timeout_scores_neg_inf():
    space = golden_space()

    def obj(p):
        if p["inter_op"] == 1:
            time.sleep(5)
        return 1.0

    ex = EvaluationExecutor(obj, space, parallelism=2, backend="thread", timeout=0.3)
    out = ex.evaluate([{"inter_op": 1, "intra_op": 0, "build": 1},
                       {"inter_op": 2, "intra_op": 0, "build": 1}])
    assert out[0].value == -math.inf and out[0].meta.get("timeout")
    assert out[1].value == 1.0
    ex.close()


def test_memo_cache_file_makes_a_second_run_measure_nothing(tmp_path):
    from repro_torch.tuning.objective import CountingEvaluator

    path = str(tmp_path / "memo.json")
    counts = []
    for _ in range(2):
        ev = CountingEvaluator(golden_objective)
        t = Tuner(ev, golden_space(),
                  TunerConfig(algorithm="ga", budget=10, seed=1, verbose=False,
                              memo_cache_path=path))
        t.run()
        t.close()
        counts.append(ev.calls)
    assert counts == [10, 0]
