"""The port's fault-tolerance policies decide what the reference's decide:
the straggler detector on the same step-time sequences, the failure
injector's schedule for the same seed, and the elastic rescale plan."""
import numpy as np
import pytest

from repro.runtime import fault_tolerance as R
from repro_torch.runtime import fault_tolerance as T


def _sequences():
    rng = np.random.default_rng(0)
    steady = 1.0 + 0.01 * np.sin(np.arange(40))
    yield "steady", steady
    yield "sustained", np.concatenate([steady, [10.0] * 5, steady[:5]])
    yield "blips", np.concatenate([steady, [10.0, 1.0, 10.0, 10.0, 1.0, 10.0, 10.0, 10.0]])
    yield "noisy", rng.lognormal(0.0, 0.3, 200)
    yield "drift", np.linspace(1.0, 3.0, 100) + rng.normal(0, 0.01, 100)


@pytest.mark.parametrize("name,times", list(_sequences()), ids=[n for n, _ in _sequences()])
@pytest.mark.parametrize("kw", [{}, {"warmup": 5, "sustained": 2, "z_threshold": 3.0}])
def test_straggler_detector_decides_as_the_reference(name, times, kw):
    ref, port = R.StragglerDetector(**kw), T.StragglerDetector(**kw)
    want = [ref.update(float(t)) for t in times]
    got = [port.update(float(t)) for t in times]
    assert got == want
    assert port.baseline == ref.baseline
    if name == "sustained":
        assert any(got)


@pytest.mark.parametrize("rate,seed,at", [(0.0, 0, [3, 7]), (0.2, 1, []), (0.05, 5, [0])])
def test_failure_injector_schedule_is_the_reference_schedule(rate, seed, at):
    def schedule(mod):
        inj = mod.FailureInjector(rate=rate, seed=seed, at_steps=list(at))
        out = []
        for step in list(range(40)) + list(at):  # a scheduled failure fires once
            try:
                inj.check(step)
                out.append(None)
            except mod.WorkerFailure as e:
                out.append((e.step, e.failed_workers, str(e)))
        return out
    got, want = schedule(T), schedule(R)
    assert got == want
    assert any(x is not None for x in got)


@pytest.mark.parametrize("dp,tp,lost", [(16, 16, 16), (4, 2, 1), (2, 1, 1), (8, 1, 3),
                                        (1, 4, 1)])
def test_elastic_plan_is_the_reference_plan(dp, tp, lost):
    def plan(mod):
        try:
            p = mod.ElasticPlan.after_failure(dp=dp, tp=tp, lost_chips=lost)
            return (p.old_dp, p.new_dp, p.tp, p.chips)
        except RuntimeError as e:
            return str(e)
    assert plan(T) == plan(R)
