"""The paper's workload table and analytic surrogate against the reference.

Both packages compute the surrogate from Python's ``hash()`` (salted per
process), so the two agree bit for bit only inside one process — which is
where this test holds them: the same 200 seeded points of each workload's
space give the same float in both.
"""
import numpy as np
import pytest

from benchmarks import workloads as ref
from repro_torch.benchmarks import workloads as port
from repro_torch.core.space import SearchSpace

NAMES = [w["name"] for w in ref.MEASURED_WORKLOADS]


def test_workload_table_equals_reference():
    assert port.MEASURED_WORKLOADS == ref.MEASURED_WORKLOADS
    assert port._COMMON_DIMS == ref._COMMON_DIMS


@pytest.mark.parametrize("vals", [("dense_lm", (("batch", 8),)), ("x",), (1, 2.5, "y"),
                                  ("ncf", (("batch", 64), ("remat", "full")))])
def test_hash01_equals_reference(vals):
    assert port._hash01(*vals) == ref._hash01(*vals)


@pytest.mark.parametrize("i", range(len(NAMES)), ids=NAMES)
def test_surrogate_equals_reference_bit_for_bit(i):
    w_ref, w_port = ref.MEASURED_WORKLOADS[i], port.MEASURED_WORKLOADS[i]
    points = SearchSpace.from_dicts(w_port["space"]).sample(np.random.default_rng(i), 200)
    f_ref, f_port = ref.surrogate_objective(w_ref), port.surrogate_objective(w_port)
    got = [f_port(p) for p in points]
    assert got == [f_ref(p) for p in points]
    assert all(np.isfinite(got)) and len(set(got)) > 20
