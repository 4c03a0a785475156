"""The synthetic tuning objective that the smoke benchmarks' worker
daemons serve.

    PYTHONPATH=src python -m repro_torch.launch.worker --port 9123 \\
        --objective repro_torch.benchmarks.perf_iterations:make_remote_bench_objective()

Only the zero-argument factory :func:`make_remote_bench_objective` and
the helpers it needs are here: a deterministic landscape over the golden
search space (max ~84 at inter_op=11, intra_op=60, build=3) whose
measurements sleep a skewed cost — a quarter of the grid is 8x slower.
The rest of the reference package's ``benchmarks/perf_iterations.py``
(the micro-benchmarks and their gates) is not ported yet.
"""
from __future__ import annotations

import time


def _bench_value(p) -> float:
    """The shared synthetic tuning landscape (max ~84 at inter_op=11,
    intra_op=60, build=3) — one definition so every gated benchmark and
    its margins measure the same objective."""
    a, b, c = p["inter_op"], p["intra_op"], p["build"]
    return float(50.0 * 2.718281828 ** (-((a - 11) / 5.0) ** 2)
                 + 0.3 * b - 0.004 * (b - 25) ** 2 + 7.0 * c)


# skewed-cost parameters shared by the async and remote comparisons
_SKEW_FAST_S, _SKEW_SLOW_S = 0.02, 0.16


def _skewed_sleep_value(p, fast_s=_SKEW_FAST_S, slow_s=_SKEW_SLOW_S):
    time.sleep(slow_s if (p["inter_op"] + p["intra_op"]) % 4 == 0 else fast_s)
    return _bench_value(p)


def make_remote_bench_objective():
    """Factory the worker daemons import (--objective ...:name()): the
    same skewed-cost objective the local comparisons tune, built ON the
    worker so nothing but points and results crosses the wire."""
    from repro_torch.tuning.objective import Evaluator

    class SkewedBenchObjective(Evaluator):
        def __call__(self, p, fidelity=None):
            v = _skewed_sleep_value(p)
            return v, {"cost_seconds":
                       _SKEW_SLOW_S if (p["inter_op"] + p["intra_op"]) % 4
                       == 0 else _SKEW_FAST_S}

    return SkewedBenchObjective()
