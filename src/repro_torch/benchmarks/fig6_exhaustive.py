"""Paper Fig. 6: exhaustive sweep + per-parameter sensitivity.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig6_exhaustive --workload dense_lm

Sweeps the full grid of one workload's space, then reports
  * the global optimum,
  * per-parameter sensitivity (mean throughput spread when the parameter
    varies with all others fixed — the paper's "which knob matters"),
  * the exhaustive-search cost argument from §1: grid points x per-eval
    cost vs the 50-evaluation tuner budget.

CSV rows: fig6_best / fig6_sensitivity / fig6_cost / fig6_tuner_gap.
"""
from __future__ import annotations

import argparse
import itertools
import time

import numpy as np

from repro_torch.benchmarks.workloads import MEASURED_WORKLOADS, surrogate_objective
from repro_torch.core import SearchSpace, Tuner, TunerConfig


def sensitivity(space: SearchSpace, values: dict) -> dict:
    """Mean range of the objective along each axis, others held fixed."""
    out = {}
    for d in space.dims:
        spreads = []
        others = [dd for dd in space.dims if dd.name != d.name]
        combos = itertools.product(*[dd.values for dd in others])
        for combo in itertools.islice(combos, 500):
            base = dict(zip([dd.name for dd in others], combo))
            ys = [values[space.key({**base, d.name: v})] for v in d.values]
            spreads.append(max(ys) - min(ys))
        out[d.name] = float(np.mean(spreads))
    return out


def run(workload_name: str = "dense_lm", emit=print):
    w = next(w for w in MEASURED_WORKLOADS if w["name"] == workload_name)
    space = SearchSpace.from_dicts(w["space"])
    obj = surrogate_objective(w)

    t0 = time.perf_counter()
    values = {}
    for p in space.enumerate():
        values[space.key(p)] = obj(p)
    sweep_s = time.perf_counter() - t0
    n = space.grid_size()
    per_eval_us = sweep_s / n * 1e6

    best_key = max(values, key=values.get)
    best_point = dict(zip(space.names, best_key))
    emit(f"fig6_best,{workload_name},{values[best_key]:.4f},\"{best_point}\"")

    sens = sensitivity(space, values)
    order = sorted(sens, key=sens.get, reverse=True)
    for name in order:
        emit(f"fig6_sensitivity,{workload_name},{name},{sens[name]:.4f}")

    # the paper's §1 cost argument: exhaustive vs 50-iteration tuning.
    # (their ResNet50 sweep: ~50k points ~= a month of CPU time)
    real_eval_s = 30.0  # a realistic single measured evaluation
    emit(f"fig6_cost,{workload_name},grid={n},exhaustive_hours="
         f"{n * real_eval_s / 3600:.1f},tuner_hours={50 * real_eval_s / 3600:.2f}")

    t = Tuner(obj, space, TunerConfig(algorithm="bo", budget=50, seed=0,
                                      verbose=False))
    h = t.run()
    gap = h.best().value / values[best_key]
    emit(f"fig6_tuner_gap,{workload_name},bo_50_iters_reaches,{gap:.4f}")
    return {"best": best_point, "sensitivity": sens, "bo_gap": gap,
            "per_eval_us": per_eval_us}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="dense_lm")
    args = ap.parse_args(argv)
    run(args.workload)


if __name__ == "__main__":
    main()
