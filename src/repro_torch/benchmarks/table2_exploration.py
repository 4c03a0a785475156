"""Paper Table 2: per-parameter sampled-range coverage per algorithm.

    PYTHONPATH=src python -m repro_torch.benchmarks.table2_exploration

For each workload x algorithm, runs the 50-iteration tuning and reports
the (min,max) of sampled values vs the tunable range, as a percentage —
the paper's exploration/exploitation diagnostic (BO ~100%, GA <50%, NMS
between).

CSV rows: table2,<workload>,<algo>,<param>,<coverage_pct>
          table2_mean,<algo>,<mean_coverage_pct>

``--scheduler asha,hyperband,pbt`` reports the same coverage diagnostic
with the *trial scheduler* varied instead of the search engine (one
engine, the schedulers' different budget allocation — early-stopping
ladders vs mutating populations — is what moves coverage):

    table2_sched,<workload>,<scheduler>,<param>,<coverage_pct>
    table2_sched_mean,<scheduler>,<mean_coverage_pct>
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.benchmarks.workloads import MEASURED_WORKLOADS, surrogate_objective
from repro_torch.core import MultiFidelityConfig, SearchSpace, Tuner, TunerConfig

ALGOS = ("bo", "ga", "nms")


def run(budget: int = 50, emit=print):
    per_algo = {a: [] for a in ALGOS}
    for w in MEASURED_WORKLOADS:
        space = SearchSpace.from_dicts(w["space"])
        obj = surrogate_objective(w)
        for algo in ALGOS:
            t = Tuner(obj, space, TunerConfig(algorithm=algo, budget=budget,
                                              seed=0, verbose=False))
            h = t.run()
            fr = h.sampled_range_fraction()
            for name, f in fr.items():
                emit(f"table2,{w['name']},{algo},{name},{100*f:.0f}")
                per_algo[algo].append(f)
    means = {}
    for algo in ALGOS:
        means[algo] = float(np.mean(per_algo[algo]))
        emit(f"table2_mean,{algo},{100*means[algo]:.1f}")
    return means


def run_schedulers(schedulers, budget: int = 50, emit=print):
    from repro_torch.benchmarks.fig5_tuning_curves import FidelitySurrogate

    per_kind = {k: [] for k in schedulers}
    for w in MEASURED_WORKLOADS:
        space = SearchSpace.from_dicts(w["space"])
        for kind in schedulers:
            obj = FidelitySurrogate(surrogate_objective(w))
            t = Tuner(obj, space,
                      TunerConfig(algorithm="random", budget=budget, seed=0,
                                  verbose=False,
                                  multi_fidelity=MultiFidelityConfig(
                                      enabled=True, scheduler=kind,
                                      min_fidelity=1 / 9, eta=3)))
            h = t.run()
            t.close()
            for name, f in h.sampled_range_fraction().items():
                emit(f"table2_sched,{w['name']},{kind},{name},{100*f:.0f}")
                per_kind[kind].append(f)
    means = {}
    for kind in schedulers:
        means[kind] = float(np.mean(per_kind[kind]))
        emit(f"table2_sched_mean,{kind},{100*means[kind]:.1f}")
    return means


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scheduler", default=None,
                    help="comma-separated trial schedulers to compare "
                         "(asha,hyperband,pbt) instead of the search-"
                         "engine comparison")
    args = ap.parse_args(argv)
    if args.scheduler:
        kinds = [k.strip() for k in args.scheduler.split(",") if k.strip()]
        return run_schedulers(kinds)
    run()


if __name__ == "__main__":
    main()
