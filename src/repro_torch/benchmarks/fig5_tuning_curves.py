"""Paper Fig. 5: tuning curves — BO vs GA vs NMS on every workload.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig5_tuning_curves
    PYTHONPATH=src python -m repro_torch.benchmarks.fig5_tuning_curves --measured

Default: surrogate objective, 50 iterations, 3 seeds (seconds).
``--measured``: real wall-clock measurement of each configuration
(``MeasuredEvaluator``, the paper's harness; minutes) on ``--device``:
``cuda`` by default, raising when there is no card; ``--device cpu`` runs
the reference's setting on the CPU.  The language models train their
reduced configs, as in the reference.  CSV rows:

    fig5,<workload>,<algo>,<seed>,<iter>,<best_so_far>
    fig5_final,<workload>,<algo>,<mean_best>,<std_best>

``--scheduler asha,hyperband,pbt`` switches to the *scheduler*
comparison on the same substrate: one search engine, the trial
scheduler varied, best-so-far charted against logical budget spend.
CSV rows mirror the algorithm mode:

    fig5_sched,<workload>,<scheduler>,<seed>,<iter>,<best_so_far>
    fig5_sched_final,<workload>,<scheduler>,<mean_best>,<std_best>
"""
from __future__ import annotations

import argparse
import zlib

import numpy as np

from repro_torch.benchmarks.workloads import (
    MEASURED_WORKLOADS,
    MeasuredEvaluator,
    surrogate_objective,
)
from repro_torch.core import MultiFidelityConfig, SearchSpace, Tuner, TunerConfig
from repro_torch.tuning.objective import Evaluator

ALGOS = ("bo", "ga", "nms")


class FidelitySurrogate(Evaluator):
    """The analytic surrogate made fidelity- and fork-capable so every
    scheduler runs its real code path: low fidelity adds a deterministic
    point-dependent bias that shrinks toward zero at full fidelity, and
    the checkpoint-fork blob carries a step counter (PBT lineages
    exercise resume without changing the measured value)."""

    supports_fidelity = True
    supports_fork = True

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, point, fidelity=None, resume_state=None):
        f = 1.0 if fidelity is None else float(fidelity)
        v = float(self.fn(point))
        digest = zlib.crc32(repr(sorted(point.items())).encode())
        wiggle = (digest % 9 - 4) / 40.0
        steps = (resume_state or {}).get("steps", 0)
        return v * (1.0 + (1.0 - f) * wiggle), {
            "fork_state": {"steps": steps + 1}}


def run_schedulers(schedulers, budget: int = 50, seeds: int = 3,
                   parallelism: int = 1, emit=print):
    """ASHA vs HyperBand vs PBT best-so-far on the surrogate substrate."""
    summary = {}
    for w in MEASURED_WORKLOADS:
        space = SearchSpace.from_dicts(w["space"])
        for kind in schedulers:
            finals = []
            for seed in range(seeds):
                obj = FidelitySurrogate(surrogate_objective(w))
                t = Tuner(obj, space,
                          TunerConfig(algorithm="random", budget=budget,
                                      seed=seed, verbose=False,
                                      parallelism=parallelism,
                                      multi_fidelity=MultiFidelityConfig(
                                          enabled=True, scheduler=kind,
                                          min_fidelity=1 / 9, eta=3)))
                h = t.run()
                t.close()
                for it, best in enumerate(h.best_curve()):
                    emit(f"fig5_sched,{w['name']},{kind},{seed},{it},"
                         f"{best:.4f}")
                finals.append(h.best().value)
            summary[(w["name"], kind)] = (float(np.mean(finals)),
                                          float(np.std(finals)))
            emit(f"fig5_sched_final,{w['name']},{kind},"
                 f"{np.mean(finals):.4f},{np.std(finals):.4f}")
    for w in MEASURED_WORKLOADS:
        scores = {k: summary[(w["name"], k)][0] for k in schedulers}
        winner = max(scores, key=scores.get)
        emit(f"fig5_sched_winner,{w['name']},{winner}")
    return summary


def run(measured: bool = False, budget: int = 50, seeds: int = 3,
        parallelism: int = 1, emit=print, device: str = "cuda"):
    summary = {}
    for w in MEASURED_WORKLOADS:
        space = SearchSpace.from_dicts(w["space"])
        for algo in ALGOS:
            finals = []
            for seed in range(seeds):
                if measured:
                    obj = MeasuredEvaluator(w, device=device, iters=2)
                else:
                    obj = surrogate_objective(w)
                t = Tuner(obj, space,
                          TunerConfig(algorithm=algo, budget=budget,
                                      seed=seed, verbose=False,
                                      parallelism=parallelism))
                h = t.run()
                t.close()
                for it, best in enumerate(h.best_curve()):
                    emit(f"fig5,{w['name']},{algo},{seed},{it},{best:.4f}")
                finals.append(h.best().value)
            summary[(w["name"], algo)] = (float(np.mean(finals)),
                                          float(np.std(finals)))
            emit(f"fig5_final,{w['name']},{algo},"
                 f"{np.mean(finals):.4f},{np.std(finals):.4f}")
    # who wins each workload?
    for w in MEASURED_WORKLOADS:
        scores = {a: summary[(w["name"], a)][0] for a in ALGOS}
        winner = max(scores, key=scores.get)
        emit(f"fig5_winner,{w['name']},{winner}")
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--measured", action="store_true")
    ap.add_argument("--budget", type=int, default=50)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--parallelism", type=int, default=1,
                    help="evaluation worker-pool width (batched ask/tell)")
    ap.add_argument("--scheduler", default=None,
                    help="comma-separated trial schedulers to compare "
                         "(asha,hyperband,pbt) instead of the search-"
                         "engine comparison")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where --measured runs the steps (cuda: the card)")
    args = ap.parse_args(argv)
    if args.scheduler:
        kinds = [k.strip() for k in args.scheduler.split(",") if k.strip()]
        return run_schedulers(kinds, budget=args.budget, seeds=args.seeds,
                              parallelism=args.parallelism)
    run(measured=args.measured, budget=args.budget, seeds=args.seeds,
        parallelism=args.parallelism, device=args.device)


if __name__ == "__main__":
    main()
