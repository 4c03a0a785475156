"""Transfer-learning smoke benchmark: warm-starting from the corpus.

    PYTHONPATH=src python -m repro_torch.benchmarks.transfer_smoke --check \
        --out artifacts/transfer_smoke.json

Three synthetic workloads over the golden search space, each an
:class:`~repro_torch.tuning.objective.Evaluator` that declares roofline-style
``task_features()`` and sleeps a deterministic per-measurement cost:

* **job A** tunes cold and records every completed evaluation into a
  fresh observation corpus (``repro_torch.tuning.corpus``);
* **job B** is a *perturbed neighbor* of A — optimum shifted one grid
  step, values rescaled ~5%, task features ~10% apart — and is tuned
  twice: cold (no corpus) and warm (corpus-configured, so the BO
  surrogate seeds from A's observations under distance-inflated noise
  and the ask batches are pre-filtered against the neighbor prior);
* **job C** is *deliberately dissimilar* (task features ~100x apart, so
  ``workload_distance`` lands far beyond the ``max_distance`` cutoff and
  the corpus must contribute nothing).

``--check`` gates:

* warm job B reaches within 1% of its enumerated grid optimum at least
  **2x faster** than cold job B, in *both* wall-clock seconds and real
  measurement count (aggregated over seeds, time-to-target per run);
* dissimilar job C with the corpus configured regresses by at most
  1.05x against its corpus-free twin (the negative-transfer /
  max-distance guard: better no prior than a misleading one) — the
  traces are in fact byte-identical, which is also asserted;
* with no corpus configured, the BO golden sequential traces
  (``tests/golden/ask_tell_traces.json``, parallelism=1) are reproduced
  **bit-for-bit** — transfer machinery must be strictly additive.
"""
from __future__ import annotations

import argparse
import itertools
import json
import pathlib
import tempfile
import time

from repro_torch.core import SearchSpace, TransferConfig, Tuner, TunerConfig
from repro_torch.tuning.objective import Evaluator

GOLDEN_PATH = (pathlib.Path(__file__).resolve().parents[3]
               / "tests" / "golden" / "ask_tell_traces.json")

#: deterministic simulated measurement cost (seconds of real sleep) —
#: large against the tuner's per-ask overhead so the wall-clock gate
#: measures tuning efficiency, not GP arithmetic
EVAL_SLEEP_S = 0.05


def golden_space() -> SearchSpace:
    golden = json.loads(GOLDEN_PATH.read_text())
    return SearchSpace.from_dicts(golden["space"])


class SyntheticWorkload(Evaluator):
    """One tunable workload: a smooth single-peak landscape over the
    golden space plus roofline-style task features.

    The landscape is deliberately *wide* around its peak (low curvature)
    so "within 1% of the optimum" is a small neighborhood of grid
    points, not a single cell — the same shape real threading-parameter
    sweeps show (arxiv 1812.01665: near-optimal configs cluster).
    """

    def __init__(self, peak, scale: float, features,
                 sleep_s: float = EVAL_SLEEP_S):
        self.peak = dict(peak)
        self.scale = float(scale)
        self.features = dict(features)
        self.sleep_s = float(sleep_s)
        self.log = []  # (perf_counter at completion, value) per real call

    def task_features(self):
        return dict(self.features)

    def true_value(self, p) -> float:
        pk = self.peak
        return self.scale * (
            80.0
            - 0.25 * (p["inter_op"] - pk["inter_op"]) ** 2
            - (p["intra_op"] - pk["intra_op"]) ** 2 / 60.0
            - 8.0 * (p["build"] != pk["build"]))

    def grid_best(self, space: SearchSpace) -> float:
        dims = space.to_dicts()
        axes = []
        for d in dims:
            if d["type"] == "int":
                axes.append(range(d["min"], d["max"] + 1,
                                  d.get("step", 1) or 1))
            else:
                axes.append(d["choices"])
        names = [d["name"] for d in dims]
        return max(self.true_value(dict(zip(names, combo)))
                   for combo in itertools.product(*axes))

    def __call__(self, p, fidelity=None):
        time.sleep(self.sleep_s)
        v = self.true_value(p)
        self.log.append((time.perf_counter(), v))
        return v, {"cost_seconds": self.sleep_s}


# the three workloads; B is A's perturbed neighbor, C is dissimilar
def job_a():
    return SyntheticWorkload(
        peak={"inter_op": 6, "intra_op": 40, "build": 2}, scale=1.0,
        features={"flops": 3.0e12, "bytes": 1.2e10, "intensity": 250.0})


def job_b():
    return SyntheticWorkload(
        peak={"inter_op": 7, "intra_op": 45, "build": 2}, scale=1.05,
        features={"flops": 3.3e12, "bytes": 1.32e10, "intensity": 250.0})


def job_c():
    return SyntheticWorkload(
        peak={"inter_op": 14, "intra_op": 10, "build": 1}, scale=0.9,
        features={"flops": 3.0e10, "bytes": 4.0e8, "intensity": 75.0})


def _tune(workload: SyntheticWorkload, *, seed: int, budget: int,
          corpus_path=None, job_id=None):
    """One parallelism=1 tuning run; returns (history, time-to-target,
    evals-to-target) where the target is within 1% of the enumerated
    grid optimum.  Timing starts before Tuner construction so the warm
    path pays for its corpus read + prior fit."""
    space = golden_space()
    target = workload.grid_best(space) * 0.99
    transfer = (TransferConfig(corpus_path=str(corpus_path), job_id=job_id)
                if corpus_path is not None else None)
    t0 = time.perf_counter()
    tuner = Tuner(workload, space,
                  TunerConfig(algorithm="bo", budget=budget, seed=seed,
                              verbose=False, parallelism=1,
                              transfer=transfer))
    h = tuner.run()
    tuner.close()
    t_target = evals_target = None
    for i, (t_done, v) in enumerate(workload.log):
        if v >= target:
            t_target = t_done - t0
            evals_target = i + 1
            break
    return h, t_target, evals_target


def run_transfer(budget: int = 40, seeds=(0, 1), emit=print):
    """The full corpus workflow; returns ``(rows, ok)``."""
    rows = []
    with tempfile.TemporaryDirectory() as d:
        corpus = pathlib.Path(d) / "corpus.json"

        # -- untimed warmup: the first GP fits of a process pay PyTorch's
        # one-time start-up costs, on the cold path and on the transfer
        # path alike, so the timed comparison never measures them
        wa = job_a()
        _tune(wa, seed=0, budget=budget, corpus_path=corpus, job_id="warmup")
        wb = job_b()
        _tune(wb, seed=0, budget=budget, corpus_path=corpus,
              job_id="warmup-b")
        corpus.unlink()

        # -- job A: cold, recording into the corpus ------------------------
        a = job_a()
        h_a, t_a, n_a = _tune(a, seed=0, budget=budget,
                              corpus_path=corpus, job_id="job-A")
        n_recorded = len(json.loads(corpus.read_text()))
        rows.append({"mode": "corpus_populate", "job": "A",
                     "n_evals": len(h_a), "n_recorded": n_recorded,
                     "best": h_a.best().value})
        emit(f"transfer_corpus,A,evals={len(h_a)},recorded={n_recorded}")

        # -- job B: perturbed neighbor, cold vs warm, per seed -------------
        cold_t = cold_n = warm_t = warm_n = 0.0
        reached = True
        for seed in seeds:
            bc = job_b()
            _h, t_c, n_c = _tune(bc, seed=seed, budget=budget)
            bw = job_b()
            _h, t_w, n_w = _tune(bw, seed=seed, budget=budget,
                                 corpus_path=corpus,
                                 job_id=f"job-B-warm-{seed}")
            reached &= None not in (t_c, n_c, t_w, n_w)
            rows.append({"mode": "warm_vs_cold", "job": "B", "seed": seed,
                         "cold_seconds_to_target": t_c,
                         "cold_evals_to_target": n_c,
                         "warm_seconds_to_target": t_w,
                         "warm_evals_to_target": n_w})
            emit(f"transfer_b,seed={seed},cold_t="
                 f"{-1.0 if t_c is None else t_c:.3f},cold_n={n_c},"
                 f"warm_t={-1.0 if t_w is None else t_w:.3f},warm_n={n_w}")
            if reached:
                cold_t += t_c
                cold_n += n_c
                warm_t += t_w
                warm_n += n_w
        wall_ratio = cold_t / max(warm_t, 1e-9) if reached else 0.0
        eval_ratio = cold_n / max(warm_n, 1e-9) if reached else 0.0
        rows.append({"mode": "warm_vs_cold_total", "job": "B",
                     "seeds": list(seeds), "reached_target": reached,
                     "cold_seconds": cold_t, "warm_seconds": warm_t,
                     "cold_evals": cold_n, "warm_evals": warm_n,
                     "wall_clock_speedup": round(wall_ratio, 3),
                     "measurement_speedup": round(eval_ratio, 3)})
        emit(f"transfer_b_total,wall_speedup={wall_ratio:.2f}x,"
             f"eval_speedup={eval_ratio:.2f}x")
        ok_warm = reached and wall_ratio >= 2.0 and eval_ratio >= 2.0

        # -- job C: deliberately dissimilar — the corpus must not hurt -----
        cc = job_c()
        h_cc, t_cc, n_cc = _tune(cc, seed=0, budget=budget)
        cw = job_c()
        h_cw, t_cw, n_cw = _tune(cw, seed=0, budget=budget,
                                 corpus_path=corpus, job_id="job-C-warm")
        identical = h_cc.points() == h_cw.points()
        regression = ((n_cw / max(n_cc, 1)) if None not in (n_cc, n_cw)
                      else float("inf"))
        rows.append({"mode": "dissimilar_guard", "job": "C",
                     "cold_evals_to_target": n_cc,
                     "corpus_evals_to_target": n_cw,
                     "evals_regression": regression,
                     "traces_identical": identical})
        emit(f"transfer_c,cold_n={n_cc},corpus_n={n_cw},"
             f"identical={identical}")
        ok_dissimilar = identical and regression <= 1.05
    return rows, ok_warm, ok_dissimilar


def run_golden_check(emit=print):
    """No corpus configured => BO traces bit-for-bit equal to the pinned
    golden sequential traces.  Returns ``(rows, ok)``."""
    golden = json.loads(GOLDEN_PATH.read_text())
    space_dicts = golden["space"]

    def golden_objective(p):
        a, b, c = p["inter_op"], p["intra_op"], p["build"]
        return float(50.0 * pow(2.718281828, -((a - 11) / 5.0) ** 2)
                     + 0.3 * b - 0.004 * (b - 25) ** 2 + 7.0 * c)

    rows, ok = [], True
    for seed in (0, 3):
        trace = golden["traces"][f"bo:{seed}"]
        t = Tuner(golden_objective, SearchSpace.from_dicts(space_dicts),
                  TunerConfig(algorithm="bo", budget=18, seed=seed,
                              verbose=False, parallelism=1))
        h = t.run()
        t.close()
        match = h.points() == trace["points"]
        ok &= match
        rows.append({"mode": "golden_no_corpus", "algo": "bo", "seed": seed,
                     "bit_identical": match})
        emit(f"transfer_golden,bo,seed={seed},bit_identical={match}")
    return rows, ok


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget", type=int, default=40)
    ap.add_argument("--out", default=None)
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero unless warm-start beats cold 2x to "
                         "within-1%%-of-best (wall clock AND measurement "
                         "count), the dissimilar workload shows zero "
                         "regression, and the no-corpus golden traces stay "
                         "bit-for-bit (CI gate)")
    args = ap.parse_args(argv)
    failures = []
    rows, ok_warm, ok_dissimilar = run_transfer(budget=args.budget)
    if not ok_warm:
        failures.append(
            "transfer: warm-started job B did not reach within 1% of its "
            "grid optimum >= 2x faster than cold (wall clock and "
            "measurement count)")
    if not ok_dissimilar:
        failures.append(
            "transfer: the deliberately dissimilar job C regressed with "
            "the corpus configured (max-distance guard failed)")
    golden_rows, ok_golden = run_golden_check()
    rows += golden_rows
    if not ok_golden:
        failures.append(
            "transfer: BO golden sequential traces changed with no corpus "
            "configured (transfer machinery must be strictly additive)")
    if args.out:
        p = pathlib.Path(args.out)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(rows, indent=1))
    if args.check and failures:
        raise SystemExit("benchmark regression: " + "; ".join(failures))


if __name__ == "__main__":
    main()
