"""Kernel-autotuning sweep: tune the package's own hand-written kernels and
persist the answers in a :class:`~repro_torch.tuning.tundb.TuningDB`.

    PYTHONPATH=src python -m repro_torch.benchmarks.kernel_sweep \\
        --db artifacts/tundb.json --kernels rmsnorm gla_scan --budget 6

Per kernel, a gradient-free search over its tile knobs
(``repro_torch.tuning.kernel_objective``), measured with the shared
variance-adaptive wall-clock harness on ``--device`` (``cuda`` by default:
the hand-written kernels; ``cpu`` runs their plain versions, for a check of
the loop without a card), best config + provenance written to the DB keyed
by (kernel, shape bucket, hardware fingerprint).  Every later serve run
started with ``--tuning-db <path>`` then picks the tuned tiles up when its
steps are built.

The sweep is *warm-start aware*: a kernel whose (shape bucket,
fingerprint) already has a DB record is skipped outright — a second
identical sweep re-measures **nothing** (the acceptance gate of
``--check``).  The tuner's async completion-driven loop, ASHA
multi-fidelity rungs (``--multi-fidelity``) and the remote worker backend
(``--workers``) compose unchanged under this driver.

``--check`` gates:
  * the cold sweep measures > 0 configs and persists a DB;
  * a warm re-run of the identical sweep performs 0 re-measurements;
  * a DB lookup costs < 1 ms median (the dispatch layer consults the DB
    once per distinct call shape, so it must be negligible there).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import time
from dataclasses import replace

from repro_torch.core import Tuner, TunerConfig
from repro_torch.core.space import SearchSpace
from repro_torch.tuning.kernel_objective import KERNELS, KernelTuneEvaluator, kernel_space
from repro_torch.tuning.objective import CountingEvaluator
from repro_torch.tuning.tundb import TuningDB, hardware_fingerprint


def run_sweep(kernels, db: TuningDB, *, budget: int = 6,
              algorithm: str = "random", parallelism: int = 1,
              multi_fidelity: bool = False, workers=None, shapes=None,
              warmup: int = 1, iters: int = 2, rel_halfwidth: float = 0.5,
              seed: int = 0, device: str = "cuda", transfer=None, emit=print):
    """Tune each kernel (unless the DB already holds its answer).

    ``transfer`` (a ``TransferConfig``) records every measurement into
    its corpus, under a job id of the kernel's own.  Returns ``(rows,
    measured)`` — per-kernel result rows (with the engine's per-ask
    seconds where it keeps them, as BO does) and the total number of
    *real* measurements performed (0 on a warm DB).
    """
    rows, measured = [], 0
    for name in kernels:
        spec = KERNELS[name]
        shape = dict((shapes or {}).get(name, spec.shape))
        hit = db.lookup(name, shape)
        if hit is not None:
            rows.append({"kernel": name, "shape": shape, "skipped": True,
                         "measurements": 0, "best": hit["config"],
                         "value": hit["value"]})
            emit(f"kernelsweep,{name},warm,0,{hit['value']:.4g},"
                 f"{json.dumps(hit['config'], sort_keys=True)}")
            continue
        evaluator = CountingEvaluator(KernelTuneEvaluator(
            name, shape, warmup=warmup, iters=iters,
            rel_halfwidth=rel_halfwidth, device=device))
        space = SearchSpace.from_dicts(kernel_space(name, shape))
        t = Tuner(evaluator, space,
                  TunerConfig(algorithm=algorithm,
                              budget=min(budget, space.grid_size()),
                              seed=seed, verbose=False,
                              parallelism=parallelism,
                              multi_fidelity=multi_fidelity,
                              workers=list(workers) if workers else None,
                              transfer=(None if transfer is None else replace(
                                  transfer, job_id=f"kernel_sweep:{name}:seed{seed}"))))
        t0 = time.perf_counter()
        h = t.run()
        secs = time.perf_counter() - t0
        t.close()
        best = h.best(full_fidelity_only=multi_fidelity)
        db.record(name, shape, best.point, best.value,
                  fidelity=best.fidelity,
                  job_id=f"kernel_sweep:{algorithm}:seed{seed}")
        measured += evaluator.calls
        rows.append({"kernel": name, "shape": shape, "skipped": False,
                     "measurements": evaluator.calls, "n_evals": len(h),
                     "best": best.point, "value": best.value,
                     "step_seconds": best.meta.get("step_seconds"),
                     "seconds": round(secs, 3),
                     "ask_seconds": list(getattr(t.engine, "ask_seconds", []))})
        emit(f"kernelsweep,{name},cold,{evaluator.calls},{best.value:.4g},"
             f"{json.dumps(best.point, sort_keys=True)}")
    return rows, measured


def lookup_latency_ms(db: TuningDB, kernels, shapes=None,
                      trials: int = 200) -> float:
    """Median DB lookup cost in milliseconds.

    The dispatch layer calls ``db.kernel_config`` once per kernel and
    distinct call shape; the gate pins the cost anyway so a regression
    (say, a file read per lookup) cannot hide."""
    times = []
    for _ in range(trials):
        for name in kernels:
            shape = dict((shapes or {}).get(name, KERNELS[name].shape))
            t0 = time.perf_counter()
            db.kernel_config(name, shape)
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--db", required=True, metavar="PATH",
                    help="TuningDB json path (created if absent)")
    ap.add_argument("--kernels", nargs="+", default=sorted(KERNELS),
                    choices=sorted(KERNELS))
    ap.add_argument("--budget", type=int, default=6,
                    help="tuning evaluations per kernel")
    ap.add_argument("--algorithm", default="random",
                    help="ask/tell engine: bo|ga|nms|random|exhaustive")
    ap.add_argument("--parallelism", type=int, default=1)
    ap.add_argument("--multi-fidelity", action="store_true",
                    help="screen candidates on ASHA rungs (partial "
                         "wall-clock measurements)")
    ap.add_argument("--workers", nargs="*", default=None,
                    help="host:port measurement worker daemons")
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default): the hand-written kernels; cpu: "
                         "their plain versions, a check of the loop only")
    ap.add_argument("--out", default=None, help="write result rows as json")
    ap.add_argument("--check", action="store_true",
                    help="gate: after the sweep, a warm re-run must "
                         "re-measure 0 configs and median DB lookup must "
                         "stay under 1 ms")
    args = ap.parse_args(argv)

    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                "--device cuda (the default) needs an NVIDIA GPU and none is "
                "visible; pass --device cpu to run the loop on the plain versions")
    fingerprint = hardware_fingerprint(args.device)
    db = TuningDB(args.db, fingerprint=fingerprint)
    sweep = dict(budget=args.budget, algorithm=args.algorithm,
                 parallelism=args.parallelism, multi_fidelity=args.multi_fidelity,
                 workers=args.workers, iters=args.iters, seed=args.seed,
                 device=args.device)
    rows, measured = run_sweep(args.kernels, db, **sweep)
    print(f"[kernel_sweep] {len(args.kernels)} kernels, {measured} "
          f"measurements, db={args.db} ({len(db)} records)")

    failures = []
    if args.check:
        if measured == 0:
            failures.append("cold sweep performed no measurements "
                            "(delete the db for a true cold run)")
        # warm re-run against a FRESH TuningDB instance on the same path:
        # everything must come back from disk, nothing re-measured
        warm_db = TuningDB(args.db, fingerprint=fingerprint)
        warm_rows, warm_measured = run_sweep(args.kernels, warm_db, **sweep)
        rows += [dict(r, phase="warm") for r in warm_rows]
        if warm_measured != 0:
            failures.append(f"warm re-run re-measured {warm_measured} "
                            "configs (must be 0)")
        ms = lookup_latency_ms(warm_db, args.kernels)
        rows.append({"mode": "lookup_latency", "median_ms": round(ms, 5)})
        print(f"[kernel_sweep] warm re-measurements={warm_measured}, "
              f"lookup median={ms:.4f}ms")
        if ms >= 1.0:
            failures.append(f"median DB lookup {ms:.3f}ms >= 1ms")

    if args.out:
        p = pathlib.Path(args.out)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(rows, indent=1))
    if args.check and failures:
        raise SystemExit("kernel-sweep regression: " + "; ".join(failures))


if __name__ == "__main__":
    main()
