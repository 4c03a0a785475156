"""Benchmark harness entry point — one section per paper table/figure.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--fast] [--measured]

Emits CSV lines ``name,...`` per artifact:
  fig5_*    — tuning-curve comparison (paper Fig. 5)
  fig6_*    — exhaustive sweep + sensitivity (paper Fig. 6)
  table2_*  — sampled-range coverage (paper Table 2 / Fig. 7)
  roofline  — the 40-cell dry-run roofline table for one H100 (§Roofline)
"""
import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="smaller budgets/seeds for CI")
    ap.add_argument("--measured", action="store_true",
                    help="fig5 measures real wall-clock configurations")
    ap.add_argument("--parallelism", type=int, default=1,
                    help="evaluation worker-pool width for the tuning "
                         "sections (batched ask/tell executor)")
    ap.add_argument("--device", default="cuda",
                    help="where fig5 --measured runs its steps (cuda | cpu)")
    args = ap.parse_args(argv)

    from repro_torch.benchmarks import (fig5_tuning_curves, fig6_exhaustive, roofline,
                                        table2_exploration)

    budget = 25 if args.fast else 50
    seeds = 2 if args.fast else 3

    t0 = time.perf_counter()
    fig5_tuning_curves.run(measured=args.measured, budget=budget, seeds=seeds,
                           parallelism=args.parallelism, device=args.device)
    print(f"# fig5 done in {time.perf_counter()-t0:.1f}s")

    t0 = time.perf_counter()
    fig6_exhaustive.run("dense_lm")
    print(f"# fig6 done in {time.perf_counter()-t0:.1f}s")

    t0 = time.perf_counter()
    table2_exploration.run(budget=budget)
    print(f"# table2 done in {time.perf_counter()-t0:.1f}s")

    t0 = time.perf_counter()
    roofline.run()
    print(f"# roofline done in {time.perf_counter()-t0:.1f}s")


if __name__ == "__main__":
    main()
