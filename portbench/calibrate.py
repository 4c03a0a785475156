"""The readings a cell's limits are set from, on the card, in one process:
the program's numbers over many seeds, the control's (the reference in the
precision below the cell's) on some of them, and each planted fault's.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,13 \\
        --seconds 3 [--control 3] [--faults token,state_unchanged] [--out FILE]

One JSON line a run: the seed, what ran (``program``, ``fault:<name>``),
the numbers compared, the control's and the end-to-end metrics.  The
benchmark's own runs never run this.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import run as runner  # noqa: E402  (its environment: the caches, the import path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", type=int, default=0, help="read the control on the first N seeds")
    ap.add_argument("--faults", default="", help="comma-separated; each on the first three seeds")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    runner.environ()
    import torch

    from portbench import faults, harness, spec

    w = spec.workload(args.workload, runner.ROOT)
    drv = spec.driver(w["cell"]["driver"], runner.ROOT)
    training = w["cell"]["driver"] == "train_steps"
    seeds = [int(s) for s in args.seeds.split(",")]
    jobs = [(s, None) for s in seeds]
    jobs += [(s, f) for f in args.faults.split(",") if f for s in seeds[:3]]
    out = open(args.out, "a") if args.out else None
    device = torch.device("cuda", 0)
    for i, (seed, fault) in enumerate(jobs):
        undo = faults.plant(fault, training) if fault else None
        control = fault is None and seeds.index(seed) < args.control
        t0 = time.perf_counter() if i else STARTED
        try:
            r = harness.run_cell(args.workload, seed, args.seconds, False,
                                 device=device, started=t0, root=runner.ROOT, workload=w,
                                 after=drv.control if control else None)
        finally:
            if undo:
                undo()
        line = {"workload": args.workload, "seed": seed, "run": f"fault:{fault}" if fault else "program",
                "correct": r["correct"], "compared": {k: v["value"] for k, v in r["compared"].items()},
                "control": r.get("after"), "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                "device": r["device"]}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
