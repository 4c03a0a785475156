"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each number the correctness check
compared, beside its limit.  The same numbers are the last lines of
standard error.  No card, or fewer than the cell asks for: exit 2 and no
result.  A module of JAX, Flax or the JAX package loaded by the end of the
window: exit 3 and no result.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHE = ROOT / "portbench" / ".cache"


def environ() -> None:
    """The program's build and kernel caches at fixed directories inside the
    checkout, so that only a cell's first run in a checkout builds."""
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(CACHE / "nvcc")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    # this file's folder holds modules named like the standard library's
    # (trace, stats): only the package may be imported from it
    here = str(ROOT / "portbench")
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    environ()
    import torch

    from portbench import harness, spec

    print(f"[portbench] interpreter and imports: {time.perf_counter() - STARTED:.3f} s",
          file=sys.stderr)

    w = spec.workload(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"[portbench] {args.workload} needs {w['chips']} NVIDIA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              device=device, started=STARTED, root=ROOT, workload=w)
    found = harness.forbidden_modules()
    if found:
        print(f"[portbench] modules of JAX or the JAX package were loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
