"""Tune the backend of one (arch x shape) cell for one NVIDIA H100 with
the roofline objective — the paper's methodology pointed at the card (each
evaluation traces the cell's step on ``meta`` tensors; no card needed).

    PYTHONPATH=src python -m repro_torch.examples.tune_backend \
        [--arch qwen2-0.5b] [--shape decode_32k] [--budget 12] \
        [--parallelism 4 --backend process] [--wall-clock 600] \
        [--loop async|batch] [--memo-cache artifacts/memo_cache.json] \
        [--cost-aware] [--multi-fidelity]

How it runs (completion-driven ask/tell):

* the tuner keeps ``--parallelism`` executor workers full: the engine is
  **asked** for a candidate the moment a worker frees up, and each
  result is **told** back the moment its analysis completes — in
  completion order, so one slow trace never stalls the other workers at a
  batch barrier (``--loop batch`` restores the legacy barrier loop for
  comparison).  A trace holds the GIL: parallel analyses need
  ``--backend process``;
* an out-of-memory configuration (peak bytes above the card's 80 GB)
  scores ``-inf`` without killing the worker pool, and ``--wall-clock``
  budgets by seconds instead of iteration count — the deadline also
  bounds *in-flight* analyses;
* every measurement is persisted twice over: the roofline analysis cache
  (``artifacts/tune_cache.json``, keyed by backend config) and the
  tuner's own ``--memo-cache`` (keyed by search-space point).  Both are
  atomic, file-locked JSON stores, so re-running this script re-evaluates
  nothing and concurrent runs merge rather than clobber;
* ``--parallelism 1`` (default) is the paper-faithful sequential loop;
* multi-host: start a measurement worker per host with
  ``--serve-worker --worker-port 9123`` (same --arch/--shape so both
  ends agree on the objective), then drive the fleet with ``--backend
  remote --workers hostA:9123,hostB:9123``.

``python -m repro_torch.launch.tune`` is the full tuning CLI; it exposes the
same knobs plus --eval-timeout and the scheduler flags.
"""
import argparse

from repro_torch.launch.tune import main as tune_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--budget", type=int, default=12)
    ap.add_argument("--algo", default="bo")
    ap.add_argument("--parallelism", type=int, default=1)
    ap.add_argument("--wall-clock", type=float, default=None,
                    help="seconds budget; bounds in-flight analyses too")
    ap.add_argument("--loop", default="async", choices=["async", "batch"],
                    help="completion-driven scheduler (default) vs legacy "
                         "per-batch barrier")
    ap.add_argument("--memo-cache", default="artifacts/memo_cache.json",
                    help="disk-backed memo of evaluated points; a second "
                         "run of the same job re-evaluates nothing")
    ap.add_argument("--cache", default="artifacts/tune_cache.json",
                    help="the roofline analysis cache, keyed by backend config")
    ap.add_argument("--cost-aware", action="store_true",
                    help="BO: EI-per-second acquisition (prefer cheap "
                         "traces, sharpening as --wall-clock runs out)")
    ap.add_argument("--multi-fidelity", action="store_true",
                    help="successive-halving rungs: cheap fast-analysis "
                         "screening, top-1/eta promoted to full depth "
                         "(--budget counts full-measurement equivalents)")
    ap.add_argument("--backend", default=None,
                    choices=["serial", "thread", "process", "remote"],
                    help="evaluation backend (process runs traces side by "
                         "side; remote farms them to --workers daemons)")
    ap.add_argument("--workers", default=None,
                    help="comma-separated host:port measurement workers "
                         "(implies --backend remote)")
    ap.add_argument("--serve-worker", action="store_true",
                    help="serve this cell's objective as a measurement "
                         "worker instead of tuning (--parallelism = "
                         "concurrent-measurement slots)")
    ap.add_argument("--worker-port", type=int, default=9123,
                    help="--serve-worker: port to listen on")
    args = ap.parse_args(argv)
    tune_argv = [
        "--arch", args.arch, "--shape", args.shape, "--algo", args.algo,
        "--budget", str(args.budget),
        "--parallelism", str(args.parallelism),
        "--loop", args.loop,
        "--cache", args.cache,
        "--memo-cache", args.memo_cache,
    ]
    if args.wall_clock is not None:
        tune_argv += ["--wall-clock", str(args.wall_clock)]
    if args.cost_aware:
        tune_argv += ["--cost-aware"]
    if args.multi_fidelity:
        tune_argv += ["--multi-fidelity"]
    if args.backend is not None:
        tune_argv += ["--backend", args.backend]
    if args.workers is not None:
        tune_argv += ["--workers", args.workers]
    if args.serve_worker:
        tune_argv += ["--serve-worker", "--worker-port", str(args.worker_port)]
    return tune_main(tune_argv)


if __name__ == "__main__":
    main()
