"""The paper's tuning framework applied to this framework's own backend:
one NVIDIA H100 by default, or a pod of ``--chips-per-pod`` of them (two
with ``--multi-pod``).

    PYTHONPATH=src python -m repro_torch.launch.tune --arch qwen2-0.5b \
        --shape train_4k --algo bo --budget 8 --memo-cache artifacts/memo.json
    PYTHONPATH=src python -m repro_torch.launch.tune --arch qwen2-0.5b \
        --shape train_4k --algo bo --budget 8 --chips-per-pod 256

Each evaluation traces the (arch x shape) cell's step with the candidate
BackendConfig, one device's share of it on a mesh (``launch/dryrun.py``:
``meta`` tensors, DTensors over a fake process group on a mesh, nothing
allocated, no card needed) and returns its roofline throughput;
configurations whose peak bytes a device exceed the card's 80 GB fail
(-inf) like crashed measurements in the paper.  Unlike the reference's CLI
this one sets no ``XLA_FLAGS`` and compiles nothing.  On one card
(``--chips-per-pod 1``, the default; the reference's is 256) the space
has no mesh dims (``backend_space(..., chips_per_pod=1)``); on a pod it
has the reference's ``log2_dp`` and ``sharding_style``.  The evaluator's
cache keys are the reference's, which do not name the pod size: give one
``--cache`` file one ``--chips-per-pod``.

Completion-driven evaluation: the engine keeps ``--parallelism`` workers
full and is told each result the moment its analysis finishes.  A trace
holds the GIL (it is Python dispatch throughout), so the thread backend
does not scale as the reference's XLA compiles did: ``--backend process``
runs analyses side by side (the dry run never initialises CUDA, so forked
workers are safe).  ``--loop batch`` restores the legacy per-batch barrier
for comparison.  ``--wall-clock`` caps tuning by seconds instead of / in
addition to iterations and bounds in-flight work: analyses still
unfinished at the deadline are abandoned unrecorded (enforceable with the
pool backends, which a wall-clock budget selects by default; a forced
serial backend can only stop between evaluations), and ``--eval-timeout``
scores any configuration that traces for too long as a failure instead of
stalling the run.  ``--memo-cache`` persists every measurement to a
file-locked on-disk store, so repeated or resumed runs (and other hosts
sharing the filesystem) re-evaluate nothing.  ``--cost-aware`` (BO)
switches the acquisition to EI-per-second: a second GP predicts each
candidate's measurement cost and the engine prefers cheap probes, ramping
the preference in as ``--wall-clock`` nears exhaustion.
``--multi-fidelity`` layers successive-halving rungs over the loop:
candidates are screened with the cheap fast analysis (1 and 2 periods
traced and extrapolated), the top ``1/eta`` survivors are promoted to the
whole-depth trace, and in-flight promotions that have been outclassed are
preempted; ``--budget`` then counts full-measurement equivalents.  The
roofline objective has exactly two analysis depths, so the default ladder
is the matching 2-rung one (``--mf-min-fidelity``).

Multi-host tuning splits this CLI across machines: run a measurement
worker per host and point one tuner at the fleet.

    # each measurement host serves the same (arch x shape) objective
    PYTHONPATH=src python -m repro_torch.launch.tune --arch qwen2-0.5b \
        --serve-worker --worker-port 9123 --parallelism 2

    # the tuner host drives the fleet (engine, history, and memo cache
    # stay here; workers need no shared filesystem)
    PYTHONPATH=src python -m repro_torch.launch.tune --arch qwen2-0.5b \
        --backend remote --workers hostA:9123,hostB:9123 \
        --memo-cache artifacts/memo.json --budget 50

``--workers`` implies ``--backend remote``; effective parallelism is the
fleet's slot total (``--parallelism`` on the *worker* side sets how many
concurrent analyses that host runs).  A worker dying mid-run is survived:
its in-flight measurements are reinjected onto surviving workers, never
recorded as failed configurations.  The wire protocol (length-prefixed
JSON over TCP: register, heartbeat, task, result) is documented in
``repro_torch.tuning.remote``; any objective can be served with the
generic ``python -m repro_torch.launch.worker`` daemon.

Tuning as a service: ``--submit-to host:port`` ships the run as a *job* to
a long-lived ``launch/service.py`` daemon (which multiplexes many jobs over
one shared fleet, fair-share scheduled, crash-resumable) and streams its
progress here; ``--detach`` just prints the job id.
"""
import argparse
import math
import pathlib

from repro_torch.configs import get_config
from repro_torch.core import SearchSpace, TransferConfig, Tuner, TunerConfig
from repro_torch.tuning.evaluator import RooflineEvaluator
from repro_torch.tuning.parameters import BASELINE, backend_space, config_from_point


def _transfer_config(args):
    """--corpus: record into / warm-start from an observation corpus."""
    if not args.corpus:
        return None
    return TransferConfig(
        corpus_path=args.corpus,
        job_id=f"{args.arch}:{args.shape}:{args.algo}:seed{args.seed}")


def _apply_scheduler(args, tc):
    """--scheduler + per-scheduler knobs -> the nested mf sub-config.
    A non-ASHA scheduler implies multi-fidelity mode (that is the loop
    the schedulers drive), so --multi-fidelity may be omitted."""
    tc.multi_fidelity.scheduler = args.scheduler
    if args.scheduler != "asha":
        tc.multi_fidelity.enabled = True
    tc.multi_fidelity.hyperband.brackets = args.hb_brackets
    tc.multi_fidelity.pbt.population = args.pbt_population
    tc.multi_fidelity.pbt.exploit_quantile = args.pbt_quantile
    tc.multi_fidelity.pbt.perturb_prob = args.pbt_perturb_prob
    tc.multi_fidelity.pbt.step_fidelity = args.pbt_step_fidelity
    return tc


def _submit(args, space):
    """--submit-to: ship the run to a service daemon, stream its progress."""
    from repro_torch.launch.service import ServiceClient, print_status
    from repro_torch.tuning.protocol import JobSpec

    config = _apply_scheduler(args, TunerConfig(
        algorithm=args.algo, budget=args.budget, seed=args.seed,
        loop=args.loop, cost_aware=args.cost_aware,
        wall_clock_budget=args.wall_clock,
        parallelism=args.parallelism,
        eval_timeout=args.eval_timeout,
        memo_cache_path=args.memo_cache,
        multi_fidelity=args.multi_fidelity,
        mf_eta=args.mf_eta, mf_min_fidelity=args.mf_min_fidelity,
        mf_preempt=not args.no_mf_preempt,
        transfer=_transfer_config(args),
    )).to_dict()
    spec = JobSpec(
        space=space.to_dicts(), config=config,
        name=args.job_name or f"{args.arch} x {args.shape} x {args.algo}",
        objective=args.job_objective)
    with ServiceClient(args.submit_to) as client:
        job_id = client.submit(spec)
        print(f"[tune] submitted {job_id} to {args.submit_to} "
              f"(service slots={client.slots})")
        if args.detach:
            print(f"[tune] watch with: python -m repro_torch.launch.service "
                  f"--connect {args.submit_to} --status {job_id} --watch")
            return job_id

        last = {"n": -1}

        def report(st):
            if st.get("n_evals", 0) != last["n"]:
                last["n"] = st.get("n_evals", 0)
                print_status(st)

        final = client.wait(job_id, on_status=report, poll_s=0.5)
        print_status(final)
        best = final.get("best")
        if best:
            print(f"[tune] best throughput {best['value']:.4g} tok/s at "
                  f"{best['point']}")
            print(f"[tune] backend config: "
                  f"{config_from_point(best['point'], BASELINE)}")
        elif final.get("state") == "failed":
            raise SystemExit(f"[tune] job failed: {final.get('error')}")
        return final


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--algo", default="bo",
                    choices=["bo", "ga", "nms", "random", "exhaustive"])
    ap.add_argument("--budget", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multi-pod", action="store_true",
                    help="two pods of --chips-per-pod chips")
    ap.add_argument("--chips-per-pod", type=int, default=1,
                    help="chips of a pod (1: one card; the reference's default is 256)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cache", default=None,
                    help="JSON cache of analysed evaluations (shared across algos)")
    ap.add_argument("--parallelism", type=int, default=1,
                    help="evaluation worker-pool width (1 = sequential loop)")
    ap.add_argument("--backend", "--executor-backend",
                    dest="executor_backend", default=None,
                    choices=["serial", "thread", "process", "remote"],
                    help="worker-pool backend (default: serial for "
                         "parallelism 1, thread above, remote when "
                         "--workers is given)")
    ap.add_argument("--workers", default=None,
                    help="comma-separated host:port measurement workers "
                         "(launch/worker.py daemons or --serve-worker "
                         "instances; implies --backend remote; effective "
                         "parallelism = the fleet's slot total)")
    ap.add_argument("--serve-worker", action="store_true",
                    help="run as a measurement worker instead of a tuner: "
                         "serve this (arch x shape) roofline objective to a "
                         "remote-backend tuner; --parallelism sets the "
                         "concurrent-measurement slots")
    ap.add_argument("--worker-host", default="0.0.0.0",
                    help="--serve-worker: interface to listen on")
    ap.add_argument("--worker-port", type=int, default=9123,
                    help="--serve-worker: port to listen on (0 = ephemeral, "
                         "printed at startup)")
    ap.add_argument("--eval-timeout", type=float, default=None,
                    help="seconds per evaluation before it scores -inf")
    ap.add_argument("--heartbeat-s", type=float, default=None,
                    help="worker heartbeat interval: with --serve-worker the "
                         "interval this daemon beats at; on the tuner side "
                         "the fleet-wide fallback (each worker's stall "
                         "window is 3 missed beats of its registered value)")
    ap.add_argument("--fleet-port", type=int, default=None,
                    metavar="PORT",
                    help="remote backend: keep a join socket open for the "
                         "whole run so launch/worker.py --join daemons can "
                         "register mid-run (0 = ephemeral, printed; default "
                         "0; with an explicit --fleet-port, --workers may be "
                         "empty — the fleet starts when the first worker "
                         "dials in)")
    ap.add_argument("--fleet-homogeneity", default="strict",
                    choices=["strict", "normalize"],
                    help="mixed hardware fingerprints in one fleet: strict "
                         "(default) refuses them; normalize admits them and "
                         "calibrates cost_seconds across partitions from "
                         "duplicate completions")
    ap.add_argument("--no-speculation", action="store_true",
                    help="remote backend: disable speculative re-execution "
                         "of straggling measurements")
    ap.add_argument("--speculation-factor", type=float, default=4.0,
                    help="duplicate an in-flight measurement once its age "
                         "exceeds this multiple of the per-fidelity p95 "
                         "completion time (first result wins, recorded once)")
    ap.add_argument("--wall-clock", type=float, default=None,
                    help="stop tuning after this many seconds (wall-clock "
                         "budget mode; combines with --budget; also bounds "
                         "in-flight evaluations)")
    ap.add_argument("--loop", default="async", choices=["async", "batch"],
                    help="async = completion-driven scheduler (default); "
                         "batch = legacy per-batch barrier")
    ap.add_argument("--memo-cache", default=None,
                    help="disk-backed memo cache of evaluated points "
                         "(atomic + file-locked; shared across runs/hosts)")
    ap.add_argument("--corpus", default=None,
                    help="persistent observation corpus for transfer "
                         "learning: record every completed evaluation, "
                         "warm-start the BO surrogate from neighboring "
                         "workloads recorded by earlier runs, and pre-"
                         "filter candidate batches against them")
    ap.add_argument("--cost-aware", action="store_true",
                    help="BO only: EI-per-second acquisition — trade "
                         "expected improvement against predicted measurement "
                         "cost, preferring cheap probes as --wall-clock "
                         "nears exhaustion")
    ap.add_argument("--multi-fidelity", action="store_true",
                    help="successive-halving (ASHA) rungs: screen candidates "
                         "with cheap fast-analysis traces, promote the top "
                         "1/eta per rung to full analysis depth; --budget "
                         "then counts full-measurement equivalents")
    ap.add_argument("--mf-eta", type=float, default=3.0,
                    help="rung reduction factor (fidelity ratio and survivor "
                         "fraction between adjacent rungs)")
    ap.add_argument("--mf-min-fidelity", type=float, default=0.33,
                    help="bottom-rung fidelity floor (fraction of a full "
                         "measurement).  The roofline objective has two "
                         "analysis depths (fast vs full), so the default "
                         "builds the matching 2-rung ladder [1/3, 1]; a "
                         "deeper ladder would re-serve identical fast "
                         "results at the middle rungs while still charging "
                         "budget for them")
    ap.add_argument("--no-mf-preempt", action="store_true",
                    help="disable preemption of in-flight promotions whose "
                         "source rung has since outclassed them")
    ap.add_argument("--scheduler", default="asha",
                    choices=["asha", "hyperband", "pbt"],
                    help="trial scheduler driving the multi-fidelity loop "
                         "(implies --multi-fidelity when not asha): asha = "
                         "one successive-halving ladder; hyperband = several "
                         "ASHA brackets with staggered min-fidelities, "
                         "budget split by completion; pbt = population-based "
                         "training (exploit/explore forks over mutating "
                         "points, warm-started via checkpoint-fork where the "
                         "objective supports it)")
    ap.add_argument("--hb-brackets", type=int, default=None,
                    help="hyperband: number of brackets (default: one per "
                         "rung of the deepest ladder)")
    ap.add_argument("--pbt-population", type=int, default=6,
                    help="pbt: steady-state population size")
    ap.add_argument("--pbt-quantile", type=float, default=0.25,
                    help="pbt: cull (bottom) and donor (top) quantile")
    ap.add_argument("--pbt-perturb-prob", type=float, default=0.25,
                    help="pbt: per-dimension mutation probability of an "
                         "explore step (at least one dim always moves)")
    ap.add_argument("--pbt-step-fidelity", type=float, default=None,
                    help="pbt: fidelity of each step (default: "
                         "--mf-min-fidelity)")
    ap.add_argument("--submit-to", default=None, metavar="HOST:PORT",
                    help="thin-client mode: submit this tuning run as a job "
                         "to a running launch/service.py daemon instead of "
                         "tuning locally, then stream its progress (the "
                         "daemon owns the measurement substrate — a remote "
                         "worker fleet or its --objective)")
    ap.add_argument("--job-name", default=None,
                    help="--submit-to: label for the job (default: "
                         "arch x shape x algo)")
    ap.add_argument("--job-objective", default=None,
                    help="--submit-to: module:factory() objective spec the "
                         "daemon should measure for this job (local-"
                         "measurement daemons only)")
    ap.add_argument("--detach", action="store_true",
                    help="--submit-to: print the job id and exit instead of "
                         "streaming progress")
    args = ap.parse_args(argv)
    if args.cost_aware and args.algo != "bo":
        ap.error("--cost-aware requires --algo bo")
    if args.submit_to and args.serve_worker:
        ap.error("--submit-to (thin client) and --serve-worker (measurement "
                 "daemon) are different processes")
    workers = ([w.strip() for w in args.workers.split(",") if w.strip()]
               if args.workers else None)
    if (args.executor_backend == "remote" and not workers
            and args.fleet_port is None):
        ap.error("--backend remote needs --workers host:port,... "
                 "(or an explicit --fleet-port to start an empty elastic "
                 "fleet that workers --join mid-run)")

    cfg = get_config(args.arch)
    shape_kind = "train" if args.shape.startswith("train") else "serve"
    space = SearchSpace.from_dicts(backend_space(cfg, kind=shape_kind,
                                                 chips_per_pod=args.chips_per_pod))
    print(f"[tune] space: {space.names} (grid {space.grid_size():,})")

    if args.submit_to:
        # thin client: the daemon measures; this process only submits the
        # (space, config) job and renders progress.  No evaluator — and
        # none of its trace state — is built here.
        return _submit(args, space)

    evaluator = RooflineEvaluator(
        args.arch, args.shape, multi_pod=args.multi_pod,
        chips_per_pod=args.chips_per_pod, cache_path=args.cache
    )
    if args.serve_worker:
        # worker mode: serve this cell's objective to a remote tuner.  The
        # evaluator (and its analysis cache) lives here; only points and
        # results cross the wire, and the tuner host persists the memo.
        from repro_torch.tuning.remote import DEFAULT_HEARTBEAT_S, WorkerServer

        server = WorkerServer(evaluator, host=args.worker_host,
                              port=args.worker_port,
                              slots=max(1, args.parallelism),
                              heartbeat_s=(args.heartbeat_s
                                           or DEFAULT_HEARTBEAT_S))
        print(f"[tune] serving measurement worker for ({args.arch} x "
              f"{args.shape}) on {server.host}:{server.port} "
              f"(slots={server.slots}); point the tuner at it with "
              f"--backend remote --workers <host>:{server.port}")
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            print("[tune] worker interrupted; shutting down")
        return None
    ckpt = (args.out + ".ckpt") if args.out else None
    tc = TunerConfig(algorithm=args.algo, budget=args.budget, seed=args.seed,
                     checkpoint_path=ckpt,
                     parallelism=args.parallelism,
                     executor_backend=args.executor_backend,
                     eval_timeout=args.eval_timeout,
                     wall_clock_budget=args.wall_clock,
                     loop=args.loop,
                     memo_cache_path=args.memo_cache,
                     cost_aware=args.cost_aware,
                     multi_fidelity=args.multi_fidelity,
                     mf_eta=args.mf_eta,
                     mf_min_fidelity=args.mf_min_fidelity,
                     mf_preempt=not args.no_mf_preempt,
                     workers=workers,
                     transfer=_transfer_config(args))
    _apply_scheduler(args, tc)
    # elastic-fleet knobs (remote backend only; no flat-kwarg legacy names)
    if args.fleet_port is not None:
        tc.executor.fleet_port = args.fleet_port
    tc.executor.fleet_homogeneity = args.fleet_homogeneity
    tc.executor.speculation = not args.no_speculation
    tc.executor.speculation_factor = args.speculation_factor
    tc.executor.heartbeat_s = args.heartbeat_s
    tuner = Tuner(evaluator, space, tc)
    pool = tuner.executor.remote_pool
    if pool is not None and pool.join_address:
        print(f"[tune] elastic fleet: workers can join mid-run with "
              f"launch/worker.py --join <host>:"
              f"{pool.join_address.rsplit(':', 1)[1]}")
    history = tuner.run()
    tuner.close()
    sched = tuner.rung_scheduler
    if sched is not None:
        kind = getattr(sched, "kind", "asha")
        for row in sched.stats():
            if kind == "pbt":
                print(f"[tune] population: members={row['members']} "
                      f"steps={row['steps']} forks={row['forks']} "
                      f"preempted={row['preempted']} best={row['best']} "
                      f"median={row['median']}")
            else:
                bracket = (f"bracket {row['bracket']} "
                           if "bracket" in row else "")
                print(f"[tune] {bracket}rung {row['rung']} "
                      f"(fidelity {row['fidelity']}): "
                      f"started={row['started']} "
                      f"completed={row['completed']} "
                      f"promoted={row['promoted']} "
                      f"preempted={row['preempted']}")
    if not any(math.isfinite(e.value) for e in history.evals):
        print(f"[tune] no successful evaluations "
              f"({len(history)} run, all failed or budget expired first)")
        if args.out:
            out = pathlib.Path(args.out)
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(history.to_json())
        return history
    full_only = (tc.multi_fidelity.enabled
                 and any(e.fidelity >= 1.0 and math.isfinite(e.value)
                         for e in history.evals))
    best = history.best(full_fidelity_only=full_only)
    print(f"[tune] best throughput {best.value:.4g} tok/s at {best.point}")
    print(f"[tune] backend config: {config_from_point(best.point, BASELINE)}")
    print(f"[tune] sampled-range coverage: {history.sampled_range_fraction()}")
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(history.to_json())
        print(f"[tune] wrote {out}")
    return history


if __name__ == "__main__":
    main()
