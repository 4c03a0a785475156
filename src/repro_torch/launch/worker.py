"""Measurement-worker daemon for the remote executor backend.

Run one of these per measurement host, point it at the objective it
should serve, and hand the tuner the ``host:port`` list:

    # on each measurement host
    PYTHONPATH=src python -m repro_torch.launch.worker --port 9123 --slots 2 \
        --objective repro_torch.benchmarks.perf_iterations:make_remote_bench_objective()

    # on the tuner host: a Tuner with workers=["hostA:9123", ...], or the
    # tuning service
    PYTHONPATH=src python -m repro_torch.launch.service --serve \
        --workers hostA:9123,hostB:9123

A worker is a process of its own, started by the command above, so it
never inherits a CUDA context through a fork: an objective that measures
on the card initialises CUDA in the worker, after it started.  Such a
worker serves ``--slots 1``: measurements that overlap on one card
perturb each other's times.

``--objective module:attr`` names the objective; append ``()`` to call
it as a zero-argument factory (the usual shape — a factory builds the
evaluator *on the worker*, so heavyweight state like compile caches
never crosses the wire).  The resolved object may be an
``Evaluator``/``(value, meta)`` callable or a plain scalar objective;
``as_evaluator`` normalizes it exactly as the local backends do.

The daemon registers with the connecting tuner, heartbeats every
``--heartbeat-s`` seconds, pulls ``(point, fidelity)`` tasks into a
``--slots``-wide measurement pool, and streams results back in
completion order.  With ``--join HOST:PORT`` the direction flips: the
daemon dials a *running* tuner's join socket and registers mid-run
(elastic fleets) — the session is otherwise identical.  It never touches the memo cache — results are
persisted by the tuner host, so workers need no shared filesystem.  A
tuner disconnect ends the session and the daemon goes back to
accepting, so a fleet survives tuner restarts.
"""
from __future__ import annotations

import argparse
import importlib
import os
import signal
import traceback

from repro_torch.tuning.remote import DEFAULT_HEARTBEAT_S, WorkerServer


def resolve_objective(spec: str):
    """``module:attr`` or ``module:factory()`` -> the objective object.

    Every failure mode raises with a message that names the spec and
    the precise step that broke (malformed spec, unimportable module,
    missing attribute, raising factory) — this text travels to the
    tuner in the register reply when the daemon serves in error mode,
    so the *submitting* side sees why its fleet cannot measure.
    """
    mod_name, sep, attr = spec.partition(":")
    if not sep or not attr or not mod_name:
        raise ValueError(
            f"objective spec {spec!r} is not module:attr (append () to "
            "call a zero-arg factory, e.g. pkg.mod:make_objective())")
    call = attr.endswith("()")
    if call:
        attr = attr[:-2]
    if not attr.isidentifier():
        raise ValueError(
            f"objective spec {spec!r}: {attr!r} is not a plain attribute "
            "name (only zero-arg factory calls are supported — spell "
            "arguments into a wrapper factory instead)")
    try:
        module = importlib.import_module(mod_name)
    except ImportError as e:
        raise ValueError(
            f"objective spec {spec!r}: cannot import module "
            f"{mod_name!r}: {e!r}") from e
    try:
        obj = getattr(module, attr)
    except AttributeError:
        raise ValueError(
            f"objective spec {spec!r}: module {mod_name!r} has no "
            f"attribute {attr!r}") from None
    if not call:
        return obj
    try:
        return obj()
    except Exception as e:
        raise ValueError(
            f"objective spec {spec!r}: factory {mod_name}:{attr} raised "
            f"{e!r}") from e


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve measurements to a remote-backend tuner "
                    "(see repro_torch.tuning.remote for the wire protocol).")
    ap.add_argument("--objective", required=True,
                    help="module:attr naming the objective to serve; "
                         "append () to call it as a zero-arg factory")
    ap.add_argument("--host", default="0.0.0.0",
                    help="interface to listen on (default: all)")
    ap.add_argument("--port", type=int, default=None,
                    help="port to listen on (0 = ephemeral, printed; "
                         "default 9123, or ephemeral with --join)")
    ap.add_argument("--slots", type=int, default=1,
                    help="concurrent measurements this host runs "
                         "(fleet parallelism = sum of slots)")
    ap.add_argument("--heartbeat-s", "--heartbeat", dest="heartbeat_s",
                    type=float, default=DEFAULT_HEARTBEAT_S,
                    help="seconds between heartbeats (the tuner declares "
                         "this worker dead after 3 missed ones)")
    ap.add_argument("--join", default=None, metavar="HOST:PORT",
                    help="elastic mode: dial a running tuner's join socket "
                         "and register mid-run instead of listening for "
                         "tuners to connect here")
    ap.add_argument("--join-retry-s", type=float, default=None,
                    help="with --join: keep re-dialing every N seconds "
                         "through tuner restarts (default: one-shot — "
                         "serve one session and exit)")
    ap.add_argument("--fingerprint-tag", default=None,
                    help="append a tag to the hardware fingerprint shipped "
                         "at register time (testing: simulate distinct "
                         "hardware partitions on one host)")
    ap.add_argument("--serve-startup-error", action="store_true",
                    help="when the objective fails to resolve, keep serving "
                         "in error mode (register replies carry the error, "
                         "so connecting tuners fail loudly with the real "
                         "cause) instead of exiting")
    args = ap.parse_args(argv)

    # resolve at STARTUP, loudly: a bad --objective must never look like
    # a healthy worker.  The default is to crash the daemon with the full
    # traceback; --serve-startup-error keeps the port open and ships the
    # error to every tuner that registers, for fleets managed by
    # supervisors where a crash loop would just look like "unreachable".
    objective, startup_error = None, None
    try:
        objective = resolve_objective(args.objective)
    except ValueError as e:
        print(f"[worker] OBJECTIVE FAILED AT STARTUP: {e}", flush=True)
        traceback.print_exc()
        if not args.serve_startup_error:
            raise
        startup_error = str(e)

    port = args.port if args.port is not None else (0 if args.join else 9123)
    server = WorkerServer(objective,
                          host=args.host, port=port,
                          slots=args.slots, heartbeat_s=args.heartbeat_s,
                          startup_error=startup_error)
    if args.fingerprint_tag is not None:
        server.fingerprint = dict(server.fingerprint,
                                  tag=args.fingerprint_tag)
    if startup_error is not None:
        print(f"[worker] pid={os.getpid()} serving ERROR MODE on "
              f"{server.host}:{server.port} — registering tuners will be "
              "told the startup error", flush=True)
    elif args.join:
        print(f"[worker] pid={os.getpid()} joining fleet at {args.join} "
              f"with {args.objective!r} (slots={server.slots})", flush=True)
    else:
        print(f"[worker] pid={os.getpid()} serving {args.objective!r} on "
              f"{server.host}:{server.port} (slots={server.slots})",
              flush=True)
    if args.join:
        # SIGTERM on a joined daemon = clean deregistration: tell the
        # pool we are leaving so it drains our in-flight results instead
        # of burning a stall window on reinjection.  (SIGKILL still
        # exercises the crash path, deliberately.)
        def _leave(signum, frame):
            print("[worker] SIGTERM: leaving fleet cleanly", flush=True)
            server.request_leave()
        signal.signal(signal.SIGTERM, _leave)
    try:
        if args.join:
            server.join(args.join, retry_s=args.join_retry_s)
        else:
            server.serve_forever()
    except KeyboardInterrupt:
        print("[worker] interrupted; shutting down")
    return server


if __name__ == "__main__":
    main()
