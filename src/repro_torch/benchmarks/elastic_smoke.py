"""Elastic-fleet smoke: the gate of the elastic worker fleet.

Spins up real ``launch/worker.py`` subprocesses against an in-process
``RemoteWorkerPool`` (the tuner side) and gates the elastic contract:

* **join** — a worker joining mid-run (``--join`` against the pool's
  always-open join socket) raises measured throughput: the same batch
  finishes in <= ``JOIN_SPEEDUP`` x the static-fleet wall clock;
* **speculation** — with one artificially-slowed worker in the fleet,
  speculative straggler re-execution finishes the batch in <=
  ``SPEC_SPEEDUP`` x the wall clock of the same fleet with speculation
  off;
* **exactly-once** — SIGKILLing the straggler host while its task has
  a live speculative duplicate loses 0 results and double-records 0;
* **strict homogeneity** — a fleet never mixes two distinct hardware
  fingerprints: a statically mis-assembled fleet fails construction and
  a mismatched joiner is turned away while the run continues.

Workers serve ``make_smoke_objective()`` from this module: value is a
deterministic function of the point, measurement time is
``BASE_SLEEP_S`` scaled by the ``ELASTIC_SMOKE_SLOWDOWN`` environment
variable (how the slow host is made slow), and the declared
``cost_seconds`` is hardware-independent so recorded traces stay
byte-comparable across fleets.

Usage (a CI job runs exactly this):

    PYTHONPATH=src python -m repro_torch.benchmarks.elastic_smoke --check \
        --out BENCH_elastic.json
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time

BASE_SLEEP_S = 0.1
JOIN_BATCH = 20
JOIN_SPEEDUP = 0.85   # elastic wall / static wall must be <= this
SPEC_BATCH = 8
SPEC_SLOWDOWN = 25.0  # the slow host: 0.1s evals take 2.5s
SPEC_SPEEDUP = 0.6    # speculation-on wall / off wall must be <= this


def make_smoke_objective():
    """Deterministic objective whose measurement speed is per-*host*
    (``ELASTIC_SMOKE_SLOWDOWN`` env), not per-point — exactly the
    straggling-hardware shape speculation exists for."""
    slowdown = float(os.environ.get("ELASTIC_SMOKE_SLOWDOWN", "1.0"))

    def objective(p, fidelity=None):
        time.sleep(BASE_SLEEP_S * slowdown)
        return float(p["a"] * 10 + p["b"]), {"cost_seconds": BASE_SLEEP_S}

    objective.returns_meta = True  # the (value, meta) contract, declared
    return objective


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(root: pathlib.Path, slowdown: float = 1.0) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root / "src")]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env["ELASTIC_SMOKE_SLOWDOWN"] = str(slowdown)
    return env


def spawn_worker(root: pathlib.Path, *, port=None, join=None, slots=1,
                 slowdown=1.0, tag=None) -> subprocess.Popen:
    cmd = [sys.executable, "-m", "repro_torch.launch.worker",
           "--host", "127.0.0.1", "--slots", str(slots),
           "--heartbeat-s", "0.2", "--objective",
           "repro_torch.benchmarks.elastic_smoke:make_smoke_objective()"]
    if port is not None:
        cmd += ["--port", str(port)]
    if join is not None:
        cmd += ["--join", join, "--join-retry-s", "0.2"]
    if tag is not None:
        cmd += ["--fingerprint-tag", tag]
    return subprocess.Popen(cmd, env=_env(root, slowdown), cwd=str(root),
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)


def wait_port(port: int, timeout_s: float = 20.0, proc=None) -> None:
    """Block until something listens on ``port``; with ``proc`` (the
    worker's ``Popen``), fail at once if that process has exited."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(f"worker for port {port} exited with code "
                               f"{proc.returncode} before it listened")
        try:
            socket.create_connection(("127.0.0.1", port), timeout=0.2).close()
            return
        except OSError:
            time.sleep(0.05)
    raise TimeoutError(f"worker on port {port} never came up")


def reap(*procs) -> None:
    for p in procs:
        if p is not None and p.poll() is None:
            p.terminate()
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()


def drive_batch(pool, n: int) -> float:
    """Submit n points, wait for every future; returns the wall clock."""
    t0 = time.perf_counter()
    futures = [pool.submit(None, None, {"a": i % 10, "b": i % 5})
               for i in range(n)]
    for i, f in enumerate(futures):
        value, _seconds, _meta = f.result(timeout=120)
        assert value == float((i % 10) * 10 + i % 5)
    return time.perf_counter() - t0


def local_join(pool) -> str:
    port = pool.join_address.rsplit(":", 1)[1]
    return f"127.0.0.1:{port}"


# ---------------------------------------------------------------------------
# gate (a): mid-run join raises throughput
# ---------------------------------------------------------------------------

def bench_join(root, emit) -> dict:
    from repro_torch.tuning.remote import FleetOptions, RemoteWorkerPool

    fleet = FleetOptions(speculation=False)
    p1 = free_port()
    w1 = spawn_worker(root, port=p1)
    joiner = None
    try:
        wait_port(p1)
        # static: the startup fleet runs the whole batch
        pool = RemoteWorkerPool([f"127.0.0.1:{p1}"], fleet=fleet)
        static_wall = drive_batch(pool, JOIN_BATCH)
        pool.shutdown()
        # elastic: same batch, but a second daemon dials the join socket
        # mid-run and the pool puts its slots to work immediately
        pool = RemoteWorkerPool([f"127.0.0.1:{p1}"], fleet=fleet)
        joiner = spawn_worker(root, join=local_join(pool))
        elastic_wall = drive_batch(pool, JOIN_BATCH)
        joined = pool.parallelism  # capacity after the join
        pool.shutdown()
    finally:
        reap(w1, joiner)
    ratio = elastic_wall / static_wall
    emit(f"[elastic-smoke] join: static {static_wall:.2f}s vs elastic "
         f"{elastic_wall:.2f}s (ratio {ratio:.2f}, fleet grew to "
         f"{joined} slots)")
    return {"static_wall_s": round(static_wall, 3),
            "elastic_wall_s": round(elastic_wall, 3),
            "ratio": round(ratio, 3), "slots_after_join": joined,
            "ok": ratio <= JOIN_SPEEDUP and joined >= 2}


# ---------------------------------------------------------------------------
# gates (b) + (c): speculation wall clock and exactly-once under SIGKILL
# ---------------------------------------------------------------------------

def _spec_fleet(root):
    """One healthy 2-slot worker + one SPEC_SLOWDOWN-slowed worker."""
    p_slow, p_fast = free_port(), free_port()
    w_slow = spawn_worker(root, port=p_slow, slowdown=SPEC_SLOWDOWN)
    w_fast = spawn_worker(root, port=p_fast, slots=2)
    wait_port(p_slow)
    wait_port(p_fast)
    return w_slow, w_fast, [f"127.0.0.1:{p_slow}", f"127.0.0.1:{p_fast}"]


def bench_speculation(root, emit) -> dict:
    from repro_torch.tuning.remote import FleetOptions, RemoteWorkerPool

    walls = {}
    for spec in (False, True):
        w_slow, w_fast, addrs = _spec_fleet(root)
        try:
            pool = RemoteWorkerPool(addrs, fleet=FleetOptions(
                speculation=spec, speculation_factor=2.0,
                min_observations=3))
            walls[spec] = drive_batch(pool, SPEC_BATCH)
            speculations = pool.speculations
            pool.shutdown()
        finally:
            reap(w_slow, w_fast)
    ratio = walls[True] / walls[False]
    emit(f"[elastic-smoke] speculation: off {walls[False]:.2f}s vs on "
         f"{walls[True]:.2f}s (ratio {ratio:.2f}, "
         f"{speculations} duplicates)")
    return {"off_wall_s": round(walls[False], 3),
            "on_wall_s": round(walls[True], 3),
            "ratio": round(ratio, 3), "speculations": speculations,
            "ok": ratio <= SPEC_SPEEDUP and speculations >= 1}


def bench_sigkill_exactly_once(root, emit) -> dict:
    from repro_torch.tuning.remote import FleetOptions, RemoteWorkerPool

    w_slow, w_fast, addrs = _spec_fleet(root)
    try:
        pool = RemoteWorkerPool(addrs, fleet=FleetOptions(
            speculation=True, speculation_factor=2.0, min_observations=3))
        points = [{"a": i % 10, "b": i % 5} for i in range(SPEC_BATCH)]
        futures = [pool.submit(None, None, dict(p)) for p in points]
        # wait for a live duplicate, then SIGKILL the straggler host
        # while both copies are in flight
        deadline = time.time() + 60
        while pool.speculations < 1 and time.time() < deadline:
            time.sleep(0.02)
        assert pool.speculations >= 1, "speculation never triggered"
        w_slow.send_signal(signal.SIGKILL)
        w_slow.wait(timeout=10)
        results, lost = [], 0
        for f in futures:
            try:
                results.append(f.result(timeout=120))
            except Exception:  # a stranded future == a lost result
                lost += 1
                results.append(None)
        values_ok = all(
            r is not None and r[0] == float(p["a"] * 10 + p["b"])
            for r, p in zip(results, points))
        # one resolution per submission, none lost, none doubled: the
        # futures ARE the recording path (memo/corpus hang off them)
        stats = pool.fleet_stats()
        pool.shutdown()
    finally:
        reap(w_slow, w_fast)
    emit(f"[elastic-smoke] sigkill: {len(results)}/{SPEC_BATCH} results "
         f"after killing the straggler host "
         f"(speculations={stats['speculations']})")
    return {"results": len(results), "expected": SPEC_BATCH,
            "lost": lost, "values_ok": values_ok,
            "speculations": stats["speculations"],
            "ok": lost == 0 and values_ok and len(results) == SPEC_BATCH}


# ---------------------------------------------------------------------------
# gate (d): strict homogeneity never mixes fingerprints
# ---------------------------------------------------------------------------

def bench_strict_homogeneity(root, emit) -> dict:
    from repro_torch.tuning.remote import FleetOptions, RemoteWorkerPool

    p1, p2 = free_port(), free_port()
    w1 = spawn_worker(root, port=p1, tag="partition-A")
    w2 = spawn_worker(root, port=p2, tag="partition-B")
    joiner = None
    try:
        wait_port(p1)
        wait_port(p2)
        static_refused = False
        try:
            RemoteWorkerPool([f"127.0.0.1:{p1}", f"127.0.0.1:{p2}"])
        except ConnectionError:
            static_refused = True  # mis-assembled fleet fails construction
        pool = RemoteWorkerPool([f"127.0.0.1:{p1}"])
        joiner = spawn_worker(root, join=local_join(pool),
                              tag="partition-B")
        deadline = time.time() + 30
        while pool.rejected_joins < 1 and time.time() < deadline:
            time.sleep(0.05)
        join_rejected = pool.rejected_joins >= 1
        survived = pool.parallelism == 1  # the pinned run goes on
        pool.shutdown()
    finally:
        reap(w1, w2, joiner)
    emit(f"[elastic-smoke] strict: static mix refused={static_refused}, "
         f"mismatched join rejected={join_rejected}")
    return {"static_refused": static_refused,
            "join_rejected": join_rejected, "run_survived": survived,
            "ok": static_refused and join_rejected and survived}


def run_smoke(emit=print) -> dict:
    root = pathlib.Path(__file__).resolve().parents[3]
    t0 = time.perf_counter()
    join = bench_join(root, emit)
    spec = bench_speculation(root, emit)
    sigkill = bench_sigkill_exactly_once(root, emit)
    strict = bench_strict_homogeneity(root, emit)
    gates = {
        "join_raises_throughput": join["ok"],
        "speculation_cuts_wall_clock": spec["ok"],
        "sigkill_loses_nothing": sigkill["ok"],
        "strict_never_mixes": strict["ok"],
    }
    return {"bench": "elastic_smoke",
            "base_sleep_s": BASE_SLEEP_S,
            "join_speedup_gate": JOIN_SPEEDUP,
            "spec_speedup_gate": SPEC_SPEEDUP,
            "wall_s": round(time.perf_counter() - t0, 3),
            "join": join, "speculation": spec, "sigkill": sigkill,
            "strict": strict, "gates": gates, "ok": all(gates.values())}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="write the JSON artifact here")
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero if any gate fails")
    args = ap.parse_args(argv)

    result = run_smoke()
    print(json.dumps(result, indent=2))
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(result, indent=2))
        print(f"[elastic-smoke] wrote {args.out}")
    if args.check and not result["ok"]:
        failed = [g for g, ok in result["gates"].items() if not ok]
        print(f"[elastic-smoke] FAILED gates: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
