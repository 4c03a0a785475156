"""Tuning-service crash-recovery smoke.

Spins up the real processes — one ``launch/service.py --serve`` daemon
driving two ``launch/worker.py`` measurement daemons over localhost
TCP — submits two concurrent jobs through the protocol-v2 client,
SIGKILLs the daemon mid-run, restarts it on the same state dir, and
gates the service's crash contract:

* **0 lost completed results** — every evaluation in a job's history
  the instant before the kill is still there, in order, at the end;
* **0 double-recorded results** — no point appears twice in a finished
  job's history (``History.save`` persists completed evals atomically,
  so a SIGKILL can lose at most in-flight work, never duplicate it);
* **both jobs finish** — the restarted daemon recovers every
  non-terminal job document and resumes it from its checkpoint to the
  full budget;
* the resumed runs *made progress before the kill* (the kill happened
  mid-run, not before or after — otherwise the gate proves nothing).

Usage:

    PYTHONPATH=src python -m repro_torch.benchmarks.service_smoke --check \
        --out artifacts/service_smoke.json
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
import tempfile
import time

BUDGET = 14  # per job; 2 jobs x 14 evals over a 4-slot fleet
N_JOBS = 2
MIN_EVALS_BEFORE_KILL = 3  # per job: the kill must land mid-run


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(root: pathlib.Path) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root / "src"), str(root)]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


def spawn_worker(root: pathlib.Path, port: int) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.worker",
         "--host", "127.0.0.1", "--port", str(port),
         "--slots", "2", "--heartbeat", "0.5", "--objective",
         "repro_torch.benchmarks.perf_iterations:make_remote_bench_objective()"],
        env=_env(root), cwd=str(root),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def spawn_daemon(root: pathlib.Path, state_dir: str, port: int,
                 worker_ports: list) -> subprocess.Popen:
    fleet = ",".join(f"127.0.0.1:{p}" for p in worker_ports)
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.service", "--serve",
         "--state-dir", state_dir, "--host", "127.0.0.1",
         "--port", str(port), "--workers", fleet],
        env=_env(root), cwd=str(root),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def connect_client(address: str, timeout_s: float = 20.0):
    from repro_torch.launch.service import ServiceClient

    deadline = time.time() + timeout_s
    while True:
        try:
            return ServiceClient(address)
        except (ConnectionError, OSError):
            if time.time() >= deadline:
                raise
            time.sleep(0.1)


def read_history(state_dir: pathlib.Path, job_id: str) -> list:
    path = state_dir / "jobs" / job_id / "history.json"
    if not path.exists():
        return []
    try:
        return json.loads(path.read_text())
    except ValueError:
        return []  # mid-replace torn read; treated as empty for polling


def run_smoke(emit=print) -> dict:
    from repro_torch.tuning.protocol import JobSpec

    root = pathlib.Path(__file__).resolve().parents[3]
    space = [{"type": "int", "name": "inter_op", "min": 1, "max": 16},
             {"type": "int", "name": "intra_op", "min": 0, "max": 60,
              "step": 5},
             {"type": "cat", "name": "build", "choices": [1, 2, 3]}]
    # exhaustive: deterministic, dedup-on-resume, so "no duplicates"
    # is exact — random engines legitimately re-record memoized repeats
    config = {"algorithm": "exhaustive", "budget": BUDGET, "verbose": False}

    worker_ports = [free_port(), free_port()]
    daemon_port = free_port()
    workers = [spawn_worker(root, p) for p in worker_ports]
    daemon = None
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as d:
            state = pathlib.Path(d) / "state"
            daemon = spawn_daemon(root, str(state), daemon_port,
                                  worker_ports)
            address = f"127.0.0.1:{daemon_port}"
            with connect_client(address) as client:
                job_ids = [
                    client.submit(JobSpec(space=space, config=config,
                                          name=f"smoke-{i}"))
                    for i in range(N_JOBS)]
                emit(f"[service-smoke] submitted {job_ids} "
                     f"(budget {BUDGET} each)")
                # let both jobs make real progress, then kill mid-run
                deadline = time.time() + 60
                while time.time() < deadline:
                    done = min(len(read_history(state, j))
                               for j in job_ids)
                    if done >= MIN_EVALS_BEFORE_KILL:
                        break
                    time.sleep(0.05)

            daemon.send_signal(signal.SIGKILL)
            daemon.wait(timeout=10)
            before = {j: read_history(state, j) for j in job_ids}
            kill_evals = {j: len(h) for j, h in before.items()}
            emit(f"[service-smoke] SIGKILL'd daemon at {kill_evals} evals")

            # restart on the same state dir: recovery must resume both
            daemon = spawn_daemon(root, str(state), daemon_port,
                                  worker_ports)
            with connect_client(address) as client:
                finals = {j: client.wait(j, timeout=120) for j in job_ids}

            after = {j: read_history(state, j) for j in job_ids}
            wall_s = time.perf_counter() - t0

            per_job = []
            for j in job_ids:
                keys = [tuple(sorted(e["point"].items())) for e in after[j]]
                per_job.append({
                    "job_id": j,
                    "state": finals[j]["state"],
                    "evals_at_kill": kill_evals[j],
                    "evals_final": len(after[j]),
                    "lost_completed": sum(
                        1 for i, e in enumerate(before[j])
                        if i >= len(after[j]) or after[j][i] != e),
                    "double_recorded": len(keys) - len(set(keys)),
                    "best": finals[j].get("best", {}).get("value"),
                })

            gates = {
                "both_jobs_done": all(r["state"] == "done"
                                      for r in per_job),
                "full_budget": all(r["evals_final"] == BUDGET
                                   for r in per_job),
                "zero_lost_completed": all(r["lost_completed"] == 0
                                           for r in per_job),
                "zero_double_recorded": all(r["double_recorded"] == 0
                                            for r in per_job),
                "kill_was_mid_run": all(
                    0 < r["evals_at_kill"] < BUDGET for r in per_job),
            }
            return {"bench": "service_smoke", "budget": BUDGET,
                    "n_jobs": N_JOBS, "wall_s": round(wall_s, 3),
                    "jobs": per_job, "gates": gates,
                    "ok": all(gates.values())}
    finally:
        for proc in [daemon] + workers:
            if proc is not None and proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    proc.kill()


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
        print(f"[service-smoke] wrote {args.out}")
    if args.check and not result["ok"]:
        failed = [g for g, ok in result["gates"].items() if not ok]
        print(f"[service-smoke] FAILED gates: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
