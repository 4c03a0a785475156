"""Tuning-as-a-service: a long-lived multi-tenant tuner daemon.

One daemon owns one measurement substrate — either a remote worker
fleet (``--workers hostA:9123,hostB:9123``) or a local thread pool
measuring ``--objective module:factory()`` — and multiplexes any number
of concurrent tuning *jobs* over it:

    # the daemon (tuner host)
    PYTHONPATH=src python -m repro_torch.launch.service --serve \
        --state-dir artifacts/service --port 9200 \
        --workers hostA:9123,hostB:9123

    # submit a job from anywhere (thin client; stdlib only)
    with ServiceClient("tunerhost:9200") as client:
        job_id = client.submit(JobSpec(space=..., config=TunerConfig(
            algorithm="bo", budget=50).to_dict()))

    # watch / manage
    python -m repro_torch.launch.service --connect tunerhost:9200 --list
    python -m repro_torch.launch.service --connect tunerhost:9200 --status job-0001
    python -m repro_torch.launch.service --connect tunerhost:9200 --cancel job-0001

Clients speak protocol v2 of the length-prefixed-JSON protocol
(``repro_torch.tuning.protocol``): ``submit_job`` / ``job_status`` /
``list_jobs`` / ``cancel_job``.  Submissions are validated at the front
door — ``TunerConfig.from_dict`` and ``JobSpec.from_dict`` raise
``ValueError`` naming any unknown key, and the error text comes back in
the reply instead of a silently mis-configured job.

Fair-share scheduling
---------------------

Every job runs a real :class:`~repro_torch.core.Tuner` on its own thread, but
all jobs share ONE pool (the ``RemoteWorkerPool`` over the fleet, or
one thread pool locally): per-job executors are built around the shared
pool (``EvaluationExecutor(pool=...)``) so no job can monopolize the
slots.  A governor divides the slot total across runnable jobs —
``slots // n`` each, remainder rotated round-robin — by setting each
executor's ``slot_cap``; a tuner's completion-driven loop sizes its
in-flight window to ``executor.parallelism``, so the cap takes effect
at the next completion without revoking dispatched work.

Crash safety
------------

Every job checkpoints continuously under ``<state_dir>/jobs/<job_id>/``:
the tuner's history after *every* recorded evaluation (atomic
tmp+rename, via the standard ``checkpoint_path`` machinery) and the job
document (spec + state) through
:class:`~repro_torch.checkpoint.checkpointer.JsonCheckpointer` (sha256
integrity, keep-last-k).  A SIGKILL'd daemon restarted on the same
``--state-dir`` reloads every job, resumes the unfinished ones from
their checkpoints (``Tuner._resume`` replays the history into the
engine; the multi-fidelity loop replays rung state and budget spend),
and loses only measurements that were in flight at the kill — nothing
recorded is lost, nothing is double-recorded (the CI ``service-smoke``
job gates exactly this).

Devices
-------

The daemon never initialises CUDA.  Its jobs' BO surrogates run on the
CPU (the engines' default device), and over a worker fleet the
measurements run in the workers, each a process of its own that owns
its card.  The transfer corpus a fleet job records into carries the
workers' hardware fingerprint, taken from their registration, not this
host's.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import socket
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

from repro_torch.tuning import protocol as proto
from repro_torch.tuning.protocol import (JobSpec, PROTOCOL_V2, parse_address,
                                   recv_msg, send_msg)

TERMINAL_STATES = ("done", "failed", "cancelled")


class _Job:
    """One tuning job: spec + lifecycle + its Tuner (while running)."""

    __slots__ = ("job_id", "spec", "state", "error", "tuner", "thread",
                 "dir", "ckpt", "submitted_at", "finished_at")

    def __init__(self, job_id: str, spec: JobSpec, job_dir: pathlib.Path,
                 ckpt) -> None:
        self.job_id = job_id
        self.spec = spec
        self.state = "pending"  # pending -> running -> done|failed|cancelled
        self.error: Optional[str] = None
        self.tuner = None
        self.thread: Optional[threading.Thread] = None
        self.dir = job_dir
        self.ckpt = ckpt  # JsonCheckpointer over dir/snaps
        self.submitted_at = time.time()
        self.finished_at: Optional[float] = None

    def doc(self) -> dict:
        """The checkpointed job document (what a restart reloads)."""
        return {"job_id": self.job_id, "spec": self.spec.to_dict(),
                "state": self.state, "error": self.error,
                "submitted_at": self.submitted_at,
                "finished_at": self.finished_at}


class TuningService:
    """The daemon: accepts protocol-v2 clients, runs jobs over one pool.

    ``workers`` selects the remote fleet (jobs share one
    ``RemoteWorkerPool``; measurement objectives live on the workers);
    otherwise ``objective`` (an evaluator, callable, or
    ``module:factory()`` spec string) is measured locally on a shared
    ``parallelism``-wide thread pool.  Jobs may also carry their own
    ``objective`` spec (local mode only), resolved — and validated —
    at submission.
    """

    def __init__(self, state_dir, *, objective=None,
                 workers: Optional[List[str]] = None, parallelism: int = 4,
                 host: str = "127.0.0.1", port: int = 0,
                 eval_timeout: Optional[float] = None, verbose: bool = True,
                 rebalance_s: float = 0.5, corpus_path=None,
                 heartbeat_s: Optional[float] = None,
                 fleet_port: Optional[int] = 0,
                 fleet_homogeneity: str = "strict"):
        from repro_torch.checkpoint.checkpointer import JsonCheckpointer

        self._JsonCheckpointer = JsonCheckpointer
        self.state_dir = pathlib.Path(state_dir)
        self.jobs_dir = self.state_dir / "jobs"
        self.jobs_dir.mkdir(parents=True, exist_ok=True)
        # transfer-learning observation corpus: every job's completed
        # evaluations are recorded here, and later jobs on neighboring
        # workloads warm-start from it (default: <state_dir>/corpus.json)
        self.corpus_path = (pathlib.Path(corpus_path) if corpus_path
                            else self.state_dir / "corpus.json")
        self.verbose = verbose
        self.eval_timeout = eval_timeout
        self._lock = threading.RLock()
        self._jobs: Dict[str, _Job] = {}
        self._seq = 0
        self._rr = 0  # round-robin offset for the remainder slots
        self._stopping = threading.Event()
        self._objectives: Dict[str, object] = {}  # spec string -> evaluator

        # -- the one shared measurement substrate -----------------------------
        self.workers = list(workers) if workers else None
        if self.workers:
            from repro_torch.tuning.remote import FleetOptions, RemoteWorkerPool

            self._pool = RemoteWorkerPool(
                self.workers, eval_timeout=eval_timeout,
                fleet=FleetOptions(listen_port=fleet_port,
                                   homogeneity=fleet_homogeneity,
                                   heartbeat_s=heartbeat_s))
            self._backend = "remote"
            self._local_slots = None
        else:
            self._local_slots = max(1, int(parallelism))
            self._pool = ThreadPoolExecutor(max_workers=self._local_slots,
                                            thread_name_prefix="svc-measure")
            self._backend = "thread"
        self._default_objective = self._resolve(objective)
        if self._backend == "thread" and self._default_objective is None:
            # jobs may still carry their own objective specs; without any
            # objective at all the daemon can only reject submissions
            self._log("no --objective: local jobs must carry their own "
                      "objective spec")

        # -- client listener ---------------------------------------------------
        self._lsock = socket.create_server((host, int(port)))
        self.host, self.port = self._lsock.getsockname()[:2]
        self._threads: List[threading.Thread] = []

        # restart-recovery BEFORE accepting clients: a status probe that
        # races the rescan must not see an empty daemon
        self._recover()

        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="svc-accept")
        self._governor_thread = threading.Thread(
            target=self._governor_loop, args=(max(0.05, rebalance_s),),
            daemon=True, name="svc-governor")

    # -- lifecycle ------------------------------------------------------------
    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "TuningService":
        self._accept_thread.start()
        self._governor_thread.start()
        self._log(f"serving on {self.address} "
                  f"(backend={self._backend}, slots={self.total_slots()})")
        return self

    def serve_forever(self) -> None:
        self.start()
        try:
            while not self._stopping.wait(0.5):
                pass
        except KeyboardInterrupt:
            self._log("interrupted; shutting down")
        finally:
            self.stop()

    def stop(self) -> None:
        """Graceful shutdown: stop jobs at their next completion, close
        the listener, shut the shared pool down."""
        if self._stopping.is_set():
            return
        self._stopping.set()
        try:
            self._lsock.close()
        except OSError:
            pass
        with self._lock:
            running = [j for j in self._jobs.values() if j.tuner is not None]
        for j in running:
            j.tuner.request_stop()
        for j in running:
            if j.thread is not None:
                j.thread.join(timeout=10.0)
        self._pool.shutdown(wait=False, cancel_futures=True)

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(f"[service] {msg}", flush=True)

    # -- capacity / fair share -------------------------------------------------
    def total_slots(self) -> int:
        if self._backend == "remote":
            return max(1, self._pool.parallelism)
        return self._local_slots

    def _rebalance(self, rotate: bool = False) -> None:
        """Divide the slot total across runnable jobs: ``slots // n``
        each (min 1), remainder to the next ``slots % n`` jobs in
        round-robin order.  Applied via ``executor.slot_cap`` — the
        tuner loops shrink/grow their in-flight window at the next
        completion, so no dispatched measurement is ever revoked."""
        with self._lock:
            runnable = [j for j in self._jobs.values()
                        if j.state == "running" and j.tuner is not None]
            n = len(runnable)
            if n == 0:
                return
            runnable.sort(key=lambda j: j.job_id)
            total = self.total_slots()
            share, rem = divmod(total, n)
            if rotate:
                self._rr = (self._rr + 1) % n
            for i, job in enumerate(runnable):
                bonus = 1 if (i - self._rr) % n < rem else 0
                job.tuner.executor.slot_cap = max(1, share + bonus)

    def _governor_loop(self, interval: float) -> None:
        while not self._stopping.wait(interval):
            self._rebalance(rotate=True)

    # -- objective resolution --------------------------------------------------
    def _resolve(self, objective):
        """Evaluator | callable | ``module:factory()`` spec | None."""
        if objective is None or not isinstance(objective, str):
            return objective
        if objective not in self._objectives:
            from repro_torch.launch.worker import resolve_objective

            self._objectives[objective] = resolve_objective(objective)
        return self._objectives[objective]

    # -- job lifecycle ---------------------------------------------------------
    def submit(self, spec: JobSpec, job_id: Optional[str] = None) -> str:
        """Validate + persist + launch one job; returns its id.

        Raises ``ValueError`` (bad space/config/objective) so the
        protocol layer can return the precise reason."""
        from repro_torch.core import SearchSpace, TunerConfig

        SearchSpace.from_dicts(spec.space)  # validate, loudly
        TunerConfig.from_dict(spec.config)  # unknown keys raise here
        if spec.objective is not None:
            if self._backend == "remote":
                raise ValueError(
                    "per-job objectives are a local-measurement feature; "
                    "this daemon drives a remote fleet whose workers own "
                    "their objectives")
            try:
                self._resolve(spec.objective)
            except Exception as e:
                raise ValueError(
                    f"objective spec {spec.objective!r} failed to "
                    f"resolve: {e!r}") from None
        elif self._backend == "thread" and self._default_objective is None:
            raise ValueError(
                "this daemon has no --objective and measures locally; "
                "the job must carry an objective spec")
        with self._lock:
            if job_id is None:
                self._seq += 1
                while f"job-{self._seq:04d}" in self._jobs:
                    self._seq += 1
                job_id = f"job-{self._seq:04d}"
            elif job_id in self._jobs:
                raise ValueError(f"job id {job_id!r} already exists")
            job_dir = self.jobs_dir / job_id
            job = _Job(job_id, spec, job_dir,
                       self._JsonCheckpointer(job_dir / "snaps"))
            self._jobs[job_id] = job
        job.ckpt.save(job.doc())
        self._launch(job)
        return job_id

    def _launch(self, job: _Job) -> None:
        job.thread = threading.Thread(target=self._run_job, args=(job,),
                                      daemon=True, name=f"svc-{job.job_id}")
        job.thread.start()

    def _run_job(self, job: _Job) -> None:
        from repro_torch.core import SearchSpace, TransferConfig, Tuner, TunerConfig
        from repro_torch.tuning.executor import EvaluationExecutor

        try:
            space = SearchSpace.from_dicts(job.spec.space)
            cfg = TunerConfig.from_dict(job.spec.config)
            # the daemon owns placement: jobs always checkpoint into
            # their state dir (crash-resume), never spawn their own
            # fleets, and log through the service
            cfg.checkpoint_path = str(job.dir / "history.json")
            cfg.verbose = False
            cfg.executor.workers = None
            cfg.executor.backend = self._backend
            # every job records into (and may warm-start from) the
            # daemon's shared observation corpus, unless the submitter
            # pointed the job at a corpus of its own
            if self.corpus_path is not None and not cfg.transfer:
                cfg.transfer = TransferConfig(
                    corpus_path=str(self.corpus_path))
            if cfg.transfer and not cfg.transfer.job_id:
                cfg.transfer.job_id = job.job_id
            objective = (self._resolve(job.spec.objective)
                         or self._default_objective
                         or _remote_standin)
            timeout = (cfg.executor.eval_timeout
                       if cfg.executor.eval_timeout is not None
                       else self.eval_timeout)
            executor = EvaluationExecutor(
                objective, space, backend=self._backend, pool=self._pool,
                timeout=timeout, cache_path=cfg.executor.memo_cache_path,
                parallelism=self.total_slots(), corpus=self._fleet_corpus(cfg))
            tuner = Tuner(objective, space, cfg, executor=executor)
            resumed = len(tuner.history)
            with self._lock:
                job.tuner = tuner
                job.state = "running"
            job.ckpt.save(job.doc())
            self._rebalance()
            self._log(f"{job.job_id} running "
                      f"(algo={cfg.algorithm}, budget={cfg.budget}"
                      + (f", resumed {resumed} evals" if resumed else "")
                      + ")")
            tuner.run()
            with self._lock:
                if not tuner.stop_requested:
                    job.state = "done"
                elif self._stopping.is_set():
                    # daemon shutdown, not a user cancel: stay
                    # non-terminal so a restart resumes this job from
                    # its checkpoint
                    job.state = "running"
                else:
                    job.state = "cancelled"
                job.finished_at = (time.time()
                                   if job.state != "running" else None)
        except Exception as e:
            with self._lock:
                job.state = "failed"
                job.error = f"{e!r}"
                job.finished_at = time.time()
            self._log(f"{job.job_id} failed: {e!r}\n"
                      + traceback.format_exc())
        finally:
            with self._lock:
                tuner, job.tuner = job.tuner, None
            if tuner is not None:
                tuner.executor.cache.flush()
                corpus = getattr(tuner.executor, "corpus", None)
                if corpus is not None:
                    corpus.flush()
            job.ckpt.save(job.doc())
            self._rebalance()
            self._log(f"{job.job_id} -> {job.state} "
                      f"({self._n_evals(job)} evals recorded)")

    def _fleet_corpus(self, cfg):
        """A fleet job's transfer corpus, tagged with the hardware its
        measurements run on: the fingerprint the workers registered with
        (one partition under strict homogeneity).  None when measuring
        locally: the Tuner then builds the corpus with this host's."""
        if self._backend != "remote" or not cfg.transfer:
            return None
        from repro_torch.tuning.corpus import TuningCorpus
        from repro_torch.tuning.remote import UNKNOWN_FINGERPRINT, UNKNOWN_PARTITION

        reported = [w["fingerprint"] for w in self._pool.fleet_health()
                    if w["partition"] != UNKNOWN_PARTITION]
        return TuningCorpus(cfg.transfer.corpus_path, job_id=cfg.transfer.job_id,
                            hardware=reported[0] if reported else UNKNOWN_FINGERPRINT)

    def _n_evals(self, job: _Job) -> int:
        with self._lock:
            if job.tuner is not None:
                return len(job.tuner.history)
        hist = job.dir / "history.json"
        if hist.exists():
            try:
                return len(json.loads(hist.read_text()))
            except (OSError, ValueError):
                return 0
        return 0

    def cancel(self, job_id: str) -> bool:
        """Stop a job at its next completion; True if it was running."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                raise KeyError(job_id)
            if job.tuner is not None:
                job.tuner.request_stop()
                return True
            if job.state not in TERMINAL_STATES:
                job.state = "cancelled"
                job.finished_at = time.time()
                job.ckpt.save(job.doc())
            return False

    # -- restart recovery ------------------------------------------------------
    def _recover(self) -> None:
        """Reload every job document; relaunch the unfinished ones.

        A job killed mid-run resumes from its history checkpoint: the
        tuner replays recorded evaluations into the engine (and the
        multi-fidelity loop replays rung state + budget spend), so only
        measurements in flight at the crash are re-measured."""
        for job_dir in sorted(self.jobs_dir.iterdir()
                              if self.jobs_dir.exists() else []):
            if not job_dir.is_dir():
                continue
            ckpt = self._JsonCheckpointer(job_dir / "snaps")
            doc = ckpt.load()
            if doc is None:
                self._log(f"skipping {job_dir.name}: no readable snapshot")
                continue
            try:
                spec = JobSpec.from_dict(doc["spec"])
            except (KeyError, ValueError) as e:
                self._log(f"skipping {job_dir.name}: bad snapshot ({e!r})")
                continue
            job = _Job(doc.get("job_id", job_dir.name), spec, job_dir, ckpt)
            job.state = doc.get("state", "pending")
            job.error = doc.get("error")
            job.submitted_at = doc.get("submitted_at", job.submitted_at)
            job.finished_at = doc.get("finished_at")
            with self._lock:
                self._jobs[job.job_id] = job
                tail = job.job_id.rsplit("-", 1)[-1]
                if tail.isdigit():
                    self._seq = max(self._seq, int(tail))
            if job.state in TERMINAL_STATES:
                continue
            job.state = "pending"
            self._log(f"recovering {job.job_id} "
                      f"(checkpoint: {job_dir / 'history.json'})")
            self._launch(job)

    # -- status ----------------------------------------------------------------
    def fleet_health(self) -> dict:
        if self._backend == "remote":
            out = {"backend": "remote", "slots": self.total_slots(),
                   "workers": self._pool.fleet_health()}
            out.update(self._pool.fleet_stats())
            return out
        return {"backend": "thread", "slots": self.total_slots()}

    def job_status(self, job_id: str) -> dict:
        import math

        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                raise KeyError(job_id)
            tuner = job.tuner
            out = {"type": "status", "job_id": job.job_id,
                   "name": job.spec.name, "state": job.state,
                   "error": job.error, "submitted_at": job.submitted_at,
                   "finished_at": job.finished_at,
                   "fleet": self.fleet_health()}
        if tuner is not None:
            hist = tuner.history
            out["n_evals"] = len(hist)
            out["slot_cap"] = tuner.executor.slot_cap
            curve = hist.best_curve()
            out["best_curve"] = curve
            if curve and math.isfinite(curve[-1]):
                best = hist.best()
                out["best"] = {"value": best.value, "point": best.point}
            sched = tuner.rung_scheduler
            if sched is not None:
                # "rungs" predates the scheduler zoo: rung-shaped rows
                # for whichever ladder scheduler is driving (old clients
                # render them as before); the full picture — kind,
                # per-bracket tables, PBT population — rides "scheduler"
                stats = sched.stats()
                if all("rung" in row for row in stats):
                    out["rungs"] = stats
                out["scheduler"] = {"kind": getattr(sched, "kind", "asha"),
                                    "stats": stats,
                                    "snapshot": sched.snapshot()}
        else:
            hist = job.dir / "history.json"
            evals = []
            if hist.exists():
                try:
                    evals = json.loads(hist.read_text())
                except (OSError, ValueError):
                    evals = []
            out["n_evals"] = len(evals)
            curve, cur = [], -math.inf
            best = None
            for e in evals:
                v = e.get("value", -math.inf)
                if isinstance(v, (int, float)) and math.isfinite(v) \
                        and v > cur:
                    cur, best = v, e
                curve.append(cur)
            out["best_curve"] = curve
            if best is not None:
                out["best"] = {"value": best["value"], "point": best["point"]}
        return out

    def list_jobs(self) -> List[dict]:
        with self._lock:
            jobs = sorted(self._jobs.values(), key=lambda j: j.job_id)
            return [{"job_id": j.job_id, "name": j.spec.name,
                     "state": j.state, "n_evals": self._n_evals(j),
                     "error": j.error} for j in jobs]

    # -- protocol server -------------------------------------------------------
    def _accept_loop(self) -> None:
        self._lsock.settimeout(0.5)
        while not self._stopping.is_set():
            try:
                conn, _peer = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._client_session, args=(conn,),
                                 daemon=True, name="svc-client")
            t.start()
            self._threads.append(t)

    def _client_session(self, conn: socket.socket) -> None:
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn.settimeout(10.0)  # handshake; requests may then idle
            hello = recv_msg(conn)
            version = proto.negotiate(hello)
            if version is None or version < PROTOCOL_V2:
                send_msg(conn, {"type": "error",
                                "error": f"tuning service needs protocol "
                                         f">= {PROTOCOL_V2}, hello was "
                                         f"{hello!r}"})
                return
            send_msg(conn, {"type": "welcome", "protocol": version,
                            "service": "repro-tuning",
                            "slots": self.total_slots()})
            conn.settimeout(None)
            while True:
                msg = recv_msg(conn)
                reply = self._dispatch(msg)
                if reply is None:  # bye
                    return
                send_msg(conn, reply)
        except (ConnectionError, OSError, ValueError):
            pass  # client went away / spoke garbage: that session is over
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, msg: dict) -> Optional[dict]:
        kind = msg.get("type")
        try:
            if kind == "submit_job":
                spec = JobSpec.from_dict(msg.get("job") or {})
                job_id = self.submit(spec)
                return {"type": "job_accepted", "job_id": job_id}
            if kind == "job_status":
                return self.job_status(msg.get("job_id", ""))
            if kind == "list_jobs":
                return {"type": "jobs", "jobs": self.list_jobs()}
            if kind == "cancel_job":
                was_running = self.cancel(msg.get("job_id", ""))
                return {"type": "cancelled", "job_id": msg.get("job_id"),
                        "was_running": was_running}
            if kind == "bye":
                return None
            return {"type": "error", "error": f"unknown request {kind!r}"}
        except KeyError as e:
            return {"type": "error", "error": f"no such job: {e.args[0]!r}"}
        except ValueError as e:
            return {"type": "error", "error": str(e)}
        except Exception as e:  # never let one request kill the session
            return {"type": "error", "error": f"internal error: {e!r}"}


def _remote_standin(point):
    """Executor-side objective placeholder for remote-fleet daemons:
    measurements run on the workers, so this is only ever called if the
    executor's inline fallback paths fire — which the remote backend
    routes back to the fleet instead."""
    raise RuntimeError(
        "this daemon measures on its remote worker fleet; no local "
        "objective is available")


# ---------------------------------------------------------------------------
# thin client
# ---------------------------------------------------------------------------

class ServiceClient:
    """Blocking request/response client for the service protocol."""

    def __init__(self, address: str, connect_timeout: float = 10.0):
        host, port = parse_address(address)
        self.address = address
        self._sock = socket.create_connection((host, port),
                                              timeout=connect_timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        send_msg(self._sock, proto.hello())
        welcome = recv_msg(self._sock)
        if welcome.get("type") != "welcome":
            self._sock.close()
            raise ConnectionError(
                f"{address} is not a tuning service: {welcome!r}")
        self.protocol = welcome.get("protocol")
        self.slots = welcome.get("slots")
        self._sock.settimeout(None)
        self._lock = threading.Lock()

    def _rpc(self, msg: dict) -> dict:
        with self._lock:
            send_msg(self._sock, msg)
            reply = recv_msg(self._sock)
        if reply.get("type") == "error":
            raise RuntimeError(f"service error: {reply.get('error')}")
        return reply

    def submit(self, spec: JobSpec) -> str:
        return self._rpc({"type": "submit_job",
                          "job": spec.to_dict()})["job_id"]

    def status(self, job_id: str) -> dict:
        return self._rpc({"type": "job_status", "job_id": job_id})

    def list_jobs(self) -> List[dict]:
        return self._rpc({"type": "list_jobs"})["jobs"]

    def cancel(self, job_id: str) -> dict:
        return self._rpc({"type": "cancel_job", "job_id": job_id})

    def wait(self, job_id: str, timeout: Optional[float] = None,
             poll_s: float = 0.2, on_status=None) -> dict:
        """Poll until the job reaches a terminal state; returns the final
        status.  ``on_status`` (if given) sees every polled snapshot —
        the CLI progress reporter hook."""
        deadline = time.time() + timeout if timeout is not None else None
        while True:
            st = self.status(job_id)
            if on_status is not None:
                on_status(st)
            if st.get("state") in TERMINAL_STATES:
                return st
            if deadline is not None and time.time() >= deadline:
                raise TimeoutError(
                    f"job {job_id} still {st.get('state')!r} after "
                    f"{timeout}s")
            time.sleep(poll_s)

    def close(self) -> None:
        try:
            send_msg(self._sock, {"type": "bye"})
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "ServiceClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def print_status(st: dict) -> None:
    """Render one job_status reply for humans (the CLI reporter)."""
    best = st.get("best")
    curve = st.get("best_curve") or []
    line = (f"[{st['job_id']}] {st['state']:9s} evals={st.get('n_evals', 0)}"
            + (f" best={best['value']:.6g}" if best else " best=n/a"))
    if st.get("slot_cap") is not None:
        line += f" slots<={st['slot_cap']}"
    print(line)
    if curve:
        tail = ", ".join(f"{v:.4g}" for v in curve[-8:])
        print(f"    best-so-far: ...{tail}" if len(curve) > 8
              else f"    best-so-far: {tail}")
    sched = st.get("scheduler") or {}
    snap = sched.get("snapshot") or {}
    if sched.get("kind") == "hyperband" and snap.get("brackets"):
        for b in snap["brackets"]:
            print(f"    bracket {b['bracket']} "
                  f"(min_f={b['min_fidelity']}, spend={b['spend']:.4g}):")
            for row in b.get("rungs") or []:
                print(f"      rung {row['rung']} (f={row['fidelity']}): "
                      f"started={row['started']} "
                      f"completed={row['completed']} "
                      f"promoted={row['promoted']} "
                      f"preempted={row['preempted']}")
    elif sched.get("kind") == "pbt" and snap:
        row = (sched.get("stats") or [{}])[0]
        best = row.get("best")
        median = row.get("median")
        print(f"    population {len(snap.get('members') or [])}"
              f"/{snap.get('population')}: "
              + (f"best={best:.6g} " if best is not None else "best=n/a ")
              + (f"median={median:.6g} " if median is not None
                 else "median=n/a ")
              + f"steps={snap.get('steps')} forks={snap.get('forks')} "
                f"preempted={snap.get('preempted')}")
    else:
        for row in st.get("rungs") or []:
            print(f"    rung {row['rung']} (f={row['fidelity']}): "
                  f"started={row['started']} completed={row['completed']} "
                  f"promoted={row['promoted']} preempted={row['preempted']}")
    fleet = st.get("fleet") or {}
    if fleet.get("backend") == "remote":
        workers = fleet.get("workers", [])
        alive = sum(1 for w in workers if w.get("alive"))
        line = (f"    fleet: {alive}/{len(workers)} workers alive, "
                f"{fleet.get('slots')} slots")
        if fleet.get("join_address"):
            line += f", join={fleet['join_address']}"
        print(line)
        spec = fleet.get("speculating", 0)
        ages = [w.get("inflight_age_max") for w in workers
                if w.get("inflight_age_max") is not None]
        if spec or ages:
            line = f"    stragglers: speculating={spec}"
            if ages:
                line += f" inflight_age_max={max(ages):.1f}s"
            wins, losses = (fleet.get("speculation_wins", 0),
                            fleet.get("losers_discarded", 0))
            if wins or losses:
                line += f" (wins={wins} losers_discarded={losses})"
            print(line)
    if st.get("error"):
        print(f"    error: {st['error']}")


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Multi-tenant tuning service (daemon + management "
                    "client).  See repro_torch.tuning.protocol for the wire "
                    "format.")
    ap.add_argument("--serve", action="store_true",
                    help="run the daemon (otherwise: management client, "
                         "needs --connect)")
    ap.add_argument("--state-dir", default="artifacts/service",
                    help="daemon: where job checkpoints live; restarting "
                         "on the same dir resumes unfinished jobs")
    ap.add_argument("--host", default="0.0.0.0",
                    help="daemon: interface to listen on")
    ap.add_argument("--port", type=int, default=9200,
                    help="daemon: port (0 = ephemeral, printed)")
    ap.add_argument("--workers", default=None,
                    help="daemon: comma-separated host:port measurement "
                         "workers; jobs share this one fleet")
    ap.add_argument("--objective", default=None,
                    help="daemon (local measurement): module:attr objective "
                         "spec, () suffix calls a zero-arg factory")
    ap.add_argument("--parallelism", type=int, default=4,
                    help="daemon (local measurement): shared thread-pool "
                         "width")
    ap.add_argument("--eval-timeout", type=float, default=None,
                    help="daemon: default seconds per measurement")
    ap.add_argument("--heartbeat-s", type=float, default=None,
                    help="daemon (remote fleet): fallback heartbeat "
                         "interval; each worker's stall window is 3 missed "
                         "beats of its own registered value")
    ap.add_argument("--fleet-port", type=int, default=0,
                    help="daemon (remote fleet): join socket kept open for "
                         "the daemon's lifetime so workers can register "
                         "mid-run (0 = ephemeral, printed in --status)")
    ap.add_argument("--fleet-homogeneity", default="strict",
                    choices=["strict", "normalize"],
                    help="daemon (remote fleet): refuse mixed hardware "
                         "fingerprints (strict, default) or admit and "
                         "cost-calibrate them (normalize)")
    ap.add_argument("--corpus", default=None,
                    help="daemon: transfer-learning observation corpus "
                         "shared by all jobs (default: "
                         "<state-dir>/corpus.json); jobs record every "
                         "completed evaluation here and warm-start from "
                         "neighboring workloads")
    ap.add_argument("--quiet", action="store_true",
                    help="daemon: suppress progress logging")
    ap.add_argument("--connect", default=None,
                    help="client: service host:port")
    ap.add_argument("--list", action="store_true",
                    help="client: list jobs")
    ap.add_argument("--status", default=None, metavar="JOB_ID",
                    help="client: show one job's progress")
    ap.add_argument("--watch", action="store_true",
                    help="client (with --status): poll until terminal")
    ap.add_argument("--cancel", default=None, metavar="JOB_ID",
                    help="client: cancel a job")
    args = ap.parse_args(argv)

    if args.serve:
        workers = ([w.strip() for w in args.workers.split(",") if w.strip()]
                   if args.workers else None)
        service = TuningService(
            args.state_dir, objective=args.objective, workers=workers,
            parallelism=args.parallelism, host=args.host, port=args.port,
            eval_timeout=args.eval_timeout, verbose=not args.quiet,
            corpus_path=args.corpus, heartbeat_s=args.heartbeat_s,
            fleet_port=args.fleet_port,
            fleet_homogeneity=args.fleet_homogeneity)
        service.serve_forever()
        return service

    if not args.connect:
        ap.error("either --serve (daemon) or --connect host:port (client)")
    with ServiceClient(args.connect) as client:
        if args.list or not (args.status or args.cancel):
            rows = client.list_jobs()
            if not rows:
                print("no jobs")
            for r in rows:
                line = (f"{r['job_id']}  {r['state']:9s} "
                        f"evals={r['n_evals']}")
                if r.get("name"):
                    line += f"  ({r['name']})"
                if r.get("error"):
                    line += f"  error: {r['error']}"
                print(line)
        if args.status:
            if args.watch:
                client.wait(args.status, on_status=print_status, poll_s=1.0)
            else:
                print_status(client.status(args.status))
        if args.cancel:
            reply = client.cancel(args.cancel)
            print(f"{args.cancel}: cancel "
                  f"{'delivered' if reply.get('was_running') else 'noted'}")
    return None


if __name__ == "__main__":
    main()
