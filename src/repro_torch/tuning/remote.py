"""Remote measurement workers: the RPC executor backend.

The tuning loop's dominant cost is the measurement itself, so the last
scale-out move is farming measurements to a fleet of remote hosts while
one tuner keeps the engine, the history, and the memo cache.  This
module is the tuner side of that split: :class:`RemoteWorkerPool`
connects to ``launch/worker.py`` daemons and exposes the same
``Future``-based surface the thread/process pools do, so the whole
executor contract — ``submit`` / ``next_completed`` / ``preempt``,
fidelity/rung tagging, per-evaluation deadlines, exactly-once recording
— works over the wire unchanged.

Wire protocol
-------------

Framing and version negotiation live in ``repro_torch.tuning.protocol``
(length-prefixed JSON; the hello advertises ``max_protocol`` so v2
tuners and v1 workers interoperate — see that module's docstring).
This module re-exports ``send_msg``/``recv_msg``/``parse_address`` for
compatibility with existing imports.

For the *initial* fleet the tuner is the TCP *client*; each worker
daemon is a *server* (the driver is handed ``host:port`` addresses, so
workers sit behind plain listening sockets — no rendezvous service
needed).  The fleet is also **elastic**: the pool keeps its own listen
socket open for the whole run (``join_address``), and a worker started
later can dial *in* (``launch/worker.py --join host:port``) and
register mid-run — the hello/register handshake and everything after it
are identical in both directions, only who dials differs.  A worker can
also deregister cleanly (``{"type": "leaving"}``): the pool stops
dispatching to it, lets its in-flight measurements finish, then ends
the session — no work is lost and nothing is re-measured.  Per
connection:

* handshake — tuner sends ``{"type": "hello", "protocol": 1,
  "max_protocol": 2}``; the worker **registers** with ``{"type":
  "register", "protocol": v, "slots": n, "heartbeat_s": h, "pid": ...,
  "host": ...}`` where ``v`` is the negotiated version.  At v2 the
  register also ships ``"fingerprint"``, the worker host's
  ``tundb.hardware_fingerprint()`` (v1 workers get a synthetic
  ``unknown`` fingerprint pool-side) — see *hardware-aware scheduling*
  below.  ``slots`` is how many concurrent measurements the worker
  runs; the pool's ``parallelism`` is the fleet-wide sum.  A worker
  whose objective failed to build at startup registers with ``"error":
  "<traceback summary>"`` and zero slots — the pool raises
  ``ConnectionError`` naming the import error instead of silently
  running a broken fleet.
* tasks — tuner sends ``{"type": "task", "id": i, "point": {...},
  "fidelity": f | null, "timeout": t | null}``; the worker *pulls* it
  into its measurement thread pool, runs ``run_objective`` (the exact
  function the local backends run — failures come back as ``-inf`` with
  ``meta["error"]``, never as protocol errors), and streams back
  ``{"type": "result", "id": i, "value": v, "seconds": s,
  "meta": {...}}`` in completion order.
* heartbeats — the worker sends ``{"type": "heartbeat"}`` every
  ``heartbeat_s`` seconds.  The pool declares a worker dead when its
  socket drops *or* no traffic arrives for ``3 * heartbeat_s``, so a
  hung host is caught, not just a closed one.
* ``{"type": "bye"}`` ends the session (either direction).

Failure semantics
-----------------

* **worker death / disconnect** — every task in flight on that worker
  is *reinjected* at the front of the dispatch queue and re-measured by
  a surviving worker.  A disconnect is a property of the fleet, not of
  the configuration: nothing is recorded as a failed config, and
  exactly-once recording holds because a task's ``Future`` resolves at
  most once (a result that raced the disconnect wins; the reinjected
  copy is dropped when its future is already done).  Only when the
  *whole* fleet is gone do outstanding futures fail with
  ``ConnectionError`` — the run cannot proceed and says so loudly.
* **per-eval timeouts** hold across the wire exactly as for the local
  pools: the executor stamps each pending with ``now + timeout`` at
  dispatch and resolves it to ``-inf``/``meta={"timeout": True}`` when
  the deadline passes (the remote measurement is abandoned, its late
  result discarded).  The timeout also rides the task message so a
  harness that *can* stop early may.
* **preemption** — ``future.cancel()`` works natively: a task still in
  the pool's dispatch queue has a PENDING future and cancels cleanly
  (never sent, nothing measured); once dispatched to a worker the
  future is RUNNING, cancel returns False, and the measurement runs to
  completion and is recorded — the same let-it-finish semantics as a
  started pool task.

Speculative straggler re-execution
----------------------------------

A rung's wall clock is its *slowest* measurement, so one slow host
stretches every tail.  The pool tracks observed completion times per
rung (``CompletionStats`` p50/p95 streaming quantiles from
``tuning/fidelity``); when a dispatched task's age exceeds
``speculation_factor * p95`` at its fidelity (after
``min_observations`` completions) and a slot is free with nothing
queued, the monitor dispatches a **duplicate to a different worker**.
First result wins — recorded exactly once under the same at-most-once
future resolution every other path uses; the loser keeps running
remotely (let-it-finish) and its late result is discarded without ever
touching the memo cache or the transfer corpus.  Speculation only
exists in this backend: local backends have no duplicate path at all,
so non-remote runs stay byte-identical.

Hardware-aware scheduling
-------------------------

Measurements taken on different hardware are not comparable, and a
mid-run join makes silent mixing easy.  The pool partitions workers by
register-time fingerprint and, under the default ``strict``
homogeneity, pins the run to the first partition: a static fleet mixing
two fingerprints refuses to construct, and a mismatched joiner is
turned away (counted in ``rejected_joins``).  Under ``normalize`` the
fleet may mix: ``cost_seconds`` from a non-reference partition is
rescaled by a per-partition calibration ratio learned from duplicate
(speculative) completions of the *same task* on both partitions —
``meta["cost_calibration"]`` records the applied factor.  Objective
*values* are never rescaled; only the cost model sees the correction.

Cache topology: workers never touch the memo cache.  Results flow back
to the tuner process, which writes them into the shared
``MemoCache``/``CacheStore`` exactly as for local measurements — so
remote and local measurements share one memo and workers need **no
shared filesystem** (the store requirement moved to the tuner host).
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import platform
import socket
import sys
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.tuning import protocol as _proto
from repro_torch.tuning.fidelity import CompletionStats
from repro_torch.tuning.protocol import (  # noqa: F401  (re-exported for compat)
    DEFAULT_HEARTBEAT_S, MAX_FRAME_BYTES, PROTOCOL_V1, PROTOCOL_V2,
    SUPPORTED_PROTOCOLS, parse_address, recv_msg, send_msg,
)

#: historical alias — the version-1 wire format this module debuted with.
PROTOCOL_VERSION = PROTOCOL_V1

#: what the pool assumes about a worker that registered without a
#: fingerprint (protocol v1, or a pre-elastic daemon): all such workers
#: share one "unknown" partition, so a pure-v1 fleet behaves exactly as
#: it always did under strict homogeneity.
UNKNOWN_FINGERPRINT: Dict[str, object] = {"unknown": True}


def fingerprint_id(fp: Optional[Dict]) -> str:
    """Stable short identity of a hardware fingerprint dict.

    Canonical-JSON hashed: two hosts fingerprint into the same partition
    iff every field matches (that is the point — "close enough" hardware
    is exactly the silent-mixing hole this closes)."""
    if not fp:
        fp = UNKNOWN_FINGERPRINT
    blob = json.dumps(fp, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode("utf-8")).hexdigest()[:12]


#: partition of the workers that reported no fingerprint.  Membership
#: here never pins — or conflicts with — a fleet's hardware partition:
#: "did not report" is not evidence of *different* hardware, and strict
#: mode must keep admitting v1 / pre-elastic daemons.
UNKNOWN_PARTITION = fingerprint_id(UNKNOWN_FINGERPRINT)


def _worker_fingerprint() -> Dict[str, object]:
    """This host's measurement fingerprint for the register handshake.

    ``tundb.hardware_fingerprint()`` when the accelerator stack is
    *already loaded* (its devices are then what this host measures on);
    otherwise a host-level fallback.  The gate on ``sys.modules`` is
    deliberate: worker daemons have been framework-free since the remote
    backend landed, and saying who they are must not cost them a
    multi-second accelerator import at startup."""
    if "torch" in sys.modules:
        try:
            from repro_torch.tuning.tundb import hardware_fingerprint
            return hardware_fingerprint()
        except Exception:
            pass
    return {"backend": "none",
            "device_kind": platform.processor() or "unknown",
            "device_count": 0,
            "machine": platform.machine(),
            "cpu_count": os.cpu_count() or 1}


@dataclass
class FleetOptions:
    """Elastic-fleet knobs for :class:`RemoteWorkerPool`.

    ``listen_port``       pool-side join socket: 0 = ephemeral (default —
                          the socket is open for the whole run, that is
                          what makes the fleet elastic), ``None`` =
                          don't listen (fixed fleet)
    ``listen_host``       interface the join socket binds
    ``speculation``       duplicate suspected stragglers (default on;
                          only the remote backend has this path at all)
    ``speculation_factor``a dispatched task older than ``factor * p95``
                          of its rung's completion times is a straggler
    ``min_observations``  completions at a fidelity before its p95 is
                          trusted (no speculation before that)
    ``homogeneity``       ``"strict"`` (default): one hardware partition
                          per run, mismatched workers refused;
                          ``"normalize"``: mixed partitions allowed,
                          cross-partition cost_seconds rescaled by the
                          learned calibration ratio
    ``heartbeat_s``       fallback heartbeat interval assumed for a
                          worker whose register did not declare one (the
                          stall window is ``3 *`` the per-worker value)
    """

    listen_port: Optional[int] = 0
    listen_host: str = "0.0.0.0"
    speculation: bool = True
    speculation_factor: float = 4.0
    min_observations: int = 4
    homogeneity: str = "strict"
    heartbeat_s: Optional[float] = None

    def __post_init__(self):
        if self.homogeneity not in ("strict", "normalize"):
            raise ValueError(
                f"fleet homogeneity must be 'strict' or 'normalize' "
                f"(got {self.homogeneity!r})")
        if self.speculation_factor <= 1.0:
            raise ValueError(
                f"speculation_factor must exceed 1 "
                f"(got {self.speculation_factor})")


class _FleetCalibration:
    """Per-partition cost calibration learned from duplicate completions.

    When a speculated task completes on two partitions, the pair of raw
    ``seconds`` is one observation of their relative speed.  The factor
    for partition P converts P-measured seconds into reference-partition
    seconds: ``cost_ref = cost_P * factor(P)`` with ``factor =
    exp(mean(log(s_ref / s_P)))`` over observed pairs (geometric mean —
    ratios compose multiplicatively).  Pairs not involving the reference
    partition are ignored; with the realistic two-partition fleet the
    record is complete, and a deeper hierarchy can chain through the
    reference later.
    """

    def __init__(self, reference: Optional[str] = None):
        self.reference = reference
        self._pairs: Dict[str, Tuple[float, int]] = {}  # fp -> (sum_log, n)
        self._lock = threading.Lock()

    def observe(self, fp_a: str, sec_a: float, fp_b: str,
                sec_b: float) -> None:
        """One duplicate pair: the same task measured on two partitions."""
        if (self.reference is None or fp_a == fp_b
                or sec_a <= 0.0 or sec_b <= 0.0
                or not math.isfinite(sec_a) or not math.isfinite(sec_b)):
            return
        if fp_a == self.reference:
            ref_s, other_fp, other_s = sec_a, fp_b, sec_b
        elif fp_b == self.reference:
            ref_s, other_fp, other_s = sec_b, fp_a, sec_a
        else:
            return
        with self._lock:
            s, n = self._pairs.get(other_fp, (0.0, 0))
            self._pairs[other_fp] = (s + math.log(ref_s / other_s), n + 1)

    def factor(self, fp: str) -> float:
        """Multiplier converting fp-partition seconds into reference
        seconds; 1.0 for the reference itself or an uncalibrated
        partition."""
        if fp == self.reference:
            return 1.0
        with self._lock:
            s, n = self._pairs.get(fp, (0.0, 0))
        return math.exp(s / n) if n else 1.0

    def snapshot(self) -> List[dict]:
        """The calibration-ratio record: one row per calibrated
        partition (``ratio`` converts its seconds to reference
        seconds)."""
        with self._lock:
            items = sorted(self._pairs.items())
        return [{"partition": fp, "reference": self.reference,
                 "ratio": round(math.exp(s / n), 6), "n_pairs": n}
                for fp, (s, n) in items if n]


# ---------------------------------------------------------------------------
# tuner side: the pool
# ---------------------------------------------------------------------------

class _RemoteTask:
    __slots__ = ("id", "point", "fidelity", "timeout", "state", "future",
                 "dispatched", "holders", "resolved", "speculated",
                 "spec_holders", "winner")

    def __init__(self, task_id: int, point: Dict, fidelity, timeout,
                 state=None):
        self.id = task_id
        self.point = point
        self.fidelity = fidelity
        self.timeout = timeout
        #: opaque checkpoint-fork blob (protocol v2 ``state`` field);
        #: rides every copy of the task — reinjection, timeout
        #: re-dispatch and speculation must all resume the same lineage
        self.state = state
        self.future: Future = Future()
        # True once sent to any worker: the future is RUNNING from then
        # on (let-it-finish preemption), including across a reinjection
        self.dispatched = False
        #: workers currently holding a copy -> dispatch timestamp.  More
        #: than one entry means a speculative duplicate is in flight.
        self.holders: Dict["_WorkerConn", float] = {}
        #: claimed under the pool lock by the first result — the winner;
        #: every later copy is a loser and is discarded.  (The Future's
        #: own at-most-once semantics are the backstop, but two read
        #: loops racing set_result would make the second raise, so the
        #: claim happens under the lock.)
        self.resolved = False
        #: True once a duplicate was ever dispatched (stats/health)
        self.speculated = False
        #: the workers that received *duplicate* (speculative) copies —
        #: distinguishes "the duplicate won" from "the straggler finished
        #: after all" in the win counter
        self.spec_holders: set = set()
        #: (partition fp_id, raw seconds) of the winning measurement —
        #: pairs with a loser's raw seconds to calibrate partitions
        self.winner: Optional[Tuple[str, float]] = None


def _task_msg(task: "_RemoteTask") -> Dict:
    """Wire form of one task dispatch (shared by the dispatch loop and
    the speculative re-dispatch so every copy carries the same payload).
    ``state`` is a protocol-v2 field and is omitted when absent — v1
    workers never see it because ``_pick``/``_speculate`` only route
    stateful tasks to v2 workers."""
    msg = {"type": "task", "id": task.id, "point": task.point,
           "fidelity": task.fidelity, "timeout": task.timeout}
    if task.state is not None:
        msg["state"] = task.state
    return msg


class _WorkerConn:
    __slots__ = ("address", "sock", "slots", "heartbeat_timeout", "inflight",
                 "alive", "last_seen", "pid", "hostname", "protocol",
                 "fingerprint", "fp_id", "joined_at", "draining", "origin")

    def __init__(self, address, sock, slots, heartbeat_timeout, pid, hostname,
                 protocol=PROTOCOL_V1, fingerprint=None, origin="dial"):
        self.address = address
        self.sock = sock
        self.slots = slots
        self.heartbeat_timeout = heartbeat_timeout
        self.inflight: Dict[int, _RemoteTask] = {}
        self.alive = True
        self.last_seen = time.time()
        self.pid = pid
        self.hostname = hostname
        self.protocol = protocol  # negotiated wire version for this session
        self.fingerprint = dict(fingerprint or UNKNOWN_FINGERPRINT)
        self.fp_id = fingerprint_id(self.fingerprint)
        self.joined_at = time.time()
        #: a worker that sent ``leaving``: no new dispatches, in-flight
        #: measurements run to completion, then the session ends
        self.draining = False
        self.origin = origin  # "dial" (initial fleet) | "join" (elastic)


class RemoteWorkerPool:
    """Futures-speaking pool over remote worker daemons.

    Drop-in for the executor's thread/process pools: ``submit`` returns a
    :class:`concurrent.futures.Future` resolving to the ``(value,
    seconds, meta)`` triple ``run_objective`` produces (the worker runs
    the *same* function), so ``EvaluationExecutor``'s wait, cancel,
    timeout, and exactly-once machinery apply unchanged.

    All *initial* workers must be reachable at construction (fail fast
    on a typo'd fleet); mid-run failures are survived by reinjecting
    that worker's in-flight tasks.  There is no reconnect for a dead
    connection — but the fleet is elastic: the pool's join socket
    (``join_address``) stays open for the whole run, so replacement or
    additional daemons can register at any time (``launch/worker.py
    --join``), and a worker can deregister cleanly with ``leaving``.
    """

    def __init__(self, addresses: Sequence[str], *,
                 eval_timeout: Optional[float] = None,
                 connect_timeout: float = 10.0,
                 fleet: Optional[FleetOptions] = None):
        self.fleet = fleet if fleet is not None else FleetOptions()
        if not addresses and self.fleet.listen_port is None:
            raise ValueError("remote backend needs at least one "
                             "host:port worker address (or a join socket "
                             "— FleetOptions.listen_port — to start empty)")
        self.eval_timeout = eval_timeout
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._queue: deque = deque()
        self._seq = 0
        self._shutdown = False
        self._workers: List[_WorkerConn] = []
        #: pinned/reference hardware partition: the first *reported*
        #: fingerprint id (unknown-partition workers pin nothing).
        #: strict: every other reported fingerprint must match;
        #: normalize: others are admitted and cost-calibrated against it.
        self._partition: Optional[str] = None
        self._calibration = _FleetCalibration()
        self._completion_stats = CompletionStats()
        self._ever_had_workers = False
        # observability counters (fleet_health / bench gates)
        self.speculations = 0       # duplicate dispatches issued
        self.speculation_wins = 0   # tasks a duplicate resolved first
        self.losers_discarded = 0   # late duplicate results dropped
        self.rejected_joins = 0     # joiners refused (strict mismatch, ...)
        self.clean_leaves = 0       # workers that deregistered cleanly
        deadline = time.time() + connect_timeout
        for addr in addresses:
            self._admit(self._connect(addr, deadline), initial=True)
        # the join socket is open for the WHOLE run — that is what makes
        # the fleet elastic (a daemon can register while rungs drain)
        self._listen_sock: Optional[socket.socket] = None
        if self.fleet.listen_port is not None:
            self._listen_sock = socket.create_server(
                (self.fleet.listen_host, int(self.fleet.listen_port)))
        self._threads = [
            threading.Thread(target=self._read_loop, args=(w,), daemon=True,
                             name=f"remote-read-{w.address}")
            for w in self._workers
        ]
        self._threads.append(threading.Thread(
            target=self._dispatch_loop, daemon=True, name="remote-dispatch"))
        self._threads.append(threading.Thread(
            target=self._monitor_loop, daemon=True, name="remote-monitor"))
        if self._listen_sock is not None:
            self._threads.append(threading.Thread(
                target=self._accept_loop, daemon=True, name="remote-accept"))
        for t in self._threads:
            t.start()

    @property
    def join_address(self) -> Optional[str]:
        """``host:port`` a late worker dials to join this fleet, or
        ``None`` for a fixed (non-listening) fleet."""
        if self._listen_sock is None:
            return None
        host, port = self._listen_sock.getsockname()[:2]
        return f"{host}:{port}"

    # -- connection setup ----------------------------------------------------
    def _connect(self, address: str, deadline: float) -> _WorkerConn:
        host, port = parse_address(address)
        sock = None
        while sock is None:
            try:
                sock = socket.create_connection((host, port), timeout=2.0)
            except OSError as e:
                if time.time() >= deadline:
                    raise ConnectionError(
                        f"cannot reach measurement worker {address}: {e!r} "
                        "(is `launch/worker.py` / --serve-worker running "
                        "there?)") from None
                time.sleep(0.05)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        WorkerServer._enable_keepalive(sock)
        sock.settimeout(10.0)  # handshake only; task reads block forever
        try:
            send_msg(sock, _proto.hello())
            reg = recv_msg(sock)
        except (OSError, ValueError) as e:
            sock.close()
            raise ConnectionError(
                f"handshake with worker {address} failed: {e!r}") from None
        if reg.get("type") != "register" \
                or reg.get("protocol") not in SUPPORTED_PROTOCOLS:
            sock.close()
            raise ConnectionError(
                f"worker {address} spoke {reg.get('type')!r} protocol "
                f"{reg.get('protocol')!r}, expected register/"
                f"{SUPPORTED_PROTOCOLS}")
        if reg.get("error"):
            # the worker came up but its objective did not (bad
            # --objective spec, import failure): fail the pool loudly
            # with the worker's own explanation instead of dispatching
            # to a fleet that can only answer -inf
            sock.close()
            raise ConnectionError(
                f"worker {address} failed at startup: {reg['error']}")
        sock.settimeout(None)
        return self._conn_from_register(address, sock, reg, origin="dial")

    def _conn_from_register(self, address, sock, reg,
                            origin="dial") -> _WorkerConn:
        # stall window derived PER WORKER from its registered heartbeat
        # (3 missed beats); the fleet-level heartbeat_s option only fills
        # in for a register that did not declare one
        hb = float(reg.get("heartbeat_s")
                   or self.fleet.heartbeat_s or DEFAULT_HEARTBEAT_S)
        fp = reg.get("fingerprint")
        if not isinstance(fp, dict) or not fp:
            fp = None  # v1 / pre-elastic worker: synthetic unknown partition
        return _WorkerConn(address, sock, max(1, int(reg.get("slots", 1))),
                           max(3.0 * hb, 1.0), reg.get("pid"),
                           reg.get("host"),
                           protocol=int(reg.get("protocol", PROTOCOL_V1)),
                           fingerprint=fp, origin=origin)

    def _admit(self, worker: _WorkerConn, *, initial: bool) -> None:
        """Homogeneity gate + bookkeeping for a registered worker.

        ``initial`` workers that fail the strict gate fail the *pool*
        (a statically mis-assembled fleet is a configuration error);
        joiners are turned away individually (the run goes on with the
        partition it is pinned to).  Raises ``ConnectionError`` on
        rejection — callers close the socket.
        """
        with self._lock:
            if worker.fp_id == UNKNOWN_PARTITION:
                # no fingerprint reported (v1 / pre-elastic daemon):
                # admissible everywhere, pins nothing
                pass
            elif self._partition is None:
                self._partition = worker.fp_id
                self._calibration.reference = worker.fp_id
            elif (worker.fp_id != self._partition
                  and self.fleet.homogeneity == "strict"):
                raise ConnectionError(
                    f"worker {worker.address} is hardware partition "
                    f"{worker.fp_id} ({worker.fingerprint}) but this fleet "
                    f"is pinned to partition {self._partition}; strict "
                    "homogeneity refuses to mix measurements across "
                    "hardware (use --fleet-homogeneity normalize to allow "
                    "a mixed fleet with cost calibration)")
            self._workers.append(worker)
            self._ever_had_workers = True
            self._wake.notify_all()

    # -- elastic joins -------------------------------------------------------
    def _accept_loop(self) -> None:
        try:
            self._listen_sock.settimeout(0.5)
        except OSError:  # shutdown closed the socket before we started
            return
        while not self._shutdown:
            try:
                conn, peer = self._listen_sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            # handshake on a short-lived thread: one stalled joiner must
            # not block the next (nor the run — the accept loop is not on
            # any dispatch path)
            threading.Thread(target=self._handle_join, args=(conn, peer),
                             daemon=True, name="remote-join").start()

    def _handle_join(self, conn: socket.socket, peer) -> None:
        address = f"{peer[0]}:{peer[1]}"
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            WorkerServer._enable_keepalive(conn)
            conn.settimeout(10.0)  # handshake only
            send_msg(conn, _proto.hello())
            reg = recv_msg(conn)
        except (OSError, ValueError):
            try:
                conn.close()
            except OSError:
                pass
            return
        ok = (reg.get("type") == "register"
              and reg.get("protocol") in SUPPORTED_PROTOCOLS
              and not reg.get("error")
              and int(reg.get("slots", 0)) > 0)
        if ok:
            conn.settimeout(None)
            worker = self._conn_from_register(address, conn, reg,
                                              origin="join")
            try:
                self._admit(worker, initial=False)
            except ConnectionError:
                ok = False
        if not ok:
            with self._lock:
                self.rejected_joins += 1
            try:
                send_msg(conn, {"type": "bye"})
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
            return
        t = threading.Thread(target=self._read_loop, args=(worker,),
                             daemon=True, name=f"remote-read-{address}")
        with self._lock:
            self._threads.append(t)
        t.start()

    # -- pool surface (what EvaluationExecutor calls) ------------------------
    @property
    def parallelism(self) -> int:
        """Fleet-wide measurement capacity, **live**: slot total of
        workers that are alive and not draining.  Grows the moment a
        joiner registers and shrinks the moment a worker dies or starts
        leaving — every capacity-sighted loop (async refill, rung drain,
        the service's slot governor) re-reads this each scheduling step,
        never a startup snapshot."""
        with self._lock:
            return sum(w.slots for w in self._workers
                       if w.alive and not w.draining)

    def alive_workers(self) -> int:
        with self._lock:
            return sum(1 for w in self._workers if w.alive)

    @property
    def speculating(self) -> int:
        """Tasks currently running as duplicates (straggler + copy)."""
        with self._lock:
            seen = set()
            for w in self._workers:
                for t in w.inflight.values():
                    if len(t.holders) > 1:
                        seen.add(t.id)
            return len(seen)

    def fleet_health(self) -> List[dict]:
        """Per-worker snapshot (the service's ``job_status`` fleet view)."""
        now = time.time()
        with self._lock:
            rows = []
            for w in self._workers:
                ages = [now - t0 for t in w.inflight.values()
                        for wk, t0 in t.holders.items() if wk is w]
                rows.append({
                    "address": w.address, "alive": w.alive,
                    "slots": w.slots, "inflight": len(w.inflight),
                    "protocol": w.protocol, "pid": w.pid, "host": w.hostname,
                    "seconds_since_seen": round(now - w.last_seen, 3),
                    "fingerprint": dict(w.fingerprint),
                    "partition": w.fp_id,
                    "joined_at": round(w.joined_at, 3),
                    "origin": w.origin,
                    "draining": w.draining,
                    "inflight_age_max": round(max(ages), 3) if ages else 0.0,
                    "speculating": sum(1 for t in w.inflight.values()
                                       if len(t.holders) > 1),
                })
            return rows

    def fleet_stats(self) -> dict:
        """Pool-level elastic/speculation counters + calibration record."""
        with self._lock:
            counters = {
                "speculations": self.speculations,
                "speculation_wins": self.speculation_wins,
                "losers_discarded": self.losers_discarded,
                "rejected_joins": self.rejected_joins,
                "clean_leaves": self.clean_leaves,
                "partition": self._partition,
                "homogeneity": self.fleet.homogeneity,
            }
        counters["speculating"] = self.speculating
        counters["join_address"] = self.join_address
        counters["calibration"] = self._calibration.snapshot()
        counters["completion_times"] = self._completion_stats.snapshot()
        return counters

    def submit(self, fn, objective, point: Dict,
               fidelity: Optional[float] = None,
               state: Optional[dict] = None) -> Future:
        """Queue one measurement; returns its Future.

        Signature-compatible with ``ThreadPoolExecutor.submit(
        run_objective, objective, point, fidelity)``; ``fn`` and
        ``objective`` are ignored — the worker daemon owns its own
        objective instance (that is the point of the remote backend:
        the objective's heavyweight state lives on the measurement
        host, only points and results cross the wire).

        ``state`` is an opaque checkpoint-fork blob (PBT lineages): it
        rides the protocol-v2 task payload as ``resume_state`` for the
        worker's objective, so such tasks only dispatch to v2 workers.
        """
        with self._wake:
            if self._shutdown:
                raise RuntimeError("cannot submit to a shut-down pool")
            if not any(w.alive for w in self._workers):
                if self._ever_had_workers or self._listen_sock is None:
                    # fail loudly NOW: an enqueued task with no worker
                    # left to run it would never resolve, and the driver
                    # would wait on it forever
                    raise ConnectionError(
                        "all remote measurement workers are disconnected; "
                        "cannot dispatch new evaluations")
                # deliberately-empty elastic start (addresses=[] with a
                # join socket): queue until the first daemon registers
            self._seq += 1
            task = _RemoteTask(self._seq, dict(point), fidelity,
                               self.eval_timeout, state)
            self._queue.append(task)
            self._wake.notify_all()
        return task.future

    def shutdown(self, wait: bool = True, cancel_futures: bool = False) -> None:
        with self._wake:
            if self._shutdown:
                return
            self._shutdown = True
            # queued-but-undispatched tasks can never run once the pool
            # is down, so their futures are cancelled regardless of
            # cancel_futures — leaving them PENDING would hang anyone
            # blocked on them.  (The flag keeps the ThreadPoolExecutor-
            # compatible signature; dispatched tasks' futures likewise
            # never resolve after the sockets close.)
            for task in self._queue:
                task.future.cancel()
            self._queue.clear()
            workers = [w for w in self._workers if w.alive]
            threads = list(self._threads)
            self._wake.notify_all()
        if self._listen_sock is not None:
            try:
                self._listen_sock.close()
            except OSError:
                pass
        for w in workers:
            try:
                send_msg(w.sock, {"type": "bye"})
            except OSError:
                pass
            try:
                w.sock.close()
            except OSError:
                pass
        if wait:
            for t in threads:
                t.join(timeout=2.0)

    # -- internals -----------------------------------------------------------
    def _pick(self):
        """Next (task, worker) pair, or None; caller holds the lock.

        A task carrying a checkpoint-fork ``state`` blob may only go to
        a protocol-v2 worker (v1 workers would silently drop the resume
        state and measure a cold start).  The queue is scanned in order
        so a stateful task at the head does not starve stateless work
        that a v1 worker could run right now.
        """
        if not self._queue:
            return None
        best = None
        for w in self._workers:
            free = w.slots - len(w.inflight)
            if w.alive and not w.draining and free > 0:
                if best is None or free > (best.slots - len(best.inflight)):
                    best = w
        if best is None:
            return None
        for i, task in enumerate(self._queue):
            if task.state is None:
                del self._queue[i]
                return task, best
            if best.protocol >= PROTOCOL_V2:
                del self._queue[i]
                return task, best
            # stateful task, best worker is v1: any v2 worker with a
            # free slot can take it instead
            v2 = None
            for w in self._workers:
                free = w.slots - len(w.inflight)
                if (w.alive and not w.draining and free > 0
                        and w.protocol >= PROTOCOL_V2):
                    if v2 is None or free > (v2.slots - len(v2.inflight)):
                        v2 = w
            if v2 is not None:
                del self._queue[i]
                return task, v2
            # no v2 capacity: leave it queued, keep scanning for
            # stateless work the v1 fleet can absorb
        return None

    def _dispatch_loop(self) -> None:
        while True:
            with self._wake:
                picked = None
                while not self._shutdown and picked is None:
                    picked = self._pick()
                    if picked is None:
                        self._wake.wait(0.1)
                if self._shutdown:
                    return
                task, worker = picked
                worker.inflight[task.id] = task
                task.holders[worker] = time.time()
            # future-state transition and the send happen outside the
            # lock: sendall can block and cancel() takes the future lock
            if task.future.done() or (
                    not task.dispatched
                    and not task.future.set_running_or_notify_cancel()):
                # preempted while queued: never sent, nothing measured
                with self._wake:
                    worker.inflight.pop(task.id, None)
                    task.holders.pop(worker, None)
                continue
            task.dispatched = True
            try:
                send_msg(worker.sock, _task_msg(task))
            except OSError:
                self._on_worker_down(worker)

    def _read_loop(self, worker: _WorkerConn) -> None:
        try:
            while True:
                msg = recv_msg(worker.sock)
                kind = msg.get("type")
                if kind == "result":
                    self._on_result(worker, msg)
                elif kind == "heartbeat":
                    with self._lock:
                        worker.last_seen = time.time()
                elif kind == "leaving":
                    # clean deregistration: stop dispatching, let the
                    # in-flight measurements finish, then end the session
                    finish = False
                    with self._wake:
                        worker.draining = True
                        finish = not worker.inflight
                        self._wake.notify_all()
                    if finish:
                        self._finish_leave(worker)
                        break
                elif kind == "bye":
                    break
        except (ConnectionError, OSError, ValueError):
            pass
        self._on_worker_down(worker)

    def _on_result(self, worker: _WorkerConn, msg: dict) -> None:
        now = time.time()
        with self._wake:
            worker.last_seen = now
            task = worker.inflight.pop(msg["id"], None)
            dispatched_at = (task.holders.pop(worker, None)
                             if task is not None else None)
            # first result claims the task under the lock: duplicate
            # completions race through per-worker read loops, and the
            # loser must be identified BEFORE touching the future
            won = task is not None and not task.resolved \
                and not task.future.done()
            if won:
                task.resolved = True
                task.winner = (worker.fp_id, float(msg["seconds"]))
                if worker in task.spec_holders:
                    self.speculation_wins += 1
            elif task is not None:
                self.losers_discarded += 1
            drained = worker.draining and not worker.inflight
            self._wake.notify_all()  # a slot freed up
        if task is None:
            return
        if dispatched_at is not None:
            # dispatch-to-result age feeds the straggler threshold; every
            # real completion counts (losers included — they are honest
            # observations of how long this fleet takes)
            self._completion_stats.record(task.fidelity, now - dispatched_at)
        if won:
            value, seconds, meta = msg["value"], msg["seconds"], msg["meta"]
            if self.fleet.homogeneity == "normalize":
                factor = self._calibration.factor(worker.fp_id)
                if factor != 1.0:
                    seconds = float(seconds) * factor
                    meta = dict(meta or {}, cost_calibration=round(factor, 6))
            task.future.set_result((value, seconds, meta))
        else:
            # loser of a speculative duplicate (or a result for a future
            # the executor already timed out): discarded — it never
            # reaches the memo cache or corpus because it never touches
            # the future.  A cross-partition duplicate pair is exactly
            # one calibration observation.
            if task.winner is not None:
                self._calibration.observe(
                    task.winner[0], task.winner[1],
                    worker.fp_id, float(msg["seconds"]))
        if drained:
            self._finish_leave(worker)

    def _finish_leave(self, worker: _WorkerConn) -> None:
        """End a draining worker's session once its in-flight is empty."""
        try:
            send_msg(worker.sock, {"type": "bye"})
        except OSError:
            pass
        # nothing in flight, nothing to reinject: _on_worker_down just
        # marks it dead and handles the (empty-fleet) stranding rules.
        # The departure is counted only AFTER the alive set shrank (and
        # only by whichever caller actually performed the transition):
        # an observer that sees clean_leaves bump must never still see
        # the leaver in alive_workers().
        if self._on_worker_down(worker):
            with self._lock:
                self.clean_leaves += 1

    def _monitor_loop(self) -> None:
        while not self._shutdown:
            with self._lock:
                timeouts = [w.heartbeat_timeout for w in self._workers
                            if w.alive]
            # re-derived every tick: joiners may have registered with a
            # faster heartbeat than the startup fleet
            interval = min(timeouts, default=1.0) / 4.0
            time.sleep(min(max(interval, 0.05), 1.0))
            now = time.time()
            with self._lock:
                workers = list(self._workers)
            for w in workers:
                if w.alive and now - w.last_seen > w.heartbeat_timeout:
                    self._on_worker_down(w)
            if self.fleet.speculation:
                self._speculate(now)

    def _speculate(self, now: float) -> None:
        """Dispatch duplicates of suspected stragglers onto free slots.

        A dispatched task older than ``speculation_factor * p95`` of its
        rung's observed completion times (``min_observations`` required)
        gets ONE live copy on a *different* worker; first result wins.
        Only truly idle capacity is used: fresh queued work always
        outranks a duplicate (the queue is drained first)."""
        factor = float(self.fleet.speculation_factor)
        min_obs = int(self.fleet.min_observations)
        plan: List[Tuple[_RemoteTask, _WorkerConn]] = []
        with self._wake:
            if self._queue or self._shutdown:
                return
            free = [w for w in self._workers
                    if w.alive and not w.draining
                    and w.slots - len(w.inflight) > 0]
            if not free:
                return
            candidates = []
            for w in self._workers:
                if not w.alive:
                    continue
                for t in w.inflight.values():
                    if t.resolved or len(t.holders) != 1:
                        continue  # done, or already has a live copy
                    n = self._completion_stats.observations(t.fidelity)
                    p95 = self._completion_stats.p95(t.fidelity)
                    if n < min_obs or not p95:
                        continue
                    age = now - t.holders.get(w, now)
                    if age > factor * p95:
                        candidates.append((age, t, w))
            candidates.sort(key=lambda c: -c[0])  # oldest straggler first
            for _age, task, holder in candidates:
                target = None
                for w in sorted(free, key=lambda w: len(w.inflight)):
                    if w is not holder and w not in task.holders \
                            and w.slots - len(w.inflight) > 0 \
                            and (task.state is None
                                 or w.protocol >= PROTOCOL_V2):
                        target = w
                        break
                if target is None:
                    continue
                target.inflight[task.id] = task
                task.holders[target] = now
                task.speculated = True
                task.spec_holders.add(target)
                self.speculations += 1
                plan.append((task, target))
        for task, target in plan:
            try:
                send_msg(target.sock, _task_msg(task))
            except OSError:
                self._on_worker_down(target)

    def _on_worker_down(self, worker: _WorkerConn) -> bool:
        """Mark dead + reinject its in-flight tasks (front of the queue:
        they have been waiting longest and a rung scheduler upstream may
        be blocked on them).  A task whose duplicate is still live on
        another worker is NOT reinjected — the surviving copy resolves
        it (re-dispatching would just add a third measurement).

        Returns True iff *this* call performed the alive->dead
        transition (callers that want to count the departure exactly
        once key off it)."""
        with self._wake:
            if not worker.alive:
                return False
            worker.alive = False
            reinject = []
            for t in worker.inflight.values():
                t.holders.pop(worker, None)
                if not t.resolved and not t.future.done() and not t.holders:
                    reinject.append(t)
            worker.inflight.clear()
            self._queue.extendleft(reversed(reinject))
            fleet_down = not any(w.alive for w in self._workers)
            stranded: List[_RemoteTask] = []
            if fleet_down:
                stranded = list(self._queue)
                self._queue.clear()
            self._wake.notify_all()
        try:
            worker.sock.close()
        except OSError:
            pass
        if fleet_down and not self._shutdown:
            err = ConnectionError(
                "all remote measurement workers disconnected; "
                f"{len(stranded)} evaluation(s) stranded")
            for t in stranded:
                if not t.future.done():
                    t.future.set_exception(err)
        return True


# ---------------------------------------------------------------------------
# worker side: the daemon server
# ---------------------------------------------------------------------------

class WorkerServer:
    """One measurement host: accepts a tuner, pulls tasks, streams results.

    The daemon owns its objective instance (built once — evaluator state
    like compile caches lives here for the life of the process) and runs
    each task through ``run_objective``, the same isolation wrapper the
    local backends use, on a ``slots``-wide thread pool.  A heartbeat
    rides the connection every ``heartbeat_s`` seconds so the tuner can
    tell a hung host from a busy one.

    Sessions are serial: one tuner at a time, and when it disconnects
    the worker goes back to accepting — so a fleet of daemons survives
    tuner restarts.  Results for tasks still running when a session dies
    are dropped (the tuner reinjected them already); the measurement
    threads are left to finish and the next session gets fresh slots.

    ``start()`` serves on a background thread (tests, in-process
    fleets); ``serve_forever()`` is the daemon entry point.  For an
    *elastic* fleet the connection direction flips: ``join(address)`` /
    ``start_join(address)`` dial a running pool's join socket and run
    the exact same session over the dialed-out connection, so a daemon
    started mid-run adds capacity immediately; ``request_leave()``
    deregisters cleanly (the pool stops dispatching, in-flight
    measurements finish, nothing is lost).
    """

    def __init__(self, objective, host: str = "127.0.0.1", port: int = 0,
                 slots: int = 1, heartbeat_s: float = DEFAULT_HEARTBEAT_S,
                 startup_error: Optional[str] = None,
                 protocol_ceiling: int = PROTOCOL_V2,
                 fingerprint: Optional[Dict] = None):
        from repro_torch.tuning.executor import run_objective
        from repro_torch.tuning.objective import as_evaluator

        # bound eagerly, on the main thread: the first task must pay
        # measurement cost only, and an import failure must crash the
        # daemon at startup, not vanish inside a measurement thread.
        # A daemon whose objective could NOT be built still serves in
        # error mode (startup_error set): it registers carrying the
        # import error so the *tuner* fails loudly with the real cause,
        # instead of the fleet looking merely unreachable.
        self._run_objective = run_objective
        self.startup_error = startup_error
        self.protocol_ceiling = int(protocol_ceiling)
        self.objective = (None if startup_error is not None
                          else as_evaluator(objective))
        self.slots = max(1, int(slots))
        self.heartbeat_s = float(heartbeat_s)
        self.handshake_timeout_s = 10.0
        self._lsock = socket.create_server((host, int(port)))
        self.host, self.port = self._lsock.getsockname()[:2]
        # computed after the bind so connecting tuners see an open port
        # while any heavyweight fingerprint import warms up
        self.fingerprint = (dict(fingerprint) if fingerprint is not None
                            else _worker_fingerprint())
        self._stop = threading.Event()
        self._leave = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._active_conn: Optional[socket.socket] = None
        self._session_send_lock: Optional[threading.Lock] = None
        self.sessions_served = 0

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def serve_forever(self) -> None:
        self._lsock.settimeout(0.5)
        while not self._stop.is_set():
            try:
                conn, _peer = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            self._active_conn = conn
            try:
                self._session(conn)
            except (ConnectionError, OSError, ValueError):
                pass  # tuner went away / spoke garbage: next session
            finally:
                self._active_conn = None
                try:
                    conn.close()
                except OSError:
                    pass

    @staticmethod
    def _enable_keepalive(conn: socket.socket) -> None:
        """A tuner host that dies without FIN (power loss, partition)
        would otherwise leave the session recv blocked for the kernel's
        ~15-minute retransmit timeout — with serial sessions that wedges
        the daemon out of the fleet.  TCP keepalive (tuned to ~minute
        detection where the platform allows) turns it into an ordinary
        connection error and the daemon goes back to accepting."""
        conn.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
        for opt, val in (("TCP_KEEPIDLE", 30), ("TCP_KEEPINTVL", 10),
                         ("TCP_KEEPCNT", 3)):
            if hasattr(socket, opt):  # Linux; darwin spells idle differently
                conn.setsockopt(socket.IPPROTO_TCP, getattr(socket, opt), val)

    def _session(self, conn: socket.socket) -> None:
        from concurrent.futures import ThreadPoolExecutor

        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._enable_keepalive(conn)
        # handshake under a timeout: sessions are serial, so a stray
        # connection that never says hello (port scan, health probe)
        # must not wedge the accept loop and take this host out of the
        # fleet.  Task reads then block indefinitely — a live tuner is
        # allowed to be quiet, and its death closes the socket.
        conn.settimeout(self.handshake_timeout_s)
        hello = recv_msg(conn)
        version = _proto.negotiate(hello, ceiling=self.protocol_ceiling)
        if version is None:
            send_msg(conn, {"type": "error",
                            "error": f"unsupported hello {hello!r}"})
            return
        register = {
            "type": "register", "protocol": version,
            "slots": self.slots, "heartbeat_s": self.heartbeat_s,
            "pid": os.getpid(), "host": socket.gethostname(),
        }
        if version >= PROTOCOL_V2:
            # v2 field: the hardware partition this host measures in
            # (v1 tuners never see it; v1 workers never send it and the
            # pool gives them the synthetic unknown partition)
            register["fingerprint"] = dict(self.fingerprint)
        if self.startup_error is not None:
            # error mode: tell the tuner WHY this host cannot measure,
            # then end the session (no slots are usable anyway)
            register.update(slots=0, error=self.startup_error)
            send_msg(conn, register)
            return
        send_msg(conn, register)
        conn.settimeout(None)
        self.sessions_served += 1
        send_lock = threading.Lock()
        self._session_send_lock = send_lock
        session_over = threading.Event()

        def heartbeat():
            while not session_over.wait(self.heartbeat_s):
                try:
                    with send_lock:
                        send_msg(conn, {"type": "heartbeat"})
                except OSError:
                    # the peer is unreachable: force the blocked session
                    # recv to error out too, so the daemon returns to
                    # accepting instead of wedging on a dead connection
                    try:
                        conn.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    return

        hb = threading.Thread(target=heartbeat, daemon=True)
        hb.start()
        pool = ThreadPoolExecutor(max_workers=self.slots,
                                  thread_name_prefix="measure")
        try:
            while True:
                msg = recv_msg(conn)
                kind = msg.get("type")
                if kind == "task":
                    pool.submit(self._measure, conn, send_lock, msg)
                elif kind == "bye":
                    return
                # unknown message types are ignored: forward-compatible
        finally:
            session_over.set()
            self._session_send_lock = None
            # running measurements are abandoned (their tuner is gone and
            # reinjected them); don't block the accept loop on them
            pool.shutdown(wait=False, cancel_futures=True)

    def _measure(self, conn, send_lock, msg) -> None:
        try:
            value, seconds, meta = self._run_objective(
                self.objective, msg["point"], msg.get("fidelity"),
                msg.get("state"))
        except BaseException as e:  # run_objective already catches
            # objective errors; anything reaching here is worker
            # infrastructure breaking — report it rather than going
            # silent (a task that never answers looks like a hang)
            value, seconds = -float("inf"), 0.0
            meta = {"error": f"worker infrastructure failure: {e!r}"}
        try:
            json.dumps(meta, allow_nan=True)
        except (TypeError, ValueError):
            # never let a weird evaluator meta kill the session: the
            # measurement is still real, only its annotations are not
            # transportable
            meta = {"meta_error": "evaluator meta was not "
                                  "JSON-serializable and was dropped"}
        try:
            with send_lock:
                send_msg(conn, {"type": "result", "id": msg["id"],
                                "value": value, "seconds": seconds,
                                "meta": meta})
        except OSError:
            pass  # session died; the tuner reinjects this task elsewhere

    # -- elastic join (worker dials the pool) --------------------------------
    def join(self, address: str, retry_s: Optional[float] = None,
             connect_timeout: float = 10.0) -> None:
        """Dial a running pool's join socket and serve it.

        The session is byte-identical to an accepted one (the pool sends
        hello first in both directions), so everything — slots,
        heartbeats, fingerprint, results — behaves exactly as for a
        dialed-out worker.  ``retry_s=None`` is one-shot (connect
        failures raise, a finished session returns); with a retry
        interval the daemon keeps re-dialing through pool restarts until
        stopped or cleanly left.
        """
        host, port = parse_address(address)
        while not self._stop.is_set():
            try:
                conn = socket.create_connection((host, port),
                                                timeout=connect_timeout)
            except OSError as e:
                if retry_s is None:
                    raise ConnectionError(
                        f"cannot reach tuner pool {address}: {e!r} "
                        "(is the tuner running with a join socket?)"
                    ) from None
                if self._stop.wait(retry_s):
                    return
                continue
            self._active_conn = conn
            try:
                self._session(conn)
            except (ConnectionError, OSError, ValueError):
                pass
            finally:
                self._active_conn = None
                try:
                    conn.close()
                except OSError:
                    pass
            if retry_s is None or self._leave.is_set():
                return
            if self._stop.wait(retry_s):
                return

    def start_join(self, address: str,
                   retry_s: Optional[float] = None) -> "WorkerServer":
        """``join`` on a background thread (tests, embedded fleets)."""
        self._thread = threading.Thread(target=self.join,
                                        args=(address, retry_s),
                                        daemon=True, name="worker-join")
        self._thread.start()
        return self

    def request_leave(self) -> bool:
        """Deregister cleanly from the current session.

        Sends ``leaving``; the pool stops dispatching here, waits for
        this worker's in-flight measurements to stream back, then ends
        the session with ``bye`` — nothing is lost, nothing re-measured.
        Returns False when there is no active session to leave.
        """
        self._leave.set()
        conn, lock = self._active_conn, self._session_send_lock
        if conn is None or lock is None:
            return False
        try:
            with lock:
                send_msg(conn, {"type": "leaving"})
        except OSError:
            return False
        return True

    # -- in-process lifecycle (tests / embedded fleets) ----------------------
    def start(self) -> "WorkerServer":
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True, name="worker-serve")
        self._thread.start()
        return self

    def stop(self) -> None:
        """Hard-stop the worker (tests use this to simulate a host dying:
        the active session's socket is closed mid-conversation)."""
        self._stop.set()
        conn = self._active_conn
        if conn is not None:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        try:
            self._lsock.close()
        except OSError:
            pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)
