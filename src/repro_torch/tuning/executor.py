"""Parallel evaluation executor — the measurement side of ask/tell.

The executor owns the worker pool and the memoization of completed
measurements.  It speaks two protocols:

* **batch** — ``evaluate(points) -> [EvalResult]`` runs a whole batch
  and returns results in submission order (the legacy barrier loop and
  standalone drivers use this);
* **completion-driven** — ``submit(points) -> [PendingEval]`` dispatches
  work without waiting and ``next_completed(pendings)`` blocks until
  *any* one of them finishes, so a driver can ``tell`` results the
  moment they land and refill the freed worker instead of idling the
  pool at a per-batch barrier.  ``as_completed(pendings)`` is the
  generator convenience over the same mechanism.

Shared semantics across both protocols:

* **failure isolation** — an objective that raises scores ``-inf`` (the
  paper's failed-run semantics for OOM/compile crashes) and the pool
  survives;
* **per-evaluation timeout** — a configuration that exceeds ``timeout``
  seconds scores ``-inf`` with ``meta={"timeout": True}`` (the paper's
  failed-run semantics: this configuration is too slow to measure).  The
  stuck worker is abandoned, not joined, so other evaluations keep
  flowing.  The clock starts at dispatch; a task still queued when its
  wait expires is cancelled and measured inline instead of being falsely
  recorded as a failure (remote backend: re-dispatched to the fleet with
  a fresh deadline instead — the workers own the real objective there);
* **wall-clock deadline** — ``next_completed``/``evaluate`` accept an
  absolute ``deadline`` (how the tuner bounds in-flight work against its
  ``wall_clock_budget``).  A deadline expiry is a *budget artifact of
  this run*, not a property of the configuration, so unfinished
  evaluations are **abandoned** at the deadline: nothing is recorded and
  nothing is cached, and a later run measures them normally;
* **shared memo cache** — completed evaluations (including failures) are
  memoized by grid key.  Pass ``cache_path`` (or a :class:`MemoCache`
  built on a :class:`~repro_torch.tuning.cache.CacheStore`) to back the memo
  with an on-disk JSON store with atomic writes and cross-process file
  locking: repeated runs, resumed runs, and multiple hosts sharing a
  filesystem then reuse every measurement instead of re-compiling it.
  Timeout results stay in the in-memory memo only — a ``-inf`` under one
  run's timeout setting must not permanently poison the cross-run store;

Backends:

* ``"serial"`` — in-process, zero pool overhead.  ``parallelism=1``
  without a timeout defaults to this and reproduces the pre-batching
  sequential trace bit-for-bit.  (With a timeout set, the default is a
  1-worker thread pool, since only a pool can bound a running
  evaluation; the serial backend merely flags overruns after the fact.)
* ``"thread"`` — default for ``parallelism>1``.  Objectives that release
  the GIL (CUDA kernels, subprocess measurement harnesses, any
  native code) scale; closures and unpicklable objectives all work.
* ``"process"`` — true CPU parallelism for picklable objectives.
* ``"remote"`` — measurements farmed to ``launch/worker.py`` daemons on
  other hosts over the length-prefixed-JSON RPC protocol
  (``repro_torch.tuning.remote``); pass ``workers=["host:port", ...]``.
  Effective ``parallelism`` is the fleet's total slot count, a worker
  death reinjects its in-flight tasks (never recorded as config
  failures), preempting a task a worker already started keeps the
  let-it-finish semantics of a started pool task, and results are
  cached *by the tuner process* — workers never need the shared
  filesystem the cache store lives on.

Multi-fidelity support (the successive-halving stack, see
``repro_torch.tuning.fidelity``):

* ``submit(points, fidelity=f)`` dispatches *partial* measurements —
  the evaluator's ``fidelity`` protocol (``repro_torch.tuning.objective``)
  decides what a fraction of a measurement means.  Evaluators that do
  not opt in are measured at full fidelity and say so in
  ``meta["fidelity"]``;
* the memo cache keys low-fidelity results by **(grid key, fidelity)**:
  a cheap noisy measurement must never be served where a full one was
  requested (or vice versa), while full-fidelity entries keep the
  historical key format so existing on-disk stores load unchanged;
* ``preempt(pending)`` is the scheduler's kill switch for dispatched
  work that has since been dominated.  ``future.cancel()`` decides the
  outcome: a still-queued task is cancelled cleanly (never measured,
  nothing recorded, nothing cached — a later run can still measure it),
  while a task whose worker already started runs to completion and its
  result is recorded normally (the measurement is paid for; wasting it
  would lose information).  Both outcomes leave exactly-once recording
  intact — nothing is lost, nothing is double-recorded.
"""
from __future__ import annotations

import json
import math
import threading
import time
from concurrent.futures import (
    FIRST_COMPLETED,
    ProcessPoolExecutor,
    ThreadPoolExecutor,
    wait,
)
from concurrent.futures import TimeoutError as FutureTimeoutError
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, Iterator, List, Optional, Sequence

if TYPE_CHECKING:  # annotation-only: a runtime import would pull in all of
    # repro_torch.core (and with it numpy) — and create an import cycle that
    # breaks whichever of executor/tuner is imported first.  Measurement
    # workers import this module for run_objective and must stay light.
    from repro_torch.core.space import SearchSpace

from repro_torch.tuning.cache import (
    CacheStore,
    NullCacheStore,
    _round_trip_violation,
    ensure_serializable,
    open_store,
)
from repro_torch.tuning.objective import Evaluator, as_evaluator
from repro_torch.tuning.remote import FleetOptions, RemoteWorkerPool

BACKENDS = ("serial", "thread", "process", "remote")


@dataclass
class EvalResult:
    point: Dict
    value: float
    cost_seconds: float = 0.0
    meta: dict = field(default_factory=dict)


def run_objective(objective: Evaluator, point: Dict,
                  fidelity: Optional[float] = None,
                  resume_state: Optional[dict] = None):
    """One isolated evaluation: ``(value, seconds, meta)``.

    Module-level so the process backend can pickle it.  A raising
    objective is a failed configuration, not a pool failure.

    ``fidelity=None`` (or 1.0) calls the objective exactly like the
    historical no-fidelity path — the golden sequential traces depend on
    this.  A lower fidelity is forwarded iff the evaluator declares
    ``supports_fidelity``; otherwise the measurement silently upgrades
    to full fidelity and ``meta["fidelity"]`` reports the upgrade.

    ``resume_state`` is the checkpoint-fork blob (a prior step's
    ``meta["fork_state"]``), forwarded iff the evaluator declares
    ``supports_fork``; an evaluator without fork support measures the
    point from scratch, which is correct, just colder.
    """
    full = fidelity is None or fidelity >= 1.0
    kwargs = {}
    if resume_state is not None and getattr(objective, "supports_fork", False):
        kwargs["resume_state"] = resume_state
    t0 = time.time()
    try:
        if full or not getattr(objective, "supports_fidelity", False):
            value, meta = objective(point, **kwargs)
            delivered = 1.0
        else:
            value, meta = objective(point, fidelity=float(fidelity), **kwargs)
            delivered = float(fidelity)
        value = float(value)
        meta = dict(meta)
        if not full:  # full-fidelity meta stays exactly as the evaluator
            meta.setdefault("fidelity", delivered)  # made it (golden traces)
    except Exception as e:
        value, meta = -math.inf, {"error": repr(e)}
        if not full:
            meta["fidelity"] = float(fidelity)
    seconds = time.time() - t0
    # an evaluator that knows its own measurement cost (a harness timing
    # just the compile, or a benchmark with simulated costs) declares it
    # as meta["cost_seconds"], overriding the wall-clock default; this is
    # the signal cost-aware acquisition trains its cost model on, so a
    # declared cost keeps it deterministic under harness noise
    declared = meta.get("cost_seconds")
    if isinstance(declared, (int, float)) and not isinstance(declared, bool) \
            and math.isfinite(declared) and declared >= 0:
        seconds = float(declared)
    return value, seconds, meta


def _canon_key_component(c):
    """Canonical JSON form of one grid-key component.

    Tuples become lists (so the fidelity marker stays parseable by
    ``MemoCache._stored_fidelity``) and numpy scalars unwrap via
    ``.item()`` — a *lossless* coercion (``np.int64(3)`` -> ``3``), so a
    space built from e.g. ``np.linspace`` values keys identically to its
    plain-Python spelling for both store and lookup.  Duck-typed on the
    type's module so measurement workers importing this module never pay
    a numpy import.  Anything else passes through for the strict
    round-trip check to judge.
    """
    if isinstance(c, (tuple, list)):
        return [_canon_key_component(v) for v in c]
    if type(c).__module__ == "numpy" and getattr(c, "ndim", 1) == 0:
        v = c.item()
        # .item() can hand back the same numpy type when there is no
        # lossless Python equivalent (np.longdouble): leave it for the
        # round-trip check to reject instead of recursing forever
        if type(v) is not type(c):
            return _canon_key_component(v)
    return c


def _store_key(key) -> str:
    """Stable string form of a grid key for the on-disk store.

    Components are canonicalized first (:func:`_canon_key_component`:
    tuples -> lists, numpy scalars -> their exact Python values) and
    serialization is then **strict**: a component that is still not
    canonical JSON — an arbitrary object, a lossy exotic scalar — raises
    ``TypeError`` naming it.  The historical ``default=str`` fallback
    silently stringified such components, producing store keys that
    could collide with (or never round-trip back to) the honest
    spelling.
    """
    parts = [_canon_key_component(c) for c in key]
    bad = _round_trip_violation(parts, path="grid key")
    if bad:
        raise TypeError(
            f"grid key {tuple(key)!r} is not strictly JSON-serializable: "
            f"{bad}; refusing to persist under a default=str spelling")
    return json.dumps(parts)


_FID_TAG = "__fidelity__"


def memo_key(grid_key, fidelity: Optional[float]) -> tuple:
    """Memo identity of a measurement: the grid key, plus the fidelity
    when (and only when) it is partial.

    Full-fidelity keys are exactly the historical grid keys, so existing
    in-memory memos and on-disk stores keep working unchanged; partial
    measurements get a distinct key so a cheap noisy result is never
    served where a full measurement was requested."""
    grid_key = tuple(grid_key)
    if fidelity is None or fidelity >= 1.0:
        return grid_key
    return grid_key + ((_FID_TAG, round(float(fidelity), 9)),)


_LIN_TAG = "__lineage__"


def lineage_key(key, lineage: Optional[str], rung: Optional[int]) -> tuple:
    """Isolate a *stateful* measurement's memo identity by its lineage
    and step.

    A checkpoint-forked step is not a pure function of (point, fidelity)
    — it also depends on the opaque ``resume_state`` it continued from —
    so two lineages (or two steps of one lineage) at the same point must
    never share a memo hit.  Stateless measurements keep the plain
    (point, fidelity) key and keep sharing, which is why this tag is
    applied only when a state blob rides the submission."""
    return tuple(key) + ((_LIN_TAG, str(lineage or ""), int(rung or 0)),)


def grid_key_of(key) -> tuple:
    """Strip the fidelity/lineage markers (if any) off a memo key."""
    key = tuple(key)
    while key and isinstance(key[-1], tuple) and key[-1] \
            and key[-1][0] in (_FID_TAG, _LIN_TAG):
        key = key[:-1]
    return key


class MemoCache:
    """Shared memo of completed evaluations, keyed by ``space.key(point)``.

    Optionally write-through to a :class:`~repro_torch.tuning.cache.CacheStore`
    so entries persist across processes, runs, and hosts.  Records are
    stored as ``{"point", "value", "cost_seconds", "meta"}`` so a
    different process can re-derive the grid key from the point under
    its own ``SearchSpace``.

    Persistence granularity: with ``autoflush=True`` (the default, and
    the historical behavior) every ``put`` is its own store write.  The
    executor constructs its caches with ``autoflush=False`` and calls
    :meth:`flush` once per completion drain instead, so N completions
    cost one read-merge-write of the store file rather than N — records
    are still *validated* serializable at ``put`` time (the error must
    name the evaluation that produced it, not surface at some later
    flush).  ``flushes`` counts actual store writes for tests and
    observability.
    """

    def __init__(self, backing=None, lock=None,
                 store: Optional[CacheStore] = None, autoflush: bool = True):
        self._d = {} if backing is None else backing
        self._lock = lock if lock is not None else threading.Lock()
        self._store = store if store is not None else open_store(None)
        self._persistent = not isinstance(self._store, NullCacheStore)
        self._autoflush = autoflush
        self._dirty: Dict[str, dict] = {}
        self.flushes = 0

    @classmethod
    def process_safe(cls, store: Optional[CacheStore] = None,
                     autoflush: bool = True) -> "MemoCache":
        import multiprocessing

        manager = multiprocessing.Manager()
        return cls(backing=manager.dict(), lock=manager.Lock(), store=store,
                   autoflush=autoflush)

    @staticmethod
    def _stored_fidelity(store_key: str) -> Optional[float]:
        """Requested fidelity embedded in a persisted key, or None.

        The *requested* fidelity is the lookup identity (an evaluator may
        deliver a snapped/clamped fidelity in meta, which would never
        match a repeat request), and it is space-independent, so parsing
        it off the stored key keeps the re-derive-grid-key-from-point
        behavior for the rest of the key.
        """
        try:
            parsed = json.loads(store_key)
        except (json.JSONDecodeError, TypeError):
            return None
        if (isinstance(parsed, list) and parsed
                and isinstance(parsed[-1], list) and parsed[-1]
                and parsed[-1][0] == _FID_TAG):
            return float(parsed[-1][1])
        return None

    def load_store(self, space: SearchSpace) -> int:
        """Seed the in-memory memo from the persistent store; return count."""
        n = 0
        for skey, rec in self._store.load().items():
            key = memo_key(space.key(rec["point"]),
                           self._stored_fidelity(skey))
            with self._lock:
                if key not in self._d:
                    self._d[key] = EvalResult(
                        dict(rec["point"]), float(rec["value"]),
                        float(rec.get("cost_seconds", 0.0)),
                        dict(rec.get("meta") or {}))
                    n += 1
        return n

    def get(self, key) -> Optional[EvalResult]:
        with self._lock:
            return self._d.get(key)

    def put(self, key, result: EvalResult, persist: bool = True) -> None:
        with self._lock:
            self._d[key] = result
        if not (persist and self._persistent):
            return
        skey = _store_key(key)
        record = {
            "point": result.point, "value": result.value,
            "cost_seconds": result.cost_seconds, "meta": result.meta,
        }
        if self._autoflush:
            self._store.put(skey, record)  # put_many validates
            self.flushes += 1
        else:
            # fail at put time, not at some later flush: the traceback
            # must point at the evaluation whose record is broken
            ensure_serializable(skey, record)
            with self._lock:
                self._dirty[skey] = record

    def flush(self) -> None:
        """Persist buffered puts as one store write (no-op when clean)."""
        with self._lock:
            dirty, self._dirty = self._dirty, {}
        if dirty:
            self._store.put_many(dirty)
            self.flushes += 1

    def __len__(self) -> int:
        return len(self._d)


class PendingEval:
    """A dispatched evaluation: completed (``done()``) or still running.

    ``deadline`` is the absolute time by which the evaluation must have
    produced a result; past it, ``next_completed`` resolves the pending
    to ``-inf`` with ``meta={"timeout": True}`` (or measures it inline
    if the pool never actually started it).

    ``fidelity``/``rung`` tag partial measurements for the trial
    scheduler (``None`` = full measurement, outside any scheduler);
    ``state``/``lineage`` tag checkpoint-fork steps (PBT): ``state`` is
    the opaque ``resume_state`` blob forwarded to the evaluator and
    ``lineage`` the trial ancestry recorded in History.  ``preempted``
    records that the scheduler asked for this evaluation to be killed —
    whether the kill landed is ``preempt``'s return value, not this
    flag.
    """

    __slots__ = ("point", "key", "index", "submitted_at", "deadline",
                 "future", "fidelity", "rung", "state", "lineage",
                 "preempted", "_result")

    def __init__(self, point, key, index, future=None, result=None,
                 deadline=None, fidelity=None, rung=None, state=None,
                 lineage=None):
        self.point = point
        self.key = key
        self.index = index
        self.submitted_at = time.time()
        self.deadline = deadline
        self.future = future
        self.fidelity = fidelity
        self.rung = rung
        self.state = state
        self.lineage = lineage
        self.preempted = False
        self._result = result

    def done(self) -> bool:
        return self._result is not None

    def result(self) -> EvalResult:
        assert self._result is not None, "pending evaluation not complete"
        return self._result


class EvaluationExecutor:
    def __init__(
        self,
        objective,
        space: SearchSpace,
        *,
        parallelism: int = 1,
        backend: Optional[str] = None,
        timeout: Optional[float] = None,
        cache: Optional[MemoCache] = None,
        cache_path: Optional[str] = None,
        workers: Optional[Sequence[str]] = None,
        pool=None,
        corpus=None,
        fleet: Optional[FleetOptions] = None,
    ):
        self.objective = as_evaluator(objective)
        self.space = space
        self._parallelism = max(1, int(parallelism))
        #: fair-share throttle: when set (the tuning service's slot
        #: governor), ``parallelism`` reports at most this many slots,
        #: so a multi-tenant driver keeps its in-flight window inside
        #: its share of a shared pool.  Dispatched work is never
        #: revoked by lowering it — the window shrinks as results land.
        self.slot_cap: Optional[int] = None
        # a shared pool (multi-tenant service: N executors over one
        # worker fleet / thread pool) is injected pre-built; this
        # executor then never shuts it down
        self._owns_pool = pool is None
        # a timeout needs a pool to enforce it mid-run: the serial backend
        # can only flag an overrun after the objective returns
        if backend is None:
            if pool is not None:
                backend = ("remote" if isinstance(pool, RemoteWorkerPool)
                           else "thread")
            elif workers:
                backend = "remote"
            else:
                backend = ("serial"
                           if self._parallelism == 1 and timeout is None
                           else "thread")
        self.backend = backend
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown executor backend {self.backend!r}; one of {BACKENDS}")
        self.fleet = fleet
        elastic = fleet is not None and fleet.listen_port is not None
        if (self.backend == "remote" and not workers and pool is None
                and not elastic):
            raise ValueError(
                "backend='remote' needs workers=['host:port', ...] "
                "(launch/worker.py daemons), a shared pool=, or fleet= "
                "with a join socket for workers to dial in")
        if workers and self.backend != "remote":
            raise ValueError(
                f"workers= is only meaningful with backend='remote' "
                f"(got backend={self.backend!r})")
        self.workers = list(workers) if workers else None
        self.timeout = timeout
        if cache is not None and cache_path is not None:
            raise ValueError(
                "pass either cache= (a shared MemoCache, which carries its "
                "own store) or cache_path=, not both — cache_path would be "
                "silently ignored")
        store = open_store(cache_path) if cache_path else None
        if cache is not None:
            self.cache = cache
        elif self.backend == "process":
            self.cache = MemoCache.process_safe(store=store, autoflush=False)
        else:
            self.cache = MemoCache(store=store, autoflush=False)
        if store is not None:
            self.cache.load_store(space)
        #: optional cross-job observation corpus (transfer learning,
        #: ``repro_torch.tuning.corpus``): every finalized real measurement is
        #: appended under this job's workload descriptor and flushed with
        #: the memo cache
        self.corpus = corpus
        if corpus is not None and corpus.descriptor is None:
            corpus.describe_job(self.objective, space)
        self._pool = pool
        self._inflight: Dict = {}  # grid key -> future currently measuring it
        self._seq = 0  # monotonic submission index (orders completions)
        if self.backend == "remote" and self._pool is None:
            # connect eagerly: fail fast on an unreachable fleet, and the
            # drivers size their in-flight window off the fleet's actual
            # capacity (registered worker slots), not a local guess
            self._pool = RemoteWorkerPool(self.workers or [],
                                          eval_timeout=self.timeout,
                                          fleet=self.fleet)

    @property
    def remote_pool(self) -> Optional[RemoteWorkerPool]:
        """The live fleet (remote backend only) — drivers use it to print
        the join address and to render speculation / straggler status."""
        return self._pool if self.backend == "remote" else None

    @property
    def parallelism(self) -> int:
        """Measurement capacity the driver should keep in flight.  For
        the remote backend this is the *live* fleet's slot total — it
        shrinks when a worker dies, so the driver stops overfilling the
        queue and starving tasks into their per-eval deadlines.  A
        ``slot_cap`` (fair-share governor) caps either backend."""
        if self.backend == "remote" and self._pool is not None:
            base = max(1, self._pool.parallelism)
        else:
            base = self._parallelism
        if self.slot_cap is not None:
            base = max(1, min(base, int(self.slot_cap)))
        return base

    def _get_pool(self):
        if self._pool is None:
            if self.backend == "thread":
                self._pool = ThreadPoolExecutor(max_workers=self.parallelism)
            elif self.backend == "process":
                self._pool = ProcessPoolExecutor(max_workers=self.parallelism)
        return self._pool

    def _corpus_add(self, result: EvalResult,
                    fidelity: Optional[float] = None) -> None:
        """Append one finalized real measurement to the transfer corpus.

        Memoized aliases, preempted placeholders, and timeout verdicts
        are not measurements of this workload (same judgment calls as
        memo persistence) and are skipped; failed configurations
        (``-inf``) are recorded — "this config crashes here" transfers.
        """
        if self.corpus is None:
            return
        m = result.meta
        if m.get("memoized") or m.get("preempted") or m.get("timeout"):
            return
        fid = m.get("fidelity")
        if fid is None:
            fid = 1.0 if fidelity is None else float(fidelity)
        self.corpus.add(result.point, result.value, result.cost_seconds,
                        float(fid))

    def _flush(self) -> None:
        """One store write for the memo cache and the corpus alike."""
        self.cache.flush()
        if self.corpus is not None:
            self.corpus.flush()

    # -- completion-driven protocol ------------------------------------------
    def submit(self, points: Sequence[Dict],
               fidelity: Optional[float] = None,
               rung: Optional[int] = None,
               state: Optional[dict] = None,
               lineage: Optional[str] = None) -> List[PendingEval]:
        """Dispatch evaluations without waiting; returns one pending each.

        Memo-cache hits come back already completed (zero cost,
        ``meta["memoized"]``).  Duplicate keys already in flight share
        the running measurement instead of re-dispatching it.  Each
        dispatched pending carries a per-evaluation deadline of
        ``now + timeout`` (when a timeout is set); wall-clock budgeting
        is the *caller's* deadline, passed to ``next_completed``.

        ``fidelity`` requests partial measurements (evaluator fidelity
        protocol); partial results are memoized under (grid key,
        fidelity) so they are only ever reused at the same fidelity.
        ``rung`` is an opaque tag echoed on the pendings for the trial
        scheduler's bookkeeping.

        ``state`` is an opaque checkpoint-fork blob forwarded to the
        evaluator as ``resume_state`` (PBT): a stateful submission is
        not a pure function of (point, fidelity), so its memo key is
        additionally tagged with (``lineage``, ``rung``) — forked
        lineages never collide with each other or with stateless
        measurements of the same point — and its result is memoized
        in-process only: never persisted to the cross-run store, never
        fed to the transfer corpus.
        """
        # an objective that cannot vary fidelity always delivers a full
        # measurement: key (and run) it as one, or identical full results
        # would fragment across per-fidelity memo keys and re-measure
        if fidelity is not None \
                and not getattr(self.objective, "supports_fidelity", False):
            fidelity = None
        out: List[PendingEval] = []
        for p in points:
            key = memo_key(self.space.key(p), fidelity)
            if state is not None:
                key = lineage_key(key, lineage, rung)
            self._seq += 1
            hit = self.cache.get(key)
            if hit is not None:
                out.append(PendingEval(
                    dict(p), key, self._seq, fidelity=fidelity, rung=rung,
                    state=state, lineage=lineage,
                    result=EvalResult(dict(p), hit.value, 0.0,
                                      dict(hit.meta, memoized=True))))
                continue
            eval_deadline = (time.time() + self.timeout
                             if self.timeout is not None else None)
            stale = self._inflight.get(key)
            if stale is not None and stale.cancelled():
                # preempted before it ever started: nothing was measured,
                # so dispatch a fresh measurement instead of aliasing
                del self._inflight[key]
                stale = None
            if stale is not None and stale.done():
                # a previously abandoned measurement finished after its
                # driver moved on: harvest it into the cache now
                self._harvest(key, stale)
                hit = self.cache.get(key)
                out.append(PendingEval(
                    dict(p), key, self._seq, fidelity=fidelity, rung=rung,
                    state=state, lineage=lineage,
                    result=EvalResult(dict(p), hit.value, 0.0,
                                      dict(hit.meta, memoized=True))))
                continue
            if stale is not None:
                out.append(PendingEval(dict(p), key, self._seq, future=stale,
                                       deadline=eval_deadline,
                                       fidelity=fidelity, rung=rung,
                                       state=state, lineage=lineage))
                continue
            if self.backend == "serial":
                out.append(PendingEval(dict(p), key, self._seq,
                                       fidelity=fidelity, rung=rung,
                                       state=state, lineage=lineage,
                                       result=self._run_one(p, fidelity,
                                                            state)))
                r = out[-1].result()
                self.cache.put(key, r, persist=state is None
                               and not r.meta.get("timeout"))
                if state is None:
                    self._corpus_add(r, fidelity)
                continue
            fut = self._submit_to_pool(p, fidelity, state)
            self._inflight[key] = fut
            out.append(PendingEval(dict(p), key, self._seq, future=fut,
                                   deadline=eval_deadline,
                                   fidelity=fidelity, rung=rung,
                                   state=state, lineage=lineage))
        self._flush()  # serial-path results + harvested strays
        return out

    def _submit_to_pool(self, point: Dict, fidelity: Optional[float],
                        state: Optional[dict]):
        """Dispatch one measurement to the pool backend.

        The stateless spelling is kept positionally identical to the
        historical call so thread/process/remote pools and their tests
        see the exact same submission; the ``resume_state`` argument is
        appended only when a checkpoint-fork blob actually rides along.
        """
        if state is None:
            return self._get_pool().submit(run_objective, self.objective,
                                           point, fidelity)
        return self._get_pool().submit(run_objective, self.objective,
                                       point, fidelity, state)

    @staticmethod
    def _stateful_key(key) -> bool:
        return bool(key) and isinstance(key[-1], tuple) and key[-1] \
            and key[-1][0] == _LIN_TAG

    def _harvest(self, key, future) -> None:
        """Bank an abandoned-but-finished measurement into the memo."""
        value, secs, meta = future.result()
        if self._inflight.get(key) is future:
            del self._inflight[key]
        point = dict(zip(self.space.names, grid_key_of(key)))
        res = EvalResult(point, value, secs, meta)
        if self._stateful_key(key):
            # a checkpoint-fork step: valid only within its lineage —
            # memoize in-process, never persist or feed the corpus
            self.cache.put(key, res, persist=False)
            return
        self.cache.put(key, res)
        self._corpus_add(res)  # a paid-for real measurement, late or not

    def _finalize(self, pending: PendingEval) -> None:
        """Turn a completed future into the pending's EvalResult + memo."""
        if pending.future.cancelled():
            # a sibling pending sharing this measurement was preempted
            # before the worker started: nothing was measured, so this
            # alias resolves to the same not-recorded placeholder (a later
            # submit measures the point for real)
            if self._inflight.get(pending.key) is pending.future:
                del self._inflight[pending.key]
            pending.preempted = True
            pending._result = EvalResult(dict(pending.point), -math.inf,
                                         0.0, {"preempted": True})
            return
        value, secs, meta = pending.future.result()
        if self._inflight.get(pending.key) is pending.future:
            del self._inflight[pending.key]
            pending._result = EvalResult(dict(pending.point), value, secs,
                                         meta)
            self.cache.put(pending.key, pending._result,
                           persist=pending.state is None)
            if pending.state is None:
                self._corpus_add(pending._result, pending.fidelity)
        else:
            # an alias of a measurement another pending already finalized:
            # like every memoized path, it costs 0.0 — charging the full
            # measurement twice would inflate cost accounting downstream
            pending._result = EvalResult(dict(pending.point), value, 0.0,
                                         dict(meta, memoized=True))

    def preempt(self, pending: PendingEval) -> str:
        """Best-effort kill of a dispatched evaluation the caller no longer
        wants (a successive-halving rung outclassed it while in flight).

        Returns one of:

        * ``"cancelled"`` — the task had not started; it is resolved to a
          ``meta={"preempted": True}`` placeholder that is **not** cached
          and must not be recorded (the point was never measured; a later
          submit measures it normally);
        * ``"running"`` — a worker already started (``future.cancel()``
          returned False): the measurement runs to completion and its
          result arrives through ``next_completed`` exactly as usual —
          it was paid for, so the caller records it normally;
        * ``"done"`` — the result already exists; the caller must record
          it (preempting a completed evaluation is a no-op).

        Every path keeps exactly-once accounting: a pending is either
        resolved to a preempted placeholder (never recorded, never
        cached) or produces exactly one real result.
        """
        if pending.done():
            return "done"
        if pending.future is None:  # serial backend resolves at submit
            return "done"
        pending.preempted = True
        if pending.future.cancel():
            if self._inflight.get(pending.key) is pending.future:
                del self._inflight[pending.key]
            pending._result = EvalResult(
                dict(pending.point), -math.inf, 0.0, {"preempted": True})
            return "cancelled"
        # the worker beat us to it (or another pending shares the future):
        # let the measurement finish and be recorded — killing a running
        # thread is impossible and wasting a paid-for result loses data
        return "running"

    def _resolve_timeout(self, pending: PendingEval, now: float) -> bool:
        """Per-evaluation timeout expiry (never wall-clock expiry).
        Returns False when the pending was *re-dispatched* instead of
        resolved (remote backend, see below) — the caller keeps waiting.
        """
        if self._inflight.get(pending.key) is pending.future:
            del self._inflight[pending.key]
        if pending.future.cancel():
            # never started (pool starved by earlier slow evals): this point
            # was not measured at all — recording a bogus failure is wrong
            if self.backend == "remote":
                # ...and so is measuring it inline: the tuner-side
                # objective is a stand-in over this backend (workers own
                # the real one).  Re-dispatch to the fleet with a fresh
                # deadline — the timeout clock properly starts at
                # dispatch, and this task never was dispatched.
                fut = self._submit_to_pool(pending.point, pending.fidelity,
                                           pending.state)
                self._inflight[pending.key] = fut
                pending.future = fut
                pending.submitted_at = now
                pending.deadline = (now + self.timeout
                                    if self.timeout is not None else None)
                return False
            pending._result = self._run_one(pending.point, pending.fidelity,
                                            pending.state)
        else:
            # genuinely running too long: abandon the stuck worker (it is
            # not joined); the pool survives
            secs = (float(self.timeout) if self.timeout is not None
                    else now - pending.submitted_at)
            pending._result = EvalResult(dict(pending.point), -math.inf,
                                         secs, {"timeout": True})
        # memoize within this run, but never persist a timeout verdict to
        # the cross-run store: it reflects this run's timeout setting, not
        # the configuration itself (stateful fork steps never persist)
        self.cache.put(pending.key, pending._result,
                       persist=pending.state is None
                       and not pending._result.meta.get("timeout"))
        # the inline-measurement branch is a real measurement; the helper
        # skips the timeout verdicts itself
        if pending.state is None:
            self._corpus_add(pending._result, pending.fidelity)
        return True

    def next_completed(self, pendings: Sequence[PendingEval],
                       deadline: Optional[float] = None,
                       ) -> Optional[PendingEval]:
        """Block until any pending completes; return it (submission-order
        tie-break when several are ready).  Returns ``None`` only when
        ``deadline`` passes with nothing resolvable — timed-out
        evaluations resolve to ``-inf`` results, not to ``None``."""
        pendings = sorted(pendings, key=lambda p: p.index)
        while True:
            for p in pendings:
                if p.done():
                    return p
            if not pendings:
                return None
            now = time.time()
            waits = [p.deadline - now for p in pendings
                     if p.deadline is not None]
            if deadline is not None:
                waits.append(deadline - now)
            wait_s = max(0.0, min(waits)) if waits else None
            done, _ = wait({p.future for p in pendings}, timeout=wait_s,
                           return_when=FIRST_COMPLETED)
            if done:
                # drain everything that is ready, then persist the whole
                # drain as ONE store flush: N simultaneous completions
                # cost one read-merge-write of the cache file, not N
                # (the stragglers return instantly from done() on the
                # caller's next call, without touching the store)
                first = None
                for p in pendings:
                    if p.future in done:
                        self._finalize(p)
                        if first is None:
                            first = p
                self._flush()
                return first
            now = time.time()
            for p in pendings:
                if p.deadline is not None and now >= p.deadline:
                    if self._resolve_timeout(p, now):
                        self._flush()
                        return p
                    # re-dispatched (remote starvation): keep waiting
            if deadline is not None and now >= deadline:
                return None

    def as_completed(self, pendings: Sequence[PendingEval],
                     deadline: Optional[float] = None,
                     ) -> Iterator[PendingEval]:
        """Yield pendings as they complete (completion order)."""
        remaining = list(pendings)
        while remaining:
            p = self.next_completed(remaining, deadline=deadline)
            if p is None:
                return
            remaining.remove(p)
            yield p

    # -- batch protocol ------------------------------------------------------
    def evaluate(self, points: List[Dict],
                 deadline: Optional[float] = None) -> List[Optional[EvalResult]]:
        """Evaluate a batch; results in submission order.

        With a ``deadline``, evaluations not finished when it passes are
        *abandoned*: their slot in the returned list is ``None`` (not a
        fake ``-inf``), nothing is cached, and a later run measures them
        normally.  Per-evaluation ``timeout`` expiries still resolve to
        ``-inf`` timeout results as always.
        """
        results: List[Optional[EvalResult]] = [None] * len(points)
        abandoned = [False] * len(points)
        todo: List[int] = []  # indices that miss the memo cache
        first_at: Dict = {}  # key -> index of first in-batch occurrence
        for i, p in enumerate(points):
            key = self.space.key(p)
            hit = self.cache.get(key)
            if hit is not None:
                results[i] = EvalResult(dict(p), hit.value, 0.0,
                                        dict(hit.meta, memoized=True))
            elif key in first_at:
                pass  # in-batch duplicate: aliased after the batch runs
            else:
                first_at[key] = i
                todo.append(i)

        if todo:
            if self.backend == "serial":
                for i in todo:
                    if deadline is not None and time.time() >= deadline:
                        abandoned[i] = True  # budget spent: don't even start
                        continue
                    results[i] = self._run_one(points[i])
            else:
                pool = self._get_pool()
                futures = [(i, pool.submit(run_objective, self.objective,
                                           points[i]))
                           for i in todo]
                dispatched_at = time.time()
                for i, fut in futures:
                    wait_s = self.timeout
                    if deadline is not None:
                        left = max(0.0, deadline - time.time())
                        wait_s = left if wait_s is None else min(wait_s, left)
                    try:
                        value, secs, meta = fut.result(timeout=wait_s)
                    except FutureTimeoutError:
                        timed_out = (self.timeout is not None and
                                     time.time() - dispatched_at
                                     >= self.timeout)
                        if not timed_out:
                            # pure wall-clock expiry: a budget artifact of
                            # this run, not a failed configuration — abandon
                            # (queued tasks are cancelled, running workers
                            # left to finish unrecorded)
                            fut.cancel()
                            abandoned[i] = True
                            continue
                        if fut.cancel():
                            if (deadline is not None
                                    and time.time() >= deadline):
                                # starved AND out of budget: abandoning beats
                                # an inline measurement that would overshoot
                                # the wall clock unboundedly
                                abandoned[i] = True
                                continue
                            # never started (pool starved by earlier slow
                            # evals): this point was not measured at all, so
                            # give it its run rather than recording a bogus
                            # failure
                            if self.backend == "remote":
                                # ...but not inline: the tuner-side
                                # objective is a stand-in over this backend
                                # (mirrors _resolve_timeout).  One fresh
                                # dispatch to the fleet; if that starves or
                                # busts the budget too, abandon unrecorded.
                                retry = pool.submit(run_objective,
                                                    self.objective, points[i])
                                retry_s = self.timeout
                                if deadline is not None:
                                    left = max(0.0, deadline - time.time())
                                    retry_s = (left if retry_s is None
                                               else min(retry_s, left))
                                try:
                                    value, secs, meta = retry.result(
                                        timeout=retry_s)
                                except FutureTimeoutError:
                                    if retry.cancel() or (
                                            deadline is not None
                                            and time.time() >= deadline):
                                        abandoned[i] = True
                                        continue
                                    value, secs, meta = (
                                        -math.inf, float(self.timeout),
                                        {"timeout": True})
                                results[i] = EvalResult(dict(points[i]),
                                                        value, secs, meta)
                                continue
                            results[i] = self._run_one(points[i])
                            continue
                        # genuinely running too long: abandon the stuck
                        # worker (it is not joined); the pool survives
                        value, secs, meta = (-math.inf, float(self.timeout),
                                             {"timeout": True})
                    results[i] = EvalResult(dict(points[i]), value, secs, meta)
            for i in todo:
                if results[i] is not None:
                    self.cache.put(self.space.key(points[i]), results[i],
                                   persist=not results[i].meta.get("timeout"))
                    self._corpus_add(results[i])
            self._flush()  # the whole batch is one store write

        for i, p in enumerate(points):  # resolve in-batch duplicates
            if results[i] is None and not abandoned[i]:
                src = results[first_at[self.space.key(p)]]
                if src is None:
                    continue  # its source was abandoned at the deadline
                results[i] = EvalResult(dict(p), src.value, 0.0,
                                        dict(src.meta, memoized=True))
        return results

    def _run_one(self, point: Dict,
                 fidelity: Optional[float] = None,
                 state: Optional[dict] = None) -> EvalResult:
        value, secs, meta = run_objective(self.objective, point, fidelity,
                                          state)
        if self.timeout is not None and secs > self.timeout:
            value, meta = -math.inf, dict(meta, timeout=True)
        return EvalResult(dict(point), value, secs, meta)

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        self._flush()  # nothing buffered may outlive the executor
        if self._pool is not None:
            if self._owns_pool:  # a shared pool outlives its tenants
                self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
        self._inflight.clear()

    def __enter__(self) -> "EvaluationExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
