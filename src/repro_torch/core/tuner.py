"""Tuner orchestrator (paper Fig. 4), completion-driven edition.

Algorithm-selection switch + iteration budget (paper: 50) **or**
wall-clock budget + memoized objective + checkpoint/resume.

The default loop (``loop="async"``) is a completion-driven scheduler:
the engine is asked for enough candidates to fill every free worker, the
:class:`EvaluationExecutor` measures them concurrently, and the moment
*any* evaluation completes its result is ``tell``-ed back and a single
replacement point is asked — so engines see results in completion order
(BO refreshes its candidate set per completion, the GA inserts
steady-state, Nelder-Mead reconciles speculative probes that finish
late) and no worker ever idles at a batch barrier behind one slow
configuration.  ``loop="batch"`` keeps the legacy per-batch barrier for
comparison (see ``benchmarks/perf_iterations.py --async-loop``).

``parallelism=1`` (the default) uses the serial executor and both loops
degenerate to the historical one-point-per-iteration sequence, which
reproduces the seed trace bit-for-bit for the same seed (pinned by
``tests/golden/ask_tell_traces.json``).

The wall-clock budget bounds *in-flight* work, not just the gaps between
completions: the deadline is threaded into the executor's wait machinery
(the same plumbing that enforces per-evaluation timeouts), and work
still unfinished when it passes is **abandoned** — nothing recorded,
nothing cached, the run stops on time.  When a wall-clock budget is
configured, ``parallelism=1`` automatically uses a 1-worker thread pool
instead of the serial backend, since only a pool can abandon a running
evaluation; an explicitly forced ``executor_backend="serial"`` can still
only stop *between* evaluations, never mid-measurement.

``memo_cache_path`` backs the executor's memo cache with an on-disk JSON
store (atomic writes + cross-process file locking), so a re-run or a
resumed run of the same tuning job re-evaluates nothing and multiple
hosts sharing a filesystem reuse each other's measurements.

``workers=["host:port", ...]`` (or ``executor_backend="remote"``) farms
the measurements to ``launch/worker.py`` daemons over the RPC protocol
in ``repro_torch.tuning.remote``: the completion-driven loop sizes its
in-flight window to the fleet's registered slot total, a worker death
reinjects its in-flight measurements onto survivors (never recorded as
config failures), and every result still lands in the same memo cache —
written by *this* process, so the worker fleet needs no shared
filesystem.

``multi_fidelity=True`` layers a successive-halving rung scheduler
(ASHA; see ``repro_torch.tuning.fidelity``) over the async loop: fresh
candidates are screened with cheap partial measurements, survivors are
promoted fidelity by fidelity, and in-flight promotions that have been
outclassed are preempted through the executor.  The budget then counts
full-measurement equivalents (sum of completed fidelities), so the
scheduler spends what the same budget of full measurements would have —
just on many more candidates.

Objectives follow the explicit evaluator protocol (``(value, meta)``;
see ``repro_torch.tuning.objective``); plain scalar callables are adapted
automatically.  Failures (OOM, compile error, timeout) surface as
``-inf`` and are recorded, mirroring how a real measurement harness
handles a crashed configuration.
"""
from __future__ import annotations

import math
import pathlib
import threading
import time
from dataclasses import asdict, dataclass, field, fields
from typing import Callable, Dict, List, Optional, Union

import numpy as np

from repro_torch.core.bayesopt import BayesOpt, TransferPrior
from repro_torch.core.engine import Engine
from repro_torch.core.exhaustive import Exhaustive
from repro_torch.core.genetic import GeneticAlgorithm
from repro_torch.core.history import History
from repro_torch.core.neldermead import NelderMead
from repro_torch.core.observation import Observation
from repro_torch.core.random_search import RandomSearch
from repro_torch.core.space import SearchSpace
from repro_torch.tuning.executor import EvalResult, EvaluationExecutor, PendingEval
from repro_torch.tuning.objective import as_evaluator
from repro_torch.tuning.remote import FleetOptions

ENGINES = {
    "bo": BayesOpt,
    "ga": GeneticAlgorithm,
    "nms": NelderMead,
    "random": RandomSearch,
    "exhaustive": Exhaustive,
}

LOOPS = ("async", "batch")


def _check_keys(d: dict, known, what: str) -> None:
    """Loud validation shared by every ``from_dict``: unknown keys raise
    a ValueError naming them (same contract ``config_from_point`` has),
    so a malformed JSON job submission fails at the daemon's front door
    instead of silently tuning with defaults."""
    unknown = sorted(set(d) - set(known))
    if unknown:
        hints = {k: _LEGACY_FLAT_HINTS[k] for k in unknown
                 if k in _LEGACY_FLAT_HINTS}
        hint = ("" if not hints else
                "; flat v1 knobs moved into sub-configs: " + ", ".join(
                    f"{k!r} -> {v!r}" for k, v in hints.items()))
        raise ValueError(
            f"unknown {what} key(s) {unknown}; known: {sorted(known)}{hint}")


@dataclass
class ExecutorConfig:
    """How measurements are executed (the evaluation side of the split).

    ``parallelism``      worker-pool width; 1 == historical sequential loop
    ``backend``          serial|thread|process|remote (auto: serial at
                         parallelism=1, thread above, remote when workers set)
    ``workers``          remote backend: host:port worker daemons
                         (launch/worker.py); parallelism becomes the fleet's
                         registered slot total
    ``eval_timeout``     seconds per evaluation; -inf past it
    ``memo_cache_path``  disk-backed cross-run memo cache
    ``batch_size``       batch loop only: points per ask

    Elastic-fleet knobs (remote backend only; ignored elsewhere so
    local backends stay byte-identical):

    ``fleet_port``          join-socket port kept open for the whole run
                            (0 = ephemeral, None = fixed fleet, no socket)
    ``fleet_homogeneity``   strict (refuse mixed hardware fingerprints) |
                            normalize (admit + calibrate cost_seconds)
    ``speculation``         re-execute stragglers on an idle worker
    ``speculation_factor``  duplicate a task once its age exceeds
                            factor × p95 of observed completions
    ``speculation_min_observations``  completions needed per fidelity
                            before the p95 is trusted
    ``heartbeat_s``         fleet-wide heartbeat default; each worker's
                            stall window is 3 missed beats of its own
                            registered interval
    """

    parallelism: int = 1
    backend: Optional[str] = None
    workers: Optional[List[str]] = None
    eval_timeout: Optional[float] = None
    memo_cache_path: Optional[str] = None
    batch_size: Optional[int] = None
    fleet_port: Optional[int] = 0
    fleet_homogeneity: str = "strict"
    speculation: bool = True
    speculation_factor: float = 4.0
    speculation_min_observations: int = 4
    heartbeat_s: Optional[float] = None

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ExecutorConfig":
        _check_keys(d, {f.name for f in fields(cls)}, "ExecutorConfig")
        return cls(**d)

    def fleet_options(self) -> FleetOptions:
        """Elastic-fleet knobs in `RemoteWorkerPool` form (remote only)."""
        return FleetOptions(
            listen_port=self.fleet_port,
            speculation=self.speculation,
            speculation_factor=self.speculation_factor,
            min_observations=self.speculation_min_observations,
            homogeneity=self.fleet_homogeneity,
            heartbeat_s=self.heartbeat_s,
        )


@dataclass
class HyperBandConfig:
    """HyperBand-specific knobs (``multi_fidelity.scheduler = "hyperband"``).

    ``brackets``  how many ASHA brackets to hedge across (deepest ladders
                  first); ``None`` = every bracket the fidelity range
                  supports, ``s_max + 1``
    """

    brackets: Optional[int] = None

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "HyperBandConfig":
        if d is None:
            return cls()
        _check_keys(d, {f.name for f in fields(cls)}, "HyperBandConfig")
        return cls(**d)


@dataclass
class PBTConfig:
    """Population-Based Training knobs (``multi_fidelity.scheduler = "pbt"``).

    ``population``        steady-state population size
    ``exploit_quantile``  cull fraction (bottom) == donor fraction (top)
    ``perturb_prob``      per-dimension explore mutation probability
    ``step_fidelity``     fidelity of every PBT step (``None`` =
                          ``multi_fidelity.min_fidelity``)
    """

    population: int = 6
    exploit_quantile: float = 0.25
    perturb_prob: float = 0.25
    step_fidelity: Optional[float] = None

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "PBTConfig":
        if d is None:
            return cls()
        _check_keys(d, {f.name for f in fields(cls)}, "PBTConfig")
        return cls(**d)


@dataclass
class MultiFidelityConfig:
    """Budget-allocation scheduler knobs; ``enabled=False`` = plain loop.

    ``enabled``           route the run through the scheduler driver;
                          budget then counts full-measurement
                          *equivalents* (sum of fidelities), not
                          evaluations
    ``scheduler``         asha (successive halving, default) | hyperband
                          (bracket hedging) | pbt (population-based
                          training) — see ``repro_torch.tuning.schedulers``
    ``eta``               rung reduction factor (fidelity ratio + survivor
                          fraction 1/eta between adjacent rungs)
    ``min_fidelity``      bottom-rung fidelity floor (and the default PBT
                          step fidelity)
    ``promote_quantile``  per-rung survivor quantile (default 1/eta)
    ``preempt``           kill in-flight work the scheduler has since
                          declared pointless (executor preempt:
                          cancelled if unstarted, recorded normally if
                          already running)
    ``hyperband``/``pbt`` per-scheduler sub-configs
    """

    enabled: bool = False
    eta: float = 3.0
    min_fidelity: float = 0.1
    promote_quantile: Optional[float] = None
    preempt: bool = True
    scheduler: str = "asha"
    hyperband: HyperBandConfig = field(default_factory=HyperBandConfig)
    pbt: PBTConfig = field(default_factory=PBTConfig)

    def __bool__(self) -> bool:
        # ``if config.multi_fidelity:`` predates the sub-config and must
        # keep meaning "is multi-fidelity on", not "is the object present"
        return self.enabled

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Union[dict, bool]) -> "MultiFidelityConfig":
        if isinstance(d, bool):  # submissions may spell it as a plain flag
            return cls(enabled=d)
        _check_keys(d, {f.name for f in fields(cls)}, "MultiFidelityConfig")
        kw = {k: v for k, v in d.items() if k not in ("hyperband", "pbt")}
        return cls(hyperband=HyperBandConfig.from_dict(d.get("hyperband")),
                   pbt=PBTConfig.from_dict(d.get("pbt")), **kw)


@dataclass
class TransferConfig:
    """Transfer learning across tuning jobs (see ``repro_torch.tuning.corpus``).

    ``corpus_path``    persistent observation-corpus JSON file; ``None``
                       disables transfer entirely (the bit-for-bit path)
    ``job_id``         provenance id stamped on records this job writes
                       (auto-generated when unset)
    ``warm_start``     seed the BO surrogate with neighbor-workload rows
                       under inflated, decaying observation noise
    ``prefilter``      over-ask the engine and measure only the
                       top-``keep_fraction`` of candidates by
                       corpus-predicted score (all engines that declare
                       ``prefilter_safe``)
    ``k_neighbors``    nearest neighbor workloads consulted
    ``max_prior``      max prior rows seeded into the surrogate
    ``max_distance``   workload-distance cutoff: beyond it a workload is
                       not a neighbor and contributes nothing
    ``keep_fraction``  fraction of an over-asked batch actually measured
    ``decay_evals``    real observations after which the prior retires
    ``guard_evals``    finite real observations before the
                       negative-transfer agreement check runs
    """

    corpus_path: Optional[str] = None
    job_id: Optional[str] = None
    warm_start: bool = True
    prefilter: bool = True
    k_neighbors: int = 3
    max_prior: int = 32
    max_distance: float = 0.35
    keep_fraction: float = 0.4
    decay_evals: int = 24
    guard_evals: int = 3

    def __bool__(self) -> bool:
        # ``if config.transfer:`` means "is transfer configured", matching
        # the MultiFidelityConfig convention
        return self.corpus_path is not None

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "TransferConfig":
        if d is None:
            return cls()
        _check_keys(d, {f.name for f in fields(cls)}, "TransferConfig")
        return cls(**d)


#: where each pre-v2 flat TunerConfig knob lives now (drives from_dict's
#: error hints and the constructor's backward-compatible keyword shim)
_LEGACY_FLAT_HINTS = {
    "parallelism": "executor.parallelism",
    "batch_size": "executor.batch_size",
    "executor_backend": "executor.backend",
    "workers": "executor.workers",
    "eval_timeout": "executor.eval_timeout",
    "memo_cache_path": "executor.memo_cache_path",
    "mf_eta": "multi_fidelity.eta",
    "mf_min_fidelity": "multi_fidelity.min_fidelity",
    "mf_promote_quantile": "multi_fidelity.promote_quantile",
    "mf_preempt": "multi_fidelity.preempt",
}


class TunerConfig:
    """Tuner configuration, v2: nested sub-configs instead of a flat knob
    pile.  Execution knobs live in :class:`ExecutorConfig` (``executor=``)
    and successive-halving knobs in :class:`MultiFidelityConfig`
    (``multi_fidelity=``, which also accepts a plain bool).

    ``from_dict``/``to_dict`` are the JSON contract the tuning service
    validates job submissions against: unknown keys raise ``ValueError``
    naming them (nothing is silently dropped).

    The pre-v2 flat spellings (``parallelism=``, ``mf_eta=``, ...) are
    still accepted as constructor keywords and readable/writable as
    attributes — they delegate to the nested sub-configs, so the two
    spellings can never disagree.  ``from_dict`` accepts only the v2
    schema and names the new home of any flat key it rejects.
    """

    def __init__(self, algorithm: str = "bo",
                 budget: int = 50,  # paper: tuning iterations capped at 50
                 seed: int = 0,
                 checkpoint_path: Optional[str] = None,
                 engine_kwargs: Optional[dict] = None,
                 verbose: bool = True,
                 loop: str = "async",  # async (completion-driven) |
                 # batch (legacy barrier)
                 wall_clock_budget: Optional[float] = None,  # secs;
                 # unfinished work is abandoned at the deadline (forces a
                 # pool backend unless overridden)
                 cost_aware: bool = False,  # BO: EI-per-second acquisition
                 executor: Optional[ExecutorConfig] = None,
                 multi_fidelity: Union[MultiFidelityConfig, bool] = False,
                 transfer: Optional[TransferConfig] = None,
                 **legacy):
        self.algorithm = algorithm
        self.budget = budget
        self.seed = seed
        self.checkpoint_path = checkpoint_path
        self.engine_kwargs = dict(engine_kwargs or {})
        self.verbose = verbose
        self.loop = loop
        self.wall_clock_budget = wall_clock_budget
        self.cost_aware = cost_aware
        self.executor = executor if executor is not None else ExecutorConfig()
        self.multi_fidelity = (multi_fidelity if isinstance(
            multi_fidelity, MultiFidelityConfig)
            else MultiFidelityConfig(enabled=bool(multi_fidelity)))
        self.transfer = transfer if transfer is not None else TransferConfig()
        unknown = sorted(set(legacy) - set(_LEGACY_FLAT_HINTS))
        if unknown:
            raise TypeError(f"TunerConfig got unexpected keyword(s) {unknown}")
        for k, v in legacy.items():  # flat v1 spellings -> nested homes
            setattr(self, k, v)

    def to_dict(self) -> dict:
        return {
            "algorithm": self.algorithm, "budget": self.budget,
            "seed": self.seed, "checkpoint_path": self.checkpoint_path,
            "engine_kwargs": dict(self.engine_kwargs),
            "verbose": self.verbose, "loop": self.loop,
            "wall_clock_budget": self.wall_clock_budget,
            "cost_aware": self.cost_aware,
            "executor": self.executor.to_dict(),
            "multi_fidelity": self.multi_fidelity.to_dict(),
            "transfer": self.transfer.to_dict(),
        }

    _TOP_LEVEL_KEYS = ("algorithm", "budget", "seed", "checkpoint_path",
                       "engine_kwargs", "verbose", "loop",
                       "wall_clock_budget", "cost_aware", "executor",
                       "multi_fidelity", "transfer")

    @classmethod
    def from_dict(cls, d: dict) -> "TunerConfig":
        _check_keys(d, cls._TOP_LEVEL_KEYS, "TunerConfig")
        kw = {k: v for k, v in d.items()
              if k not in ("executor", "multi_fidelity", "transfer")}
        return cls(executor=ExecutorConfig.from_dict(d.get("executor") or {}),
                   multi_fidelity=MultiFidelityConfig.from_dict(
                       d.get("multi_fidelity", False)),
                   transfer=TransferConfig.from_dict(d.get("transfer")),
                   **kw)

    def __repr__(self) -> str:
        return f"TunerConfig({self.to_dict()!r})"

    def __eq__(self, other) -> bool:
        return (isinstance(other, TunerConfig)
                and self.to_dict() == other.to_dict())

    # -- flat v1 attribute compatibility (delegates to the sub-configs) ------
    parallelism = property(
        lambda s: s.executor.parallelism,
        lambda s, v: setattr(s.executor, "parallelism", v))
    batch_size = property(
        lambda s: s.executor.batch_size,
        lambda s, v: setattr(s.executor, "batch_size", v))
    executor_backend = property(
        lambda s: s.executor.backend,
        lambda s, v: setattr(s.executor, "backend", v))
    workers = property(
        lambda s: s.executor.workers,
        lambda s, v: setattr(s.executor, "workers", v))
    eval_timeout = property(
        lambda s: s.executor.eval_timeout,
        lambda s, v: setattr(s.executor, "eval_timeout", v))
    memo_cache_path = property(
        lambda s: s.executor.memo_cache_path,
        lambda s, v: setattr(s.executor, "memo_cache_path", v))
    mf_eta = property(
        lambda s: s.multi_fidelity.eta,
        lambda s, v: setattr(s.multi_fidelity, "eta", v))
    mf_min_fidelity = property(
        lambda s: s.multi_fidelity.min_fidelity,
        lambda s, v: setattr(s.multi_fidelity, "min_fidelity", v))
    mf_promote_quantile = property(
        lambda s: s.multi_fidelity.promote_quantile,
        lambda s, v: setattr(s.multi_fidelity, "promote_quantile", v))
    mf_preempt = property(
        lambda s: s.multi_fidelity.preempt,
        lambda s, v: setattr(s.multi_fidelity, "preempt", v))


class Tuner:
    def __init__(
        self,
        objective: Callable[[Dict], float],
        space: SearchSpace,
        config: TunerConfig = TunerConfig(),
        executor: Optional[EvaluationExecutor] = None,
    ):
        self.objective = as_evaluator(objective)
        self.space = space
        self.config = config
        #: cooperative cancellation (the tuning service's ``cancel_job``):
        #: every loop checks this between completions and exits cleanly —
        #: recorded history and checkpoints stay intact, in-flight work is
        #: abandoned exactly like a wall-clock expiry
        self._stop = threading.Event()
        if config.algorithm not in ENGINES:
            raise ValueError(
                f"unknown algorithm {config.algorithm!r}; one of {sorted(ENGINES)}"
            )
        if config.loop not in LOOPS:
            raise ValueError(f"unknown loop {config.loop!r}; one of {LOOPS}")
        engine_kwargs = dict(config.engine_kwargs)
        if config.cost_aware:
            if config.algorithm != "bo":
                raise ValueError(
                    "cost_aware acquisition is a BayesOpt feature "
                    f"(algorithm={config.algorithm!r})")
            engine_kwargs.setdefault("cost_aware", True)
        if config.multi_fidelity:
            if config.loop != "async":
                raise ValueError(
                    "multi_fidelity requires the completion-driven loop "
                    f"(loop={config.loop!r}): rung promotion and preemption "
                    "are decided per completion, which a batch barrier "
                    "cannot express")
            from repro_torch.tuning.schedulers import SCHEDULER_KINDS
            if getattr(config.multi_fidelity,
                       "scheduler", "asha") not in SCHEDULER_KINDS:
                raise ValueError(
                    f"unknown multi_fidelity.scheduler "
                    f"{config.multi_fidelity.scheduler!r}; "
                    f"one of {SCHEDULER_KINDS}")
            if config.algorithm == "bo":
                # partial observations enter the surrogate with a fidelity
                # feature, never as exact values
                engine_kwargs.setdefault("fidelity_feature", True)
        # -- transfer learning: resolve the corpus + prior BEFORE the engine
        # is constructed, so the warm-start prior can enter its kwargs.  No
        # corpus configured -> corpus is None, nothing below runs, and the
        # engine/executor construction is byte-identical to the historical
        # path.
        tr = config.transfer
        corpus = (getattr(executor, "corpus", None)
                  if executor is not None else None)
        if corpus is None and tr:
            from repro_torch.tuning.corpus import TuningCorpus
            corpus = TuningCorpus(tr.corpus_path, job_id=tr.job_id)
        self.corpus = corpus
        self._transfer_prior: Optional[TransferPrior] = None
        if corpus is not None:
            corpus.describe_job(self.objective, space)
            rows = corpus.prior_observations(
                space, corpus.descriptor["features"],
                k=tr.k_neighbors, max_rows=tr.max_prior,
                max_distance=tr.max_distance)
            if rows:
                self._transfer_prior = TransferPrior.from_rows(space, rows)
                if tr.warm_start and config.algorithm == "bo":
                    engine_kwargs.setdefault("transfer_prior",
                                             self._transfer_prior)
                    engine_kwargs.setdefault("transfer_decay", tr.decay_evals)
                    engine_kwargs.setdefault("transfer_guard_n",
                                             tr.guard_evals)
        self.engine: Engine = ENGINES[config.algorithm](
            space, seed=config.seed, **engine_kwargs
        )
        # corpus pre-filter (all prefilter_safe engines): guard state is
        # independent of the BO-internal prior guard
        self._prefilter_on = (bool(tr) and tr.prefilter
                              and self._transfer_prior is not None
                              and getattr(ENGINES[config.algorithm],
                                          "prefilter_safe", True))
        self._prefilter_checked = False
        if executor is not None:
            # the tuning service multiplexes many jobs over one shared
            # worker fleet: each job's Tuner gets a pre-built executor
            # (wrapping the shared pool) instead of constructing its own
            self.executor = executor
            if corpus is not None and getattr(executor, "corpus", None) is None:
                # service-injected executors are per-job: attach the
                # corpus so their finalized measurements are recorded
                executor.corpus = corpus
        else:
            backend = config.executor.backend
            if backend is None and config.executor.workers:
                backend = "remote"
            if backend is None and config.wall_clock_budget is not None:
                # the serial backend cannot abandon a running evaluation, so
                # a wall-clock budget needs a pool even at parallelism=1
                backend = "thread"
            self.executor = EvaluationExecutor(
                self.objective, space,
                parallelism=config.executor.parallelism,
                backend=backend,
                timeout=config.executor.eval_timeout,
                cache_path=config.executor.memo_cache_path,
                workers=config.executor.workers,
                corpus=corpus,
                # elastic-fleet knobs only reach a pool we build ourselves;
                # local backends never see them (byte-identical traces)
                fleet=(config.executor.fleet_options()
                       if backend == "remote" else None),
            )
        self.history = History(space)
        self.rung_scheduler = None  # set by the multi-fidelity loop
        if config.checkpoint_path and pathlib.Path(config.checkpoint_path).exists():
            self._resume(config.checkpoint_path)

    def _resume(self, path: str) -> None:
        """Fault tolerance: reload history + replay it into the engine.

        A checkpoint only ever contains completed evaluations (points
        still in flight when the run died are excluded from
        ``History.save``), so resuming mid-stream simply re-evaluates
        whatever had not finished — or pulls it straight from the
        disk-backed memo cache if it completed after the checkpoint.

        Replay goes through ``tell`` (one call with the whole trace), not
        raw per-point ``observe``: engines with speculative batches
        (Nelder-Mead) buffer the results and consume only the points
        their state machine actually reaches, in order — feeding
        unconsumed speculative probes into ``observe`` would corrupt the
        state machine.
        """
        loaded = History.load(path, self.space)
        obs = loaded.observations()
        self.history.add_observations(obs)
        self.engine.tell(obs)
        if self.config.verbose and len(loaded):
            print(f"[tuner] resumed {len(loaded)} evaluations from {path}")

    # -- shared helpers ------------------------------------------------------
    def _report(self, r: EvalResult) -> None:
        if not self.config.verbose:
            return
        best = (self.history.best().value
                if any(math.isfinite(e.value) for e in self.history.evals)
                else float("nan"))
        print(
            f"[tuner:{self.engine.name}] it={len(self.history):3d} "
            f"y={r.value:.4g} best={best:.4g} "
            f"({r.cost_seconds:.1f}s) {r.point}"
        )

    def _record(self, r: EvalResult, fidelity: float = 1.0,
                rung: Optional[int] = None,
                lineage: Optional[str] = None) -> None:
        """tell + append + checkpoint for one completed evaluation."""
        obs = Observation(point=r.point, value=r.value,
                          cost_seconds=r.cost_seconds, fidelity=fidelity,
                          rung=rung, lineage=lineage, meta=r.meta)
        self.engine.tell([obs])
        self.history.add_observations([obs])
        if self.config.checkpoint_path:
            self.history.save(self.config.checkpoint_path)
        self._report(r)

    def _ask_filtered(self, want: int, history: History) -> List[Dict]:
        """Engine ask, routed through the corpus pre-filter when active.

        With transfer configured and a prior available, the engine is
        over-asked by ``1/keep_fraction`` and only the candidates the
        neighbor-workload observations rank highest are measured — the
        corpus-trained pre-filter that works for *every* engine that
        declares ``prefilter_safe`` (AutoTVM-style: spend measurements
        only on candidates history says are promising).  Inactive (no
        corpus, unsafe engine, prior retired or guard-tripped), this is
        exactly ``engine.ask``.
        """
        tr = self.config.transfer
        prior = self._transfer_prior
        if (not self._prefilter_on or prior is None or want <= 0
                or len(history) >= tr.decay_evals):
            return self.engine.ask(want, history)
        # negative-transfer guard, independent of BO's internal one: stop
        # filtering permanently if the prior mis-ranks real measurements
        if not self._prefilter_checked:
            X, y = history.encoded()
            finite = np.isfinite(y)
            if int(finite.sum()) >= tr.guard_evals:
                self._prefilter_checked = True
                from repro_torch.tuning.corpus import prediction_agreement
                agree = prediction_agreement(prior.predict(X[finite]),
                                             y[finite])
                if agree is not None and agree < 0.0:
                    self._prefilter_on = False
                    return self.engine.ask(want, history)
        ask_n = max(want, math.ceil(want / max(tr.keep_fraction, 1e-9)))
        cands = self.engine.ask(ask_n, history)
        if len(cands) <= want:
            return cands
        # an engine that padded the tail of an exhausted candidate pool
        # with unranked random fills reports the ranked head via
        # ``last_ask_ranked`` (warm-started BO): only the head competes
        # under the prior's score, so a random fill scored by the same
        # prior can never displace a candidate the engine actually
        # ranked — fills may only top up a deficit, in engine order
        ranked_n = getattr(self.engine, "last_ask_ranked", None)
        if ranked_n is None or not 0 <= ranked_n <= len(cands):
            ranked_n = len(cands)
        if ranked_n <= want:
            return cands[:want]  # whole ranked head survives + fills
        scores = prior.predict(self.space.encode_many(cands[:ranked_n]))
        top = np.argsort(-scores, kind="stable")[:want]
        # keep the engine's own proposal order among survivors (for BO
        # that is acquisition-descending)
        return [cands[i] for i in sorted(top.tolist())]

    def _wall_clock_exhausted(self, wall_clock: Optional[float]) -> None:
        if self.config.verbose:
            print(f"[tuner:{self.engine.name}] wall-clock budget "
                  f"({wall_clock:.1f}s) exhausted at "
                  f"{len(self.history)} evaluations")

    # -- cooperative cancellation (tuning service: cancel_job) ---------------
    def request_stop(self) -> None:
        """Ask a running ``run()`` to exit at the next completion.

        Thread-safe and idempotent.  Everything recorded so far stays
        recorded (and checkpointed); in-flight measurements are abandoned
        unrecorded, exactly like a wall-clock expiry, so a stopped run can
        later be resumed from its checkpoint without loss."""
        self._stop.set()

    @property
    def stop_requested(self) -> bool:
        return self._stop.is_set()

    # -- completion-driven loop (default) ------------------------------------
    def _run_async(self, budget: int, wall_clock: Optional[float]) -> History:
        t_start = time.time()
        deadline = t_start + wall_clock if wall_clock is not None else None
        outstanding: List[PendingEval] = []
        try:
            while len(self.history) < budget and not self._stop.is_set():
                if deadline is not None and time.time() >= deadline:
                    self._wall_clock_exhausted(wall_clock)
                    break
                # refill: one ask per free worker slot, the moment it frees
                # (executor.parallelism, not config: the remote backend's
                # capacity is the fleet's registered slot total)
                capacity = self.executor.parallelism - len(outstanding)
                want = min(capacity,
                           budget - len(self.history) - len(outstanding))
                asked_any = False
                if want > 0:
                    if deadline is not None:  # budget pressure -> cost-aware BO
                        self.engine.note_budget(
                            max(0.0, (deadline - time.time()) / wall_clock))
                    points = self._ask_filtered(want, self.history)
                    asked_any = bool(points)
                    submitted = []
                    for p in points[:want]:
                        cached = self.history.lookup(p)
                        if cached is not None:
                            # memoized repeat query: free, told immediately
                            self._record(EvalResult(dict(p), cached.value,
                                                    0.0, {"memoized": True}))
                            continue
                        if self.history.pending(p):
                            continue  # its measurement is already in flight
                        submitted.append(p)
                    if submitted:
                        self.history.mark_inflight(submitted)
                        outstanding.extend(self.executor.submit(submitted))
                if len(self.history) >= budget:
                    break
                if not outstanding:
                    if not asked_any:
                        break  # engine has nothing left to propose
                    continue  # asks were all memo hits; go ask again
                done = self.executor.next_completed(outstanding,
                                                    deadline=deadline)
                if done is None:  # deadline passed while waiting
                    self._wall_clock_exhausted(wall_clock)
                    break
                outstanding.remove(done)
                self._record(done.result())
        finally:
            # abandoned in-flight points (wall-clock expiry / hard abort)
            # must not leave stale pending marks behind; anything still
            # marked here is by definition unmeasured (add() unmarks on
            # completion), so clearing the whole set is exact
            self.history.clear_inflight()
        return self.history

    # -- multi-fidelity successive-halving loop ------------------------------
    def _run_multi_fidelity(self, budget: int,
                            wall_clock: Optional[float]) -> History:
        """Completion-driven ASHA on top of the async machinery.

        Fresh engine candidates enter at the bottom rung (cheap partial
        measurements); completions in the top ``1/mf_eta`` of their rung
        are resubmitted at the next fidelity the moment a worker frees,
        and in-flight promotions whose source rung has since outclassed
        them are preempted (cancelled when still queued; recorded
        normally when a worker already started — exactly-once either
        way).  ``budget`` counts full-measurement *equivalents*: the sum
        of completed fidelities, so ``budget=50`` spends what 50 full
        measurements would have.

        Every completion — partial or full — lands in history with its
        fidelity and is told to the engine (BO reads the fidelity column
        as a surrogate feature; ranking engines use partial values as
        ASHA does).  ``history.best(full_fidelity_only=True)`` is the
        trustworthy incumbent.

        An objective without fidelity support cannot cheapen a
        measurement, so for the *ladder* schedulers (asha, hyperband)
        rungs would all cost the same and "promotion" would just
        re-measure points: those degenerate to the plain
        completion-driven loop.  PBT is not a ladder — its steps measure
        *mutating* points (optionally warm-started via checkpoint-fork),
        so it runs regardless of fidelity support.
        """
        from repro_torch.tuning.schedulers import build_scheduler

        cfg = self.config
        mf = cfg.multi_fidelity
        kind = getattr(mf, "scheduler", "asha") or "asha"
        if (kind != "pbt"
                and not getattr(self.objective, "supports_fidelity", False)):
            if self.config.verbose:
                print("[tuner] objective has no fidelity support; "
                      "multi_fidelity degenerates to the async loop")
            return self._run_async(budget, wall_clock)

        sched = build_scheduler(mf, space=self.space, seed=cfg.seed)
        # observability (bench/service stats).  The attribute name
        # predates the scheduler zoo; it now holds whichever
        # TrialScheduler drives the run.
        self.rung_scheduler = sched
        t_start = time.time()
        deadline = t_start + wall_clock if wall_clock is not None else None
        outstanding: List[PendingEval] = []
        spend = 0.0  # full-measurement equivalents consumed
        # checkpoint resume: rebuild scheduler state (rung results AND
        # promotion marks for the ladders, population/lineages for PBT —
        # see each scheduler's ``replay``) and budget accounting from the
        # replayed history.  The scheduler owns the charge: duplicates
        # and preempted placeholders replay at 0.0 spend.
        for e in self.history.evals:
            spend += sched.replay(
                self.space.key(e.point), e.point, e.value, e.fidelity,
                rung=getattr(e, "rung", None),
                lineage=getattr(e, "lineage", None), meta=e.meta)

        def consume(done: PendingEval) -> None:
            nonlocal spend
            r = done.result()
            if r.meta.get("preempted"):
                return  # cancelled pre-start: nothing was measured
            rung = done.rung if done.rung is not None else 0
            # budget and history record what was *delivered*, not what the
            # rung asked for: the executor upgrades requests the evaluator
            # cannot serve partially (meta["fidelity"] / a normalized
            # pending fidelity say so) and those must be charged — and
            # trusted — as full measurements
            fid = r.meta.get("fidelity")
            if fid is None:
                fid = 1.0 if done.fidelity is None else done.fidelity
            fid = float(fid)
            spend += fid  # memo hits count too: budget is logical spend
            sched.on_result(self.space.key(done.point), done.point,
                            r.value, rung, fidelity=fid, meta=r.meta,
                            lineage=done.lineage)
            self._record(r, fidelity=fid, rung=rung, lineage=done.lineage)

        def dispatch(act) -> PendingEval:
            pend = self.executor.submit(
                [act.point], fidelity=act.fidelity, rung=act.rung,
                state=act.state, lineage=act.lineage)[0]
            sched.on_started(self.space.key(act.point), act.point, act.rung,
                             lineage=act.lineage)
            outstanding.append(pend)
            return pend

        try:
            while spend < budget and not self._stop.is_set():
                if deadline is not None and time.time() >= deadline:
                    self._wall_clock_exhausted(wall_clock)
                    break
                capacity = self.executor.parallelism - len(outstanding)
                submitted_any = False
                # scheduler-driven work outranks fresh probes for free
                # workers: a survivor's next rung (or a PBT member's next
                # step/fork) is the highest-value measurement the policy
                # currently knows how to ask for
                while capacity > 0:
                    act = sched.next_action()
                    if act is None:
                        break
                    dispatch(act)
                    capacity -= 1
                    submitted_any = True
                fresh = min(capacity, sched.fresh_quota(capacity))
                if fresh > 0:
                    if deadline is not None:
                        self.engine.note_budget(
                            max(0.0, (deadline - time.time()) / wall_clock))
                    points = self._ask_filtered(fresh, self.history)
                    for p in points[:fresh]:
                        if self.history.seen(p) or self.history.pending(p):
                            continue  # known at some rung / already in flight
                        act = sched.admit(self.space.key(p), p)
                        if act is None:
                            continue  # refused (e.g. PBT population full)
                        dispatch(act)
                        self.history.mark_inflight([p])
                        submitted_any = True
                # preemption scan: work the scheduler has since declared
                # pointless — an ASHA/HyperBand promotion whose source-rung
                # value fell below the current cutoff, a PBT step of a
                # culled member — cannot win anything by finishing
                if mf.preempt:
                    for pend in list(outstanding):
                        if (pend.preempted or pend.done()
                                or sched.decide(self.space.key(pend.point),
                                                pend.rung or 0,
                                                lineage=pend.lineage)
                                != "preempt"):
                            continue
                        if self.executor.preempt(pend) == "cancelled":
                            outstanding.remove(pend)
                            sched.on_preempted(self.space.key(pend.point),
                                               pend.rung or 0,
                                               lineage=pend.lineage)
                        # "running": the worker got there first; its
                        # result arrives and is recorded normally
                if not outstanding:
                    if not submitted_any:
                        break  # engine exhausted, no promotions possible
                    continue
                done = self.executor.next_completed(outstanding,
                                                    deadline=deadline)
                if done is None:
                    self._wall_clock_exhausted(wall_clock)
                    break
                outstanding.remove(done)
                consume(done)
            # drain: promotions are event-driven, so the loop can have
            # dispatched slightly past the logical budget — those
            # measurements are paid for and must be recorded (exactly-once
            # accounting), never silently dropped.  A wall-clock deadline
            # still wins: past it, next_completed abandons as usual; a
            # stop request likewise abandons the drain (cancel semantics
            # match wall-clock expiry: in-flight work is re-measured by a
            # resumed run, never lost from the record).
            while outstanding and not self._stop.is_set():
                done = self.executor.next_completed(outstanding,
                                                    deadline=deadline)
                if done is None:
                    break  # deadline: in-flight work is abandoned unrecorded
                outstanding.remove(done)
                consume(done)
        finally:
            self.history.clear_inflight()
        return self.history

    # -- legacy batch-barrier loop -------------------------------------------
    def _evaluate_batch(self, points: List[Dict],
                        deadline: Optional[float] = None) -> List[EvalResult]:
        """History-memoized repeats are free; the rest go to the executor."""
        results: List[Optional[EvalResult]] = [None] * len(points)
        miss_idx, miss_points = [], []
        for i, p in enumerate(points):
            cached = self.history.lookup(p)
            if cached is not None:  # memoized repeat query (engines may revisit)
                results[i] = EvalResult(dict(p), cached.value, 0.0,
                                        {"memoized": True})
            else:
                miss_idx.append(i)
                miss_points.append(p)
        if miss_points:
            for i, r in zip(miss_idx,
                            self.executor.evaluate(miss_points,
                                                   deadline=deadline)):
                results[i] = r
        return results

    def _run_batch(self, budget: int, wall_clock: Optional[float]) -> History:
        batch_size = (self.config.executor.batch_size
                      or max(1, self.executor.parallelism))
        t_start = time.time()
        deadline = t_start + wall_clock if wall_clock is not None else None
        while len(self.history) < budget and not self._stop.is_set():
            if deadline is not None and time.time() >= deadline:
                self._wall_clock_exhausted(wall_clock)
                break
            if deadline is not None:  # budget pressure -> cost-aware BO
                self.engine.note_budget(
                    max(0.0, (deadline - time.time()) / wall_clock))
            points = self._ask_filtered(
                min(batch_size, budget - len(self.history)), self.history)
            if not points:
                break  # engine has nothing left to propose
            self.history.mark_inflight(points)
            try:
                results = self._evaluate_batch(points, deadline=deadline)
            finally:
                self.history.clear_inflight(points)
            # a None slot was abandoned at the wall-clock deadline: it was
            # never measured, so it enters neither the engine nor history
            done = [(p, r) for p, r in zip(points, results) if r is not None]
            if done:
                rs = [r for _, r in done]
                obs = [Observation(point=p, value=r.value,
                                   cost_seconds=r.cost_seconds, meta=r.meta)
                       for p, r in done]
                self.engine.tell(obs)
                self.history.add_observations(obs)
                if self.config.checkpoint_path:
                    self.history.save(self.config.checkpoint_path)
                if self.config.verbose:
                    for r in rs:
                        self._report(r)
        return self.history

    def run(self, budget: Optional[int] = None,
            wall_clock: Optional[float] = None) -> History:
        budget = budget if budget is not None else self.config.budget
        wall_clock = (wall_clock if wall_clock is not None
                      else self.config.wall_clock_budget)
        if (wall_clock is not None and self.executor.backend == "serial"
                and self.config.executor.backend is None):
            # a wall-clock budget supplied at run() time needs the same
            # pool fallback __init__ applies for a configured one: the
            # serial backend cannot abandon a running evaluation.  The
            # memo cache (and its disk store) carries over.
            old = self.executor
            self.executor = EvaluationExecutor(
                self.objective, self.space,
                parallelism=self.config.executor.parallelism,
                backend="thread",
                timeout=self.config.executor.eval_timeout, cache=old.cache,
                corpus=getattr(old, "corpus", None))
            old.close()
        if self.config.multi_fidelity:
            return self._run_multi_fidelity(budget, wall_clock)
        if self.config.loop == "batch":
            return self._run_batch(budget, wall_clock)
        return self._run_async(budget, wall_clock)

    def close(self) -> None:
        self.executor.close()
