"""The paper's primary contribution: gradient-free auto-tuning of backend
parameters for training/inference throughput — BO (GP + SMSego), GA, and
Nelder-Mead simplex behind a common engine interface (paper Fig. 4).

Engines speak the ask/tell contract (``engine.ask(n, history)`` ->
deduplicated candidate batch; ``engine.tell(observations)`` feeds
:class:`Observation` records back, incrementally and in completion
order) and the
:class:`Tuner` drives them through a completion-driven scheduler over
the parallel evaluation executor (``repro_torch.tuning.executor``) under an
iteration budget, a wall-clock budget, or both — with an optional
disk-backed memo cache so repeated runs re-evaluate nothing.
``parallelism=1`` reproduces the paper's sequential
one-point-per-iteration harness bit-for-bit.

BO runs a GP surrogate in PyTorch (``repro_torch.core.gp``) on an explicit
device, ``"cpu"`` unless the caller passes another: warm-started
hyperparameter refits and a fused acquisition ranking, with the time of
every suggestion kept on ``BayesOpt.ask_seconds``.
``TunerConfig(cost_aware=True)`` switches BO to EI-per-second, trading
improvement against a per-candidate predicted measurement cost and
sharpening the preference for cheap probes as ``wall_clock_budget`` nears
exhaustion.  ``TunerConfig(transfer=TransferConfig(...))`` records every
measurement into a cross-job corpus (``repro_torch.tuning.corpus``) and
warm-starts BO from neighbouring workloads."""
from repro_torch.core.bayesopt import BayesOpt, TransferPrior
from repro_torch.core.engine import Engine
from repro_torch.core.exhaustive import Exhaustive
from repro_torch.core.genetic import GeneticAlgorithm
from repro_torch.core.gp import GaussianProcess
from repro_torch.core.history import History
from repro_torch.core.neldermead import NelderMead
from repro_torch.core.observation import Observation
from repro_torch.core.random_search import RandomSearch
from repro_torch.core.space import CatDim, IntDim, SearchSpace
from repro_torch.core.tuner import (ENGINES, ExecutorConfig, HyperBandConfig,
                                    MultiFidelityConfig, PBTConfig,
                                    TransferConfig, Tuner, TunerConfig)

__all__ = [
    "BayesOpt", "CatDim", "ENGINES", "Engine", "ExecutorConfig",
    "Exhaustive", "GaussianProcess", "GeneticAlgorithm", "History",
    "HyperBandConfig", "IntDim", "MultiFidelityConfig", "NelderMead",
    "Observation", "PBTConfig", "RandomSearch", "SearchSpace",
    "TransferConfig", "TransferPrior", "Tuner", "TunerConfig",
]
