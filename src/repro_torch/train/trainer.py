"""Fault-tolerant training loop.

Wires together model / optimizer / data / checkpointer / straggler
detector.  Failure handling: a ``WorkerFailure`` raised during a step
rolls back to the last checkpoint, applies an ``ElasticPlan`` (dp shrinks,
tp preserved), rebuilds the step, and resumes from the restored step — the
deterministic data pipeline replays the identical stream.

A step's ``seconds`` is its real time on the device: the device is
synchronised before the clock is read at either end (the reference times
an asynchronous dispatch).  The trainer owns its params and optimizer
state, and its step updates them in place (``donate=True``), as the
reference's jitted step donates them.  On the card the step is one CUDA
graph (``make_graphed_train_step``: the first step eager, the second
captured, every later one a replay), as the reference jits it; after a
restore the trainer releases that graph and its memory pool, then builds
and captures the step again, as the reference re-jits.  The CPU step is
eager.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.models.model import build_model
from repro_torch.models.params import split_params
from repro_torch.models.runtime import Runtime
from repro_torch.optim.optimizer import OptimizerConfig, adamw_init
from repro_torch.runtime.fault_tolerance import (
    ElasticPlan,
    FailureInjector,
    StragglerDetector,
    WorkerFailure,
)
from repro_torch.train.train_step import make_graphed_train_step, make_train_step


@dataclass
class TrainerConfig:
    steps: int = 100
    checkpoint_every: int = 20
    checkpoint_dir: Optional[str] = None
    microbatches: int = 1
    log_every: int = 10
    seed: int = 0
    device: str = "cuda"  # where params, optimizer state and batches live


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        opt_cfg: OptimizerConfig,
        data_cfg: DataConfig,
        tcfg: TrainerConfig,
        rt: Runtime = Runtime(compute_dtype="f32"),
        failure_injector: Optional[FailureInjector] = None,
    ):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.data = SyntheticTokens(data_cfg)
        self.tcfg = tcfg
        self.rt = rt
        self.device = torch.device(tcfg.device)
        self.model = build_model(cfg)
        self.failures = failure_injector
        self.straggler = StragglerDetector()
        self.ckpt = (Checkpointer(tcfg.checkpoint_dir)
                     if tcfg.checkpoint_dir else None)
        self.metrics_log: List[Dict] = []
        self.events: List[str] = []

        gen = torch.Generator(device=self.device)
        gen.manual_seed(tcfg.seed)
        self.params, self.params_axes = split_params(self.model.init(gen))
        self.opt_state = adamw_init(self.params, opt_cfg)
        self._build_step()
        self.step = 0

    def _build_step(self):
        # re-reads the runtime's TuningDB, if it has one
        old = getattr(self, "_step_fn", None)
        if hasattr(old, "release"):  # the graph's pool, before another is captured
            self._step_fn = None
            old.release()
        make, kw = make_train_step, {"donate": True}
        if self.device.type == "cuda":
            make, kw = make_graphed_train_step, {}
        self._step_fn = make(self.model, self.opt_cfg, self.rt,
                             microbatches=self.tcfg.microbatches,
                             tuning_db=self.rt.tuning_db, **kw)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- checkpoint/restart ----------------------------------------------------
    def _save(self, metric: Optional[float] = None):
        if not self.ckpt:
            return
        self.ckpt.save(
            self.step,
            {"params": self.params, "opt": self.opt_state},
            metadata={"config": self.cfg.name},
            metric=metric,
        )

    def _restore(self):
        assert self.ckpt is not None, "failure without checkpointing enabled"
        like = {"params": self.params, "opt": self.opt_state}
        restored, meta = self.ckpt.restore(None, like)
        self.params, self.opt_state = restored["params"], restored["opt"]
        self.step = int(meta["step"])
        self.events.append(f"restored step {self.step}")

    # -- main loop ---------------------------------------------------------------
    def run(self) -> List[Dict]:
        last_metric = None
        if self.ckpt and self.ckpt.latest_step() is not None:
            self._restore()
        while self.step < self.tcfg.steps:
            batch_np = self.data.batch_at(self.step)
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in batch_np.items()}
            self._sync()
            t0 = time.perf_counter()
            try:
                if self.failures is not None:
                    self.failures.check(self.step)
                self.params, self.opt_state, metrics = self._step_fn(
                    self.params, self.opt_state, batch
                )
            except WorkerFailure as e:
                self.events.append(f"failure at step {e.step}")
                plan = ElasticPlan.after_failure(dp=2, tp=1,
                                                 lost_chips=e.failed_workers)
                self.events.append(
                    f"elastic rescale dp {plan.old_dp}->{plan.new_dp}"
                )
                self._restore()
                self._build_step()  # rebuild for the (new) topology
                continue
            self._sync()
            dt = time.perf_counter() - t0
            if self.straggler.update(dt):
                self.events.append(f"straggler flagged at step {self.step}")
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics.update(step=self.step, seconds=dt)
            self.metrics_log.append(metrics)
            last_metric = -metrics["loss"]
            if self.tcfg.log_every and self.step % self.tcfg.log_every == 0:
                print(f"[train] step {self.step:5d} loss {metrics['loss']:.4f} "
                      f"({dt*1e3:.0f} ms)")
            self.step += 1
            if self.ckpt and self.step % self.tcfg.checkpoint_every == 0:
                self._save(metric=last_metric)
        if self.ckpt:
            self._save(metric=last_metric)
            self.ckpt.wait()
        return self.metrics_log
