"""Loss + train step with microbatched gradient accumulation.

``microbatches`` (the paper's ``batch_size`` analogue in the tuning space)
splits the per-step batch into k sequential microbatches, a python loop
where the reference scans; gradients accumulate in fp32 and are divided by
k once, after the loop.  Each microbatch's forward and backward is one
``trace_hooks.repeat`` call, so that the dry run traces two microbatches
whatever their number.

The forward runs the hand-written kernels where the runtime selects them
(``attn_impl="cuda"``); each kernel's backward recomputes through its
oracle (``kernels/ops.py``, ``_RefVJP``), as the reference pairs its Pallas
forwards with an oracle backward.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.ops import with_db
from repro_torch.models.model import Model
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.models.runtime import Runtime
from repro_torch.optim.optimizer import OptimizerConfig, adamw_update
from repro_torch.runtime import trace_hooks

AUX_LOSS_WEIGHT = 0.01


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy in fp32.  logits (B,S,V), targets (B,S)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def make_loss_fn(model: Model, rt: Runtime):
    def loss_fn(params, batch: Dict[str, torch.Tensor]):
        logits, aux, _ = model.apply(params, batch, rt=rt, mode="full")
        ce = cross_entropy(logits, batch["targets"])
        loss = ce + AUX_LOSS_WEIGHT * aux
        return loss, {"loss": loss, "ce": ce, "aux": aux}

    return loss_fn


def _split_microbatches(batch: Dict[str, torch.Tensor], k: int):
    def sp(x):
        b = x.shape[0]
        if b % k:
            raise ValueError(f"batch of {b} does not split into {k} microbatches")
        return x.reshape(k, b // k, *x.shape[1:])

    return {name: sp(v) for name, v in batch.items()}


def value_and_grad(loss_fn, params, batch):
    """``((loss, metrics), grads)`` of ``loss_fn(params, batch)``, grads a
    tree like ``params``; the metrics are detached."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(live, batch)
    grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
    grads = tree_map(lambda _: next(grads), live)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), grads


def make_train_step(model: Model, opt_cfg: OptimizerConfig, rt: Runtime,
                    microbatches: int = 1, *, tuning_db=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``tuning_db`` attaches a :class:`~repro_torch.tuning.tundb.TuningDB`
    whose kernel configs the ops layer picks up from this build on;
    ``None`` leaves ``rt`` as it is.  The step is functional: it returns
    new trees and leaves its inputs as they were.
    """
    rt = with_db(rt, tuning_db)
    loss_fn = make_loss_fn(model, rt)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
        else:
            mb = _split_microbatches(batch, microbatches)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            outs = []
            for i in range(microbatches):
                out, g = trace_hooks.repeat(value_and_grad, loss_fn, params,
                                            {k: v[i] for k, v in mb.items()})
                grads = tree_map(lambda a, b: a + b.to(torch.float32), grads, g)
                outs.append(out)
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = torch.stack([o[0] for o in outs]).mean()
            metrics = {k: torch.stack([o[1][k] for o in outs]).mean()
                       for k in outs[0][1]}

        params, opt_state, opt_metrics = adamw_update(grads, opt_state, params,
                                                      opt_cfg)
        metrics = dict(metrics, **opt_metrics, loss_out=loss)
        return params, opt_state, metrics

    return train_step
