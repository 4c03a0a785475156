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

``make_graphed_train_step`` is the trainer's step on the card, the
counterpart of the reference's ``jax.jit(step_fn, donate_argnums=(0, 1))``:
forward, backward and the donated AdamW update captured once into a CUDA
graph and replayed a step.
"""
from __future__ import annotations

import gc
from typing import Dict

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import shard_hint
from repro_torch.kernels.ops import with_db
from repro_torch.models.model import Model
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.models.runtime import Runtime
from repro_torch.optim.optimizer import OptimizerConfig, adamw_update
from repro_torch.runtime import trace_hooks
from repro_torch.runtime.graphs import GraphedStep, tensors

AUX_LOSS_WEIGHT = 0.01


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy in fp32.  logits (B,S,V), targets (B,S)."""
    logits = logits.to(torch.float32)
    if isinstance(logits, DTensor):
        return _vocab_parallel_cross_entropy(logits, targets)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def _vocab_parallel_cross_entropy(logits, targets):
    """``cross_entropy`` of logits placed on a mesh, their vocab perhaps
    sharded (Megatron's vocab-parallel form): the max and the sum of
    exponentials are reduced over the vocab shards, and each device takes
    the target's logit from its own shard (zero where the target lies in
    another), the partial sums reduced.  DTensor's own ``logsumexp``
    gathers the vocab, and the backward of its ``gather`` allocates the
    global logits on every device."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    logits = shard_hint(logits, ("batch", None, "vocab"))  # no partial sum left
    tok = ("batch", None, None)  # one value a token
    m = shard_hint(logits.detach().amax(dim=-1, keepdim=True), tok)
    lse = m + torch.log(shard_hint(torch.exp(logits - m).sum(dim=-1, keepdim=True), tok))

    mesh, pl = logits.device_mesh, tuple(logits.placements)
    vocab = lambda p: isinstance(p, Shard) and p.dim == 2
    if not isinstance(targets, DTensor):
        targets = DTensor.from_local(targets, mesh, [Replicate()] * mesh.ndim,
                                     run_check=False)
    t = targets.redistribute(mesh, [Replicate() if vocab(p) else p for p in pl]).to_local()
    local = logits.to_local()
    first = compute_local_shape_and_global_offset(logits.shape, mesh, pl)[1][2]
    n = local.shape[-1]
    idx = t.long() - first
    mine = (idx >= 0) & (idx < n)
    gold = torch.gather(local, -1, idx.clamp(0, n - 1)[..., None]) * mine[..., None]
    gold = DTensor.from_local(gold, mesh, [Partial() if vocab(p) else p for p in pl],
                              shape=lse.shape, stride=lse.stride(), run_check=False)
    return torch.mean(shard_hint(lse - gold, tok))


def make_loss_fn(model: Model, rt: Runtime):
    def loss_fn(params, batch: Dict[str, torch.Tensor]):
        logits, aux, _ = model.apply(params, batch, rt=rt, mode="full")
        ce = cross_entropy(logits, batch["targets"])
        loss = ce + AUX_LOSS_WEIGHT * aux
        return loss, {"loss": loss, "ce": ce, "aux": aux}

    return loss_fn


def _split_microbatches(batch: Dict[str, torch.Tensor], k: int):
    """Each input as ``(k, b // k, ...)``.  Placed on a mesh, each device
    splits its own rows (a microbatch takes ``1/k`` of every shard, not a
    contiguous ``1/k`` of the batch: the mean over all microbatches is the
    same, and no rows move between devices)."""
    def sp(x):
        b = x.shape[0]
        if isinstance(x, DTensor):
            return _split_placed(x, k)
        if b % k:
            raise ValueError(f"batch of {b} does not split into {k} microbatches")
        return x.reshape(k, b // k, *x.shape[1:])

    return {name: sp(v) for name, v in batch.items()}


class MicrobatchSplitError(ValueError):
    """A placed batch whose per-device rows the microbatch count does not
    divide.  The reference splits the global batch and lets GSPMD lay out
    the microbatches; the port splits each device's rows, so such a point
    (``dp * microbatches`` above the batch) cannot be laid out here."""


def _split_placed(x: DTensor, k: int) -> DTensor:
    from torch.distributed.tensor import Shard

    local = x.to_local()
    bl = local.shape[0]
    if bl % k:
        raise MicrobatchSplitError(
            f"a device's batch of {bl} does not split into {k} microbatches")
    pl = [Shard(p.dim + 1) if isinstance(p, Shard) else p for p in x.placements]
    shape = (k, x.shape[0] // k, *x.shape[1:])
    local = local.reshape(k, bl // k, *local.shape[1:])
    stride = (shape[1] * x.stride(0), *x.stride())
    return DTensor.from_local(local, x.device_mesh, pl, shape=shape, stride=stride,
                              run_check=False)


def value_and_grad(loss_fn, params, batch):
    """``((loss, metrics), grads)`` of ``loss_fn(params, batch)``, grads a
    tree like ``params``; the metrics are detached."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(live, batch)
    grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
    grads = tree_map(lambda _: next(grads), live)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), grads


def make_train_step(model: Model, opt_cfg: OptimizerConfig, rt: Runtime,
                    microbatches: int = 1, *, tuning_db=None, donate: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``tuning_db`` attaches a :class:`~repro_torch.tuning.tundb.TuningDB`
    whose kernel configs the ops layer picks up from this build on;
    ``None`` leaves ``rt`` as it is.  The step is functional: it returns
    new trees and leaves its inputs as they were, unless ``donate``: then
    it updates params and optimizer state in place and returns them (the
    reference's jitted step donates both).
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
                                                      opt_cfg, donate=donate)
        metrics = dict(metrics, **opt_metrics, loss_out=loss)
        return params, opt_state, metrics

    return train_step


class GraphedTrainStep(GraphedStep):
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``, as a
    donated ``make_train_step`` step; see ``make_graphed_train_step``."""

    def __init__(self, step, name: str):
        super().__init__(name, "train step")
        self.train_step = step

    def __call__(self, params, opt_state, batch: Dict[str, torch.Tensor]):
        if self.binding is None and any(isinstance(t, DTensor)
                                        for t in tensors((params, opt_state, batch))):
            raise TypeError(f"{self.name}: a step placed on a mesh runs eagerly "
                            "(make_train_step); the compiled step takes one card's tensors")
        if self.warm and self.graph is None:
            # this call captures: free what the eager step left (autograd's
            # reference cycles can hold its tensors beside the graph's pool)
            gc.collect()
            torch.cuda.empty_cache()
        metrics = self.run({"parameter set": params, "optimizer state": opt_state},
                           {"batch": batch},
                           lambda: self.train_step(params, opt_state, batch)[2],
                           lambda inputs: self.train_step(params, opt_state, inputs["batch"])[2])
        return params, opt_state, metrics


def make_graphed_train_step(model: Model, opt_cfg: OptimizerConfig, rt: Runtime,
                            microbatches: int = 1, *, tuning_db=None):
    """The compiled train step (the reference's ``jax.jit(step_fn,
    donate_argnums=(0, 1))``): ``make_train_step(..., donate=True)``'s
    signature and results, on the card only.

    * It is bound, at its first call, to one parameter set and one AdamW
      state (their leaves' addresses, shapes and dtypes) and to the
      batch's shapes; a call with another raises (``Binding``): a trainer
      that restores a checkpoint into new trees builds a new step.
    * The first call runs eagerly and is a real step; the second captures
      forward, backward (the oracle recomputes included) and the donated
      update, the microbatch loop unrolled, and replays; every later call
      copies the batch into the graph's inputs and replays.
    * Params and AdamW state are updated in place at the addresses the
      graph holds, the step count too (``adamw_update``), so the learning
      rate and bias corrections advance a replay.  The metrics are the
      graph's static outputs, overwritten by the next replay.
    * A replay adds its kernel launches to the wrappers' counters.  CPU
      tensors and a step placed on a mesh raise; a capture that fails
      raises with the model's name."""
    step = make_train_step(model, opt_cfg, rt, microbatches, tuning_db=tuning_db,
                           donate=True)
    return GraphedTrainStep(step, model.cfg.name)
