"""Faults planted in the program underneath a run, to show that the check
catches them (``portbench/tests`` on the CPU, ``calibrate.py`` on the card
at the cell's own size).  ``plant(name)`` patches the program's module and
returns the function that takes the patch out; plant before the run's
set-up, so that a compiled step captures the fault.

* ``token``: served tokens altered where they are produced (every
  sequence's greedy token moved to the next id), so that any sampled
  request carries one;
* ``state_unchanged``: a step that returns its state unchanged: a decode
  step that writes no cache or recurrent state, a train step whose update
  writes nothing;
* ``half_batch``: the loss taken over the first half of the batch.
"""
from __future__ import annotations

from typing import Callable

SERVING = ("token", "state_unchanged")
TRAINING = ("state_unchanged", "half_batch")


def _patch(module, name: str, make) -> Callable[[], None]:
    old = getattr(module, name)
    setattr(module, name, make(old))
    return lambda: setattr(module, name, old)


def plant(name: str, training: bool = False) -> Callable[[], None]:
    if name == "token":
        from repro_torch.serve import serve_step

        def make(old):
            def greedy_sample(logits):
                return (old(logits) + 1) % logits.shape[-1]
            return greedy_sample
        return _patch(serve_step, "greedy_sample", make)
    if name == "state_unchanged" and training:
        from repro_torch.train import train_step

        def make(old):
            def adamw_update(grads, state, params, cfg, *, donate=False):
                return params, state, {"lr": state["count"].float(), "grad_norm": state["count"].float(),
                                       "clip": state["count"].float()}
            return adamw_update
        return _patch(train_step, "adamw_update", make)
    if name == "state_unchanged":
        import torch

        from repro_torch.models import lm

        def clone(tree):
            if isinstance(tree, dict):
                return {k: clone(v) for k, v in tree.items()}
            return tree.clone() if isinstance(tree, torch.Tensor) else tree

        def make(old):
            def _block_apply(block, x, *, mode, cache, **kw):
                if mode == "decode" and cache is not None:
                    cache = clone(cache)
                return old(block, x, mode=mode, cache=cache, **kw)
            return _block_apply
        return _patch(lm, "_block_apply", make)
    if name == "half_batch":
        from repro_torch.train import train_step

        def make(old):
            def cross_entropy(logits, targets):
                half = logits.shape[0] // 2
                return old(logits[:half], targets[:half])
            return cross_entropy
        return _patch(train_step, "cross_entropy", make)
    raise ValueError(f"no fault {name!r}")
