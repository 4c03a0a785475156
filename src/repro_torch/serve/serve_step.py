"""Serving steps: batched prefill + single-token decode, under
``torch.no_grad()``.

``make_prefill_step`` and ``make_decode_step`` run eagerly, op by op (the
CPU path and the tests').  ``make_graphed_prefill_step`` and
``make_graphed_decode_step`` are the served steps on the card, the
counterparts of the reference's ``jax.jit(prefill)`` and
``jax.jit(decode_step, donate_argnums=(2,))``: each step is captured once
into a CUDA graph and replayed, over the caller's cache, filled and
updated in place at fixed addresses (the decode step's position is held
on the device).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels.ops import with_db
from repro_torch.models.model import Model
from repro_torch.models.params import tree_leaves
from repro_torch.models.runtime import Runtime
from repro_torch.runtime.graphs import (Binding, CountedGraph, GraphedStep,  # noqa: F401
                                        kernel_counters)


def make_prefill_step(model: Model, rt: Runtime, *, tuning_db=None):
    rt = with_db(rt, tuning_db)

    @torch.no_grad()
    def prefill_step(params, batch: Dict[str, torch.Tensor], cache):
        logits, _, new_cache = model.apply(
            params, batch, rt=rt, mode="prefill", cache=cache
        )
        return logits, new_cache

    return prefill_step


def make_decode_step(model: Model, rt: Runtime, *, tuning_db=None):
    rt = with_db(rt, tuning_db)

    @torch.no_grad()
    def decode_step(params, tokens: torch.Tensor, cache):
        return model.decode_step(params, tokens, cache, rt=rt)

    return decode_step


# ---------------------------------------------------------------------------
# The compiled steps (the capture protocol: ``runtime/graphs.py``)
# ---------------------------------------------------------------------------


def _decode_held(params, cache) -> dict:
    return {"cache": cache["layers"], "parameter set": params}


class DecodeBinding(Binding):
    """What a compiled decode step is bound to: one cache's storage (its
    leaves' addresses), one ``(batch, cache_len)`` (the tokens' and the
    leaves' shapes) and one parameter set (its leaves' addresses).  A call
    with anything else raises: a graph replays the addresses it captured."""

    def __init__(self, model: Model, params, tokens: torch.Tensor, cache):
        super().__init__(model.cfg.name, "decode step", _decode_held(params, cache),
                         {"tokens": tokens})
        self.limit = model.decode_limit(cache)

    def check(self, params, tokens: torch.Tensor, cache) -> None:
        super().check(_decode_held(params, cache), {"tokens": tokens})

    def check_position(self, pos: int) -> None:
        if pos < 0 or (self.limit is not None and pos >= self.limit):
            raise IndexError(f"{self.name}: decode position {pos} is outside the cache of "
                             f"{self.limit} slots")


class GraphedDecodeStep(GraphedStep):
    """``(params, tokens, cache) -> (logits, cache)``, as ``make_decode_step``'s
    step, with ``cache["pos"]`` a host integer advanced by one; see
    ``make_graphed_decode_step``."""

    def __init__(self, model: Model, rt: Runtime):
        super().__init__(model.cfg.name, "decode step")
        self.model, self.rt = model, rt
        self._pos = self._pos_host = None

    def new_binding(self, held, copied):
        return DecodeBinding(self.model, held["parameter set"], copied["tokens"],
                             {"layers": held["cache"]})

    @torch.no_grad()
    def __call__(self, params, tokens: torch.Tensor, cache):
        pos = cache["pos"]
        if isinstance(pos, torch.Tensor):
            raise TypeError("the compiled decode step takes cache['pos'] as a host integer")
        layers = cache["layers"]
        copied = {"tokens": tokens}
        self.bind(_decode_held(params, cache), copied)
        self.binding.check_position(pos)
        if self._pos is None:  # the graph's position, allocated outside its pool
            self._pos = torch.zeros((), dtype=torch.int64, device=tokens.device)
        if pos != self._pos_host:  # a prefill rebound the cache: stream-ordered, no read
            self._pos.fill_(pos)
            self._pos_host = pos

        def region(inputs):
            logits, new = self.model.decode_step(
                params, inputs["tokens"], {"pos": self._pos, "layers": layers}, rt=self.rt)
            self._pos.copy_(new["pos"])  # advanced inside the graph
            return logits

        replays = self.warm
        logits = self.step(
            copied, lambda: self.model.decode_step(params, tokens, cache, rt=self.rt)[0], region)
        if replays:
            self._pos_host += 1
        return logits, {"pos": pos + 1, "layers": layers}


def make_graphed_decode_step(model: Model, rt: Runtime, *, tuning_db=None):
    """The compiled decode step (the reference's ``jax.jit(decode_step,
    donate_argnums=(2,))``): same signature and contract as
    ``make_decode_step``'s, on the card only.

    * It is bound, at its first call, to one cache's storage, one
      ``(batch, cache_len)`` and one parameter set; a call with another
      raises (``DecodeBinding``), it does not capture again.
    * The first call runs eagerly and is a real step; the second captures
      the step into a CUDA graph on a side stream and replays it; every
      later call copies ``tokens`` into the graph's input and replays.
    * The position lives on the device: it is set from ``cache["pos"]``
      by a stream-ordered ``fill_`` when a prefill rebinds the cache, and
      advanced inside the graph.  A host mirror bounds it: a step past the
      cache raises ``IndexError`` before the replay, with no device read.
    * The cache is donated: it is updated in place at the addresses the
      graph holds.  The returned ``logits`` is the graph's static output
      and the next replay overwrites it, as a donated buffer is: a caller
      that keeps logits clones them.
    * A replay adds the kernel launches it stands for to the wrappers'
      counters (``CountedGraph``), so counts read as the eager step's.
    * The TuningDB is consulted at capture (as the reference's jit reads
      it at trace time).
    * CPU tensors raise, and a capture that fails raises with the model's
      name: nothing falls back to the eager step."""
    return GraphedDecodeStep(model, with_db(rt, tuning_db))


class GraphedPrefillStep(GraphedStep):
    """``(params, batch, cache) -> (logits, cache)``, as ``make_prefill_step``'s
    step; see ``make_graphed_prefill_step``."""

    def __init__(self, model: Model, rt: Runtime):
        super().__init__(model.cfg.name, "prefill step")
        self.model, self.rt = model, rt

    @torch.no_grad()
    def __call__(self, params, batch: Dict[str, torch.Tensor], cache):
        layers = cache["layers"]

        def prefill(b):
            logits, _, new = self.model.apply(params, b, rt=self.rt, mode="prefill",
                                              cache=dict(cache))
            if new["layers"] is not layers:
                raise RuntimeError(f"{self.name}: the prefill did not fill its cache in place")
            return logits, new["pos"]

        logits, pos = self.run({"cache": layers, "parameter set": params}, {"batch": batch},
                               lambda: prefill(batch), lambda inputs: prefill(inputs["batch"]))
        return logits, {"pos": pos, "layers": layers}


def make_graphed_prefill_step(model: Model, rt: Runtime, *, tuning_db=None):
    """The compiled prefill (the reference's ``jax.jit(prefill)``): same
    signature and contract as ``make_prefill_step``'s, on the card only.

    * One graph a ``(batch, prompt_len, cache_len)``: it is bound, at its
      first call, to one cache's storage (the cache ``launch/serve.py``
      allocates once and zeroes every wave), the batch's shapes (tokens,
      and a family's frontend embeddings) and one parameter set; a call
      with another raises (``Binding``).
    * The first call runs eagerly and is a real prefill; the second
      captures it and replays; every later call copies the batch into the
      graph's inputs and replays.
    * The cache is filled in place, and the returned position is the host
      integer ``prompt_len``, so a compiled decode step bound to the same
      cache follows it.  The returned ``logits`` is the graph's static
      output, overwritten by the next replay.
    * A replay adds its kernel launches to the wrappers' counters.  CPU
      tensors raise, a capture that fails raises with the model's name."""
    return GraphedPrefillStep(model, with_db(rt, tuning_db))


def reset_cache(cache) -> dict:
    """Every leaf of ``cache`` zeroed in place and the position at 0: the
    state of a fresh ``Model.init_cache``, at the same addresses."""
    for leaf in tree_leaves(cache["layers"]):
        leaf.zero_()
    return {"pos": 0, "layers": cache["layers"]}


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]


def generate(model: Model, params, batch, *, rt: Runtime, cache, steps: int,
             tuning_db=None):
    """Prefill + greedy decode loop, the decode eager (the loop of
    ``launch/serve.py``, which on the card decodes through the compiled step)."""
    prefill = make_prefill_step(model, rt, tuning_db=tuning_db)
    decode = make_decode_step(model, rt, tuning_db=tuning_db)
    logits, cache = prefill(params, batch, cache)
    tok = greedy_sample(logits)
    out = [tok]
    for _ in range(steps - 1):
        logits, cache = decode(params, tok, cache)
        tok = greedy_sample(logits)
        out.append(tok)
    return torch.cat(out, dim=1), cache
