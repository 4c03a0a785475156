"""Serving steps: batched prefill + single-token decode, under
``torch.no_grad()``.

``make_decode_step`` runs the decode step eagerly, op by op (the CPU path
and the tests').  ``make_graphed_decode_step`` is the served step on the
card, the counterpart of the reference's ``jax.jit(decode_step,
donate_argnums=(2,))``: the step is captured once into a CUDA graph and
replayed at every token, over a position held on the device and the
caller's cache, updated in place at fixed addresses.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels.ops import with_db
from repro_torch.models.model import Model
from repro_torch.models.params import tree_leaves
from repro_torch.models.runtime import Runtime


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
# The compiled decode step
# ---------------------------------------------------------------------------


def kernel_counters() -> list:
    """The kernel wrappers, each counting its launches in ``launches``."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gla_scan import gla_scan
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssm_scan import ssm_scan

    return [rmsnorm, flash_attention, decode_attention, ssm_scan, gla_scan]


class CountedGraph:
    """A captured region and the kernel launches it stands for.

    The wrappers count their launches in Python and a replay runs no
    Python.  So ``capture`` records how much each counter grew while the
    region was captured and puts the counters back (a capture launches
    nothing), and every ``replay`` adds that growth.  ``graph`` has
    ``capture()`` (a context manager) and ``replay()``; ``counters`` are
    objects with an integer ``launches``."""

    def __init__(self, graph, counters):
        self.graph, self.counters = graph, list(counters)
        self.increase = None

    def capture(self, region):
        """``region()`` under capture; returns what it returns."""
        before = [c.launches for c in self.counters]
        try:
            with self.graph.capture():
                out = region()
            increase = [c.launches - b for c, b in zip(self.counters, before)]
        finally:
            for c, b in zip(self.counters, before):
                c.launches = b
        self.increase = increase
        return out

    def replay(self):
        if self.increase is None:
            raise RuntimeError("replay before a capture")
        self.graph.replay()
        for c, n in zip(self.counters, self.increase):
            c.launches += n


class _CudaGraph:
    """A ``torch.cuda.CUDAGraph`` captured on ``stream`` (a side stream)."""

    def __init__(self, stream):
        self.graph, self.stream = torch.cuda.CUDAGraph(), stream

    def capture(self):
        return torch.cuda.graph(self.graph, stream=self.stream)

    def replay(self):
        self.graph.replay()


def _signature(tree):
    """Where each leaf of ``tree`` lives and what it holds."""
    return [(t.data_ptr(), tuple(t.shape), t.dtype) for t in tree_leaves(tree)]


class DecodeBinding:
    """What a compiled decode step is bound to: one cache's storage (its
    leaves' addresses), one ``(batch, cache_len)`` (the tokens' and the
    leaves' shapes) and one parameter set (its leaves' addresses).  A call
    with anything else raises: a graph replays the addresses it captured."""

    def __init__(self, model: Model, params, tokens: torch.Tensor, cache):
        self.name = model.cfg.name
        self.tokens = (tuple(tokens.shape), tokens.dtype, tokens.device)
        self.cache = _signature(cache["layers"])
        self.shapes = [s[1:] for s in self.cache]
        self.params = _signature(params)
        self.limit = model.decode_limit(cache)

    def check(self, params, tokens: torch.Tensor, cache) -> None:
        cache_now = _signature(cache["layers"])
        if ((tuple(tokens.shape), tokens.dtype, tokens.device) != self.tokens
                or [s[1:] for s in cache_now] != self.shapes):
            raise ValueError(
                f"{self.name}: the compiled decode step is bound to tokens "
                f"{self.tokens[0]} and its cache's shapes; this call has tokens "
                f"{tuple(tokens.shape)} and other shapes: build another step")
        if cache_now != self.cache:
            raise ValueError(f"{self.name}: the compiled decode step is bound to one "
                             "cache's storage; this call passes another cache")
        if _signature(params) != self.params:
            raise ValueError(f"{self.name}: the compiled decode step is bound to one "
                             "parameter set; this call passes another")

    def check_position(self, pos: int) -> None:
        if pos < 0 or (self.limit is not None and pos >= self.limit):
            raise IndexError(f"{self.name}: decode position {pos} is outside the cache of "
                             f"{self.limit} slots")


class GraphedDecodeStep:
    """``(params, tokens, cache) -> (logits, cache)``, as ``make_decode_step``'s
    step, with ``cache["pos"]`` a host integer advanced by one; see
    ``make_graphed_decode_step``."""

    def __init__(self, model: Model, rt: Runtime):
        self.model, self.rt = model, rt
        self.binding: Optional[DecodeBinding] = None
        self.graph: Optional[CountedGraph] = None
        self._warm = False
        self._stream = None
        self._pos = self._pos_host = self._tokens = self._logits = None

    @torch.no_grad()
    def __call__(self, params, tokens: torch.Tensor, cache):
        pos = cache["pos"]
        if isinstance(pos, torch.Tensor):
            raise TypeError("the compiled decode step takes cache['pos'] as a host integer")
        if tokens.device.type != "cuda":
            raise RuntimeError(
                f"{self.model.cfg.name}: a compiled decode step captures work on the card; "
                f"these tensors lie on {tokens.device.type} (decode on the CPU through "
                "make_decode_step)")
        if self.binding is None:
            on = {t.device for t in tree_leaves(cache["layers"]) + tree_leaves(params)}
            if on != {tokens.device}:
                raise RuntimeError(f"{self.model.cfg.name}: the tokens, the cache and the "
                                   f"parameters must lie on {tokens.device}, not on {on}")
            self.binding = DecodeBinding(self.model, params, tokens, cache)
            self._stream = torch.cuda.Stream(tokens.device)
        else:
            self.binding.check(params, tokens, cache)
        self.binding.check_position(pos)
        if not self._warm:
            return self._eager(params, tokens, cache)
        if self.graph is None:
            self._capture(params, tokens, cache)
        return self._replay(tokens, cache)

    def _eager(self, params, tokens, cache):
        """The first call: a real step, run eagerly on the capture's stream
        so that what it sets up (Triton's compilation, cuBLAS's handle and
        workspace for that stream, K3's merge counters) exists before the
        capture."""
        cur, side = torch.cuda.current_stream(tokens.device), self._stream
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.model.decode_step(params, tokens, cache, rt=self.rt)
        cur.wait_stream(side)
        self._warm = True
        return out

    def _capture(self, params, tokens, cache):
        pos = int(cache["pos"])
        # the graph's inputs, allocated outside its pool
        self._pos = torch.full((), pos, dtype=torch.int64, device=tokens.device)
        self._pos_host = pos
        self._tokens = torch.empty_like(tokens)
        layers = cache["layers"]

        def region():
            logits, new = self.model.decode_step(
                params, self._tokens, {"pos": self._pos, "layers": layers}, rt=self.rt)
            self._pos.copy_(new["pos"])  # advanced inside the graph
            return logits

        graph = CountedGraph(_CudaGraph(self._stream), kernel_counters())
        try:
            self._logits = graph.capture(region)
        except RuntimeError as e:
            raise RuntimeError(f"{self.model.cfg.name}: the decode step could not be "
                               f"captured into a CUDA graph: {e}") from e
        self.graph = graph

    def _replay(self, tokens, cache):
        pos = int(cache["pos"])
        if pos != self._pos_host:  # a prefill rebound the cache: stream-ordered, no read
            self._pos.fill_(pos)
            self._pos_host = pos
        self._tokens.copy_(tokens)
        self.graph.replay()
        self._pos_host += 1
        return self._logits, {"pos": pos + 1, "layers": cache["layers"]}


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
