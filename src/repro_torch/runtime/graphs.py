"""CUDA graphs of the port's steps: where the reference compiles a step
with ``jax.jit``, the port captures it once into a ``torch.cuda.CUDAGraph``
and replays it.

* ``GraphedStep`` is the protocol every compiled step follows: its first
  call runs eagerly on the capture's side stream, so that what must
  exist before a capture is set up by a real call: Triton's compilation,
  the ``nvcc`` builds, cuBLAS's handle and workspace for that stream,
  K3's merge counters (``kernels/decode_attention.py`` refuses to grow
  them while capturing).  The next call captures the step into one graph
  over input buffers of its own, and every later call copies its inputs
  in and replays.  ``StepGraph`` is its graph and stream on one device.
* ``Binding`` is what a graph holds: the addresses, shapes and dtypes of
  the leaves it reads and writes in place, and the shapes and dtypes of
  the inputs copied into its own buffers before each replay.  A call with
  other leaves raises: a graph replays the addresses it captured.
* ``CountedGraph`` keeps the kernels' launch counters true: a replay runs
  no Python, so it adds the launches that the capture recorded.

Only CUDA tensors are captured: every compiled step refuses CPU tensors,
and nothing falls back to the eager step.  A capture that fails raises
with the step's name; an out-of-memory error keeps its own type.
"""
from __future__ import annotations

import contextlib
import gc
from typing import Callable, Dict, Optional

import torch


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
        """``region()`` under capture; returns what it returns.  Where the
        region raised, its error reaches the caller even if ending the
        capture raised another."""
        before = [c.launches for c in self.counters]
        failed = None
        try:
            with self.graph.capture():
                try:
                    out = region()
                except BaseException as e:
                    failed = e
                    raise
            increase = [c.launches - b for c, b in zip(self.counters, before)]
        except BaseException as e:
            if failed is not None and e is not failed:
                raise failed from e
            raise
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
    """A ``torch.cuda.CUDAGraph`` captured on ``stream`` (a side stream).
    The caller's current stream is put back however the capture ends."""

    def __init__(self, stream):
        self.graph, self.stream = torch.cuda.CUDAGraph(), stream

    @contextlib.contextmanager
    def capture(self):
        current = torch.cuda.current_stream(self.stream.device)
        try:
            with torch.cuda.graph(self.graph, stream=self.stream):
                yield
        finally:
            if torch.cuda.current_stream(self.stream.device) != current:
                torch.cuda.set_stream(current)

    def replay(self):
        self.graph.replay()


def capture(graph: CountedGraph, region, name: str, what: str):
    """``graph.capture(region)``; a failure raises with ``name`` (the model
    or the kernel), an out-of-memory error with its own type (a measured
    point that does not fit scores ``-inf`` by it)."""
    try:
        return graph.capture(region)
    except torch.OutOfMemoryError:
        raise
    except RuntimeError as e:
        raise RuntimeError(f"{name}: the {what} could not be captured into a CUDA "
                           f"graph: {e}") from e


def tensors(obj) -> list:
    """The tensors of nested dicts, tuples and lists, in order."""
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in tensors(v)]
    if isinstance(obj, (tuple, list)):
        return [t for v in obj for t in tensors(v)]
    return [obj] if isinstance(obj, torch.Tensor) else []


def _signature(tree):
    """Where each leaf of ``tree`` lives and what it holds."""
    return [(t.data_ptr(), tuple(t.shape), t.dtype) for t in tensors(tree)]


def _layout(tree):
    """The shapes, dtypes and devices of ``tree``'s leaves."""
    return [(tuple(t.shape), t.dtype, t.device) for t in tensors(tree)]


def require_card(name: str, what: str, tree) -> torch.device:
    """The one CUDA device every tensor of ``tree`` lies on; raises where a
    tensor lies elsewhere (a compiled step has no CPU path)."""
    on = {t.device for t in tensors(tree)}
    off = sorted({d.type for d in on if d.type != "cuda"})
    if off:
        raise RuntimeError(f"{name}: a compiled {what} captures work on the card; these "
                           f"tensors lie on {', '.join(off)} (run the eager step there)")
    if len(on) != 1:
        raise RuntimeError(f"{name}: the {what}'s tensors must lie on one device, not on {on}")
    return on.pop()


class Binding:
    """What a compiled step is bound to: ``held`` (name -> tree), the
    leaves the graph reads and writes in place, by address, shape and
    dtype; ``copied`` (name -> tree), the inputs copied into the graph's
    own buffers, by shape, dtype and device.  ``check`` raises
    ``ValueError`` for a call with anything else."""

    def __init__(self, name: str, what: str, held: Dict, copied: Dict):
        self.name, self.what = name, what
        self.held = {k: _signature(v) for k, v in held.items()}
        self.copied = {k: _layout(v) for k, v in copied.items()}

    def check(self, held: Dict, copied: Dict) -> None:
        now = {k: _signature(v) for k, v in held.items()}
        for k, tree in copied.items():
            if _layout(tree) != self.copied[k]:
                self._shapes(k)
        for k, sig in now.items():
            if [s[1:] for s in sig] != [s[1:] for s in self.held[k]]:
                self._shapes(k)
        for k, sig in now.items():
            if sig != self.held[k]:
                raise ValueError(f"{self.name}: the compiled {self.what} is bound to one "
                                 f"{k}'s storage; this call passes another {k}")

    def _shapes(self, k: str):
        raise ValueError(f"{self.name}: the compiled {self.what} is bound to the shapes of "
                         f"its {k}; this call passes other shapes: build another step")


#: the side stream of a device that every first call and capture runs on
_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """One side stream a device for every compiled step.  cuBLAS keeps a
    workspace for each stream it has run on, for the life of the process:
    a stream of its own for each step built (a tuning run builds one a
    point) would pin more device memory with every step."""
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device)
    return _STREAMS[device]


class StepGraph:
    """One step's graph on one device, and the side stream it is captured
    on: ``eager`` (a real call), then ``capture``, then ``replay``.
    ``release`` drops the graph and returns its memory pool."""

    def __init__(self, name: str, what: str, device: torch.device):
        self.name, self.what = name, what
        self.stream = capture_stream(device)
        self.graph: Optional[CountedGraph] = None
        self.eagers = 0

    def eager(self, fn: Callable):
        """``fn()``, run eagerly on the capture's stream: a real step."""
        cur, side = torch.cuda.current_stream(self.stream.device), self.stream
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn()
        cur.wait_stream(side)
        self.eagers += 1
        return out

    def capture(self, region: Callable):
        graph = CountedGraph(_CudaGraph(self.stream), kernel_counters())
        out = capture(graph, region, self.name, self.what)
        self.graph = graph
        return out

    def replay(self):
        self.graph.replay()

    def release(self):
        self.graph = None
        gc.collect()  # autograd's reference cycles can hold outputs of the capture
        torch.cuda.empty_cache()


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_zeros_like(v) for v in tree)
    return torch.zeros_like(tree) if isinstance(tree, torch.Tensor) else tree


class GraphedStep:
    """A step under the protocol, whole.  ``run(held, copied, eager,
    region)``:

    * binds, at the first call, to ``held`` (name -> tree: the leaves the
      step reads and writes in place) and ``copied`` (name -> tree: the
      inputs of a call); a later call with other leaves or shapes raises
      (``Binding``), and CPU tensors raise (``require_card``);
    * runs ``eager()`` (a real step, on the capture's stream) at the first
      ``warmup`` calls and returns its result;
    * at the next call captures ``region(inputs)``, ``inputs`` being
      ``copied``'s layout in buffers of the graph's own, allocated outside
      its pool, and then replays;
    * at every call after the warm-up copies ``copied`` into ``inputs``,
      replays, and returns the region's result: the graph's static
      outputs, which the next replay overwrites.

    ``release`` drops the graph, its inputs and outputs and its pool."""

    def __init__(self, name: str, what: str, *, warmup: int = 1):
        self.name, self.what, self.warmup = name, what, max(1, warmup)
        self.binding: Optional[Binding] = None
        self.steps: Optional[StepGraph] = None
        self._inputs = self._out = None

    @property
    def graph(self) -> Optional[CountedGraph]:
        return None if self.steps is None else self.steps.graph

    def new_binding(self, held: Dict, copied: Dict) -> Binding:
        return Binding(self.name, self.what, held, copied)

    def run(self, held: Dict, copied: Dict, eager: Callable, region: Callable):
        self.bind(held, copied)
        return self.step(copied, eager, region)

    def bind(self, held: Dict, copied: Dict) -> None:
        """The first call's binding, or a later call's check against it."""
        if self.binding is None:
            device = require_card(self.name, self.what, (held, copied))
            self.binding = self.new_binding(held, copied)
            self.steps = StepGraph(self.name, self.what, device)
        else:  # the base check: a subclass's own ``check`` takes the step's arguments
            Binding.check(self.binding, held, copied)

    @property
    def warm(self) -> bool:
        """Whether the next call replays."""
        return self.steps is not None and self.steps.eagers >= self.warmup

    def step(self, copied: Dict, eager: Callable, region: Callable):
        """``run`` after ``bind``."""
        if not self.warm:
            return self.steps.eager(eager)
        if self.graph is None:
            self._inputs = _zeros_like(copied)
            self._out = self.steps.capture(lambda: region(self._inputs))
        return self.replay(copied)

    def replay(self, copied: Dict):
        """Copies ``copied`` into the graph's inputs and replays (no
        binding check: a caller that replays over fixed arguments)."""
        for dst, src in zip(tensors(self._inputs), tensors(copied)):
            dst.copy_(src)
        self.steps.replay()
        return self._out

    def release(self):
        self._inputs = self._out = None
        if self.steps is not None:
            self.steps.release()
