"""Op-level analysis of one traced step: the counterpart of the
reference's ``tuning/hlo_analysis.py``.

There is no HLO in PyTorch.  The dry run runs the port's own step once on
``meta`` tensors (shapes and dtypes, no data, nothing allocated) under a
dispatch mode that sees every aten op the step runs, its backward
included.  Over that trace it reports:

* FLOPs, from the formulas of ``torch.utils.flop_counter`` (the table
  ``FlopCounterMode`` counts with; matmuls and convolutions, no
  elementwise work);
* per-op traffic: the bytes of every op's tensor inputs and outputs
  (views move nothing and are skipped), split by whether the op ran inside
  a ``krnl_`` region (``runtime/trace_hooks.py``; the reference's
  ``named_scope``) — ``traffic_included`` / ``traffic_excluded``.  A
  region's backward is tagged through its autograd nodes;
* the peak of live storage bytes over the step, split into
  ``argument_B`` (params, optimizer state, batch, cache), ``output_B``
  (results in new storage), ``alias_B`` (results in an argument's storage:
  the cache, updated in place) and ``temp_B`` = peak - argument - output +
  alias, the bytes beyond what the inputs and results hold at the peak.
  ``argument_B + temp_B + output_B - alias_B`` is the peak, as the
  reference's ``dryrun.py`` sums ``memory_analysis()``;
* collectives by kind, from the c10d functional ops in the trace, each
  with its result's bytes (the reference reads the HLO's result shapes).

On a mesh of more than one device the step's tensors are ``DTensor``s over
a fake process group (``launch/mesh.py``) holding ``meta`` shards, and the
counts are one device's: an op on DTensors is left to DTensor
(``NotImplemented``), which runs it again on the local shards, and that
call is counted, at its local shapes.  DTensor's sharding propagation runs
ops of its own at the global shapes (the op again on fake tensors, a
decomposition on ``meta`` stand-ins), and those are not counted: an op
reached from inside DTensor's propagation modules, or under a
``FakeTensorMode``, runs uncounted, and so does host bookkeeping on the CPU
(no ``meta`` tensor in or out).  A redistribute shows as the c10d op it
issues.  Argument and result bytes are the local shards' storage.

Unlike HLO's cost analysis the trace counts every layer of the python
layer loop, so the whole depth is traced.  Two things keep it quick: the
meta result of a pure op is cached by its inputs' shapes (a repeat returns
fresh ``meta`` storage of the cached shapes), and a call that a step marks
``trace_hooks.repeat`` (one microbatch's forward and backward) is traced
twice (the second call is recorded) and accounted from its record
thereafter.

A trace holds the Python interpreter throughout (``torch`` dispatch modes
are thread-local, so traces in two threads do not see each other's ops,
but they do not run at the same time either).
"""
from __future__ import annotations

import sys
import time
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.flop_counter import flop_registry

from repro_torch.runtime import trace_hooks

#: c10d op name -> the reference's collective kind
_COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
_C10D_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")

#: fresh ops that move no bytes
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "detach", "lift_fresh"}


@dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    count_by_kind: Dict[str, int] = field(default_factory=lambda: defaultdict(int))

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def summary(self) -> str:
        if not self.bytes_by_kind:
            return "none"
        parts = [
            f"{k}:{self.count_by_kind[k]}x/{self.bytes_by_kind[k]/1e6:.1f}MB"
            for k in sorted(self.bytes_by_kind)
        ]
        return " ".join(parts)


@dataclass
class TraceStats:
    flops: float = 0.0
    traffic_included: float = 0.0
    traffic_excluded: float = 0.0
    excluded_by_tag: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    argument_B: int = 0
    temp_B: int = 0
    output_B: int = 0
    alias_B: int = 0
    collectives: CollectiveStats = field(default_factory=CollectiveStats)
    ops: int = 0
    seconds: float = 0.0

    @property
    def per_device_B(self) -> int:
        return self.argument_B + self.temp_B + self.output_B - self.alias_B


class _Shape:
    """A cached op result: one tensor's shape, strides and dtype."""

    __slots__ = ("shape", "stride", "dtype")

    def __init__(self, t: torch.Tensor):
        self.shape, self.stride, self.dtype = tuple(t.shape), t.stride(), t.dtype

    def make(self) -> torch.Tensor:
        return torch.empty_strided(self.shape, self.stride, dtype=self.dtype,
                                   device="meta")


_FAKE = torch._C._TorchDispatchModeKey.FAKE

#: DTensor's sharding propagation: what runs from these modules computes
#: layouts at the global shapes, not the step's work
_PROPAGATION = ("torch/distributed/tensor/_sharding_prop.py",
                "torch/distributed/tensor/_decompositions.py")


def _in_propagation() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.replace("\\", "/").endswith(_PROPAGATION):
            return True
        f = f.f_back
    return False


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank; any other tensor itself."""
    return t._local_tensor if isinstance(t, DTensor) else t


def _layout(t: torch.Tensor) -> tuple:
    """A tensor argument's layout: a DTensor's global shape and its
    placements on its mesh (so its shard's layout)."""
    if isinstance(t, DTensor):
        return (t.shape, t.stride(), t.dtype, t.device_mesh, tuple(t.placements))
    return (t.shape, t.stride(), t.dtype)


class _Wrap:
    """What makes a replayed shard the DTensor a recorded call returned."""

    __slots__ = ("mesh", "placements", "shape", "stride")

    def __init__(self, t: DTensor):
        self.mesh, self.placements = t.device_mesh, tuple(t.placements)
        self.shape, self.stride = t.shape, t.stride()

    def make(self, local: torch.Tensor) -> DTensor:
        return DTensor.from_local(local, self.mesh, self.placements, shape=self.shape,
                                  stride=self.stride, run_check=False)


def _key(obj):
    """Hashable stand-in for an op argument: a tensor by its layout."""
    if isinstance(obj, torch.Tensor):
        return (obj.shape, obj.stride(), obj.storage_offset(), obj.dtype, obj.device)
    if isinstance(obj, (list, tuple)):
        return tuple(_key(o) for o in obj)
    if isinstance(obj, dict):
        return tuple((k, _key(v)) for k, v in obj.items())
    hash(obj)  # raises TypeError for an unhashable argument: no caching
    return obj


def _shapes(out):
    """An op's result with each tensor replaced by its ``_Shape``."""
    if isinstance(out, torch.Tensor):
        return _Shape(out)
    if isinstance(out, (list, tuple)):
        return type(out)(_shapes(o) for o in out)
    return out


def _make(shapes):
    """Fresh ``meta`` tensors of a cached result's shapes."""
    if isinstance(shapes, _Shape):
        return shapes.make()
    if isinstance(shapes, (list, tuple)):
        return type(shapes)(_make(o) for o in shapes)
    return shapes


def _tensors(obj, out: list) -> list:
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _tensors(o, out)
    return out


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


_KIND: Dict[object, str] = {}


def _op_kind(func) -> str:
    """'pure' (fresh results, inputs untouched), 'view' (results alias an
    input) or 'mutating' (writes an input)."""
    kind = _KIND.get(func)
    if kind is None:
        s = func._schema
        if s.is_mutable:
            kind = "mutating"
        elif any(r.alias_info is not None for r in s.returns):
            kind = "view"
        else:
            kind = "pure"
        _KIND[func] = kind
    return kind


def _merge(into: TraceStats, delta: TraceStats) -> None:
    """Add ``delta``'s counts (not its memory) to ``into``."""
    into.flops += delta.flops
    into.traffic_included += delta.traffic_included
    into.traffic_excluded += delta.traffic_excluded
    into.ops += delta.ops
    for k, v in delta.excluded_by_tag.items():
        into.excluded_by_tag[k] += v
    for k, v in delta.collectives.bytes_by_kind.items():
        into.collectives.bytes_by_kind[k] += v
    for k, v in delta.collectives.count_by_kind.items():
        into.collectives.count_by_kind[k] += v


class Tracer(TorchDispatchMode):
    """The dispatch mode that accounts a traced step (see module doc)."""

    def __init__(self):
        super().__init__()
        self.stats = TraceStats()
        self._tags: list = []
        self._cache: dict = {}
        self._records: dict = {}
        self._live: Dict[int, int] = {}
        self._refs: Dict[int, weakref.ref] = {}
        self.live = 0
        self.peak = 0
        self._quiet = False
        self._placed = False  # a DTensor op was seen: propagation may run

    # -- storage bookkeeping ---------------------------------------------------
    def _free(self, key: int) -> None:
        self.live -= self._live.pop(key, 0)
        self._refs.pop(key, None)

    def register(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage (a DTensor's: its shard's) as live until it
        is freed (once)."""
        st = _local(t).untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live += n
        if self.live > self.peak:
            self.peak = self.live
        self._refs[key] = weakref.ref(st, lambda _, key=key: self._free(key))

    # -- regions ---------------------------------------------------------------
    def _tag(self):
        if self._tags:
            return self._tags[-1]
        # a backward op: its autograd node carries the region's tag (a
        # checkpoint's recompute runs with grad on and uses the stack)
        if not torch.is_grad_enabled():
            node = torch._C._current_autograd_node()
            if node is not None:
                return node.metadata.get("krnl")
        return None

    def region(self, tag, fn, args):
        self._tags.append(tag)
        try:
            out = fn(*args)
        finally:
            self._tags.pop()
        root = getattr(out, "grad_fn", None)
        if root is not None:
            stop = {a.grad_fn for a in args
                    if isinstance(a, torch.Tensor) and a.grad_fn is not None}
            todo, seen = [root], set()
            while todo:
                node = todo.pop()
                if node in seen or node in stop or node.name().endswith("AccumulateGrad"):
                    continue
                seen.add(node)
                node.metadata["krnl"] = tag
                todo.extend(n for n, _ in node.next_functions if n is not None)
        return out

    # -- repeated calls ----------------------------------------------------------
    def repeat(self, fn, args):
        # the same shapes and the same non-tensor objects (a repeat's slice
        # of the batch differs from the first one only by its offset)
        key = (fn, tuple(_layout(a) if isinstance(a, torch.Tensor) else id(a)
                         for a in tree_flatten(args)[0]))
        rec = self._records.get(key)
        if rec is None:  # the first call runs unrecorded: what it leaves
            self._records[key] = False  # behind (a cached table) stays out
            return fn(*args)
        if rec is False:  # the second is recorded: its counts apart
            main, self.stats = self.stats, TraceStats()
            live0, peak0, before_call = self.live, self.peak, set(self._live)
            self.peak = self.live
            out = fn(*args)
            delta, self.stats = self.stats, main
            _merge(main, delta)
            peak, self.peak = self.peak - live0, max(peak0, self.peak)
            # the results' layouts; a result sharing storage with an earlier
            # one (a detached loss and its metric) is replayed as its view, and
            # one in storage that outlives the call (not new) as itself
            leaves, spec = tree_flatten(out)
            made, first = [], {}
            for i, t in enumerate(leaves):
                loc = _local(t) if isinstance(t, torch.Tensor) else None
                sk = loc.untyped_storage()._cdata if loc is not None else None
                if sk is None or sk in before_call or sk not in self._live:
                    made.append((t, None, 0, None))
                else:
                    j = first.setdefault(sk, i)
                    made.append((_Shape(loc), None if j == i else j, loc.storage_offset(),
                                 _Wrap(t) if isinstance(t, DTensor) else None))
            self._records[key] = (delta, peak, made, spec)
            return out
        delta, peak, made, spec = rec
        _merge(self.stats, delta)
        self.peak = max(self.peak, self.live + peak)
        leaves, locs = [], []
        self._quiet = True
        try:
            for m, j, offset, wrap in made:
                if not isinstance(m, _Shape):
                    leaves.append(m)
                    locs.append(None)
                    continue
                if j is None:
                    loc = m.make()
                    self.register(loc)
                else:
                    loc = locs[j].as_strided(m.shape, m.stride, offset)
                locs.append(loc)
                leaves.append(loc if wrap is None else wrap.make(loc))
        finally:
            self._quiet = False
        return tree_unflatten(leaves, spec)

    # -- every op ----------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if DTensor in types or any(issubclass(t, DTensor) for t in types):
            self._placed = True
            return NotImplemented  # DTensor runs it again on the local shards
        kwargs = kwargs or {}
        if (self._quiet or torch._C._get_dispatch_mode(_FAKE) is not None
                or (self._placed and _in_propagation())):
            return func(*args, **kwargs)  # a replay, or DTensor's global shapes
        ins = _tensors(args, [])
        _tensors(list(kwargs.values()), ins)
        if not any(t.device.type == "meta" for t in ins):
            if ins:  # host bookkeeping (DTensor's index arithmetic), not the step's
                return func(*args, **kwargs)
            out = func(*args, **kwargs)  # a factory: the step's if it made meta
            if not any(t.device.type == "meta" for t in _tensors(out, [])):
                return out
            return self._account(func, "pure", args, kwargs, ins, out, 0)
        kind = _op_kind(func)
        flops = 0
        if kind == "pure":
            try:
                key = (func, _key(args), _key(kwargs))
                hit = self._cache.get(key)
            except TypeError:
                key = hit = None
            if hit is not None:
                shapes, flops = hit
                out = _make(shapes)
            else:
                out = func(*args, **kwargs)
                count = flop_registry.get(func._overloadpacket)
                if count is not None:
                    flops = count(*args, **kwargs, out_val=out)
                if key is not None:
                    self._cache[key] = (_shapes(out), flops)
        else:
            out = func(*args, **kwargs)
            count = flop_registry.get(func._overloadpacket)
            if count is not None:
                flops = count(*args, **kwargs, out_val=out)
        return self._account(func, kind, args, kwargs, ins, out, flops)

    def _account(self, func, kind, args, kwargs, ins, out, flops):
        s = self.stats
        s.ops += 1
        s.flops += flops
        outs = _tensors(out, [])
        if kind == "pure":
            for t in outs:
                self.register(t)
        if kind != "view" and func._overloadpacket.__name__ not in _NO_TRAFFIC:
            b = _nbytes(ins) + _nbytes(outs)
            tag = self._tag()
            if tag is None:
                s.traffic_included += b
            else:
                s.traffic_excluded += b
                s.excluded_by_tag[tag] += b
        if func.namespace in _C10D_NAMESPACES:
            coll = _COLLECTIVE_KINDS.get(func._overloadpacket.__name__)
            if coll is not None:
                s.collectives.bytes_by_kind[coll] += _nbytes(outs)
                s.collectives.count_by_kind[coll] += 1
        return out


def _storages(tree) -> Dict[int, int]:
    """storage -> bytes of every tensor in a tree."""
    out = {}
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            st = _local(t).untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


def trace(fn, args) -> "tuple":
    """Run ``fn(*args)`` on ``meta`` tensors under a ``Tracer``; returns
    ``(out, TraceStats)``.  ``args`` are the step's arguments (every tensor
    in them counts as ``argument_B``)."""
    tracer = Tracer()
    for t in tree_flatten(args)[0]:
        if isinstance(t, torch.Tensor):
            tracer.register(t)
    t0 = time.perf_counter()
    prev = trace_hooks.set_active(tracer)
    try:
        with tracer:
            out = fn(*args)
    finally:
        trace_hooks.set_active(prev)
    s = tracer.stats
    s.seconds = time.perf_counter() - t0
    arg_B, out_B = _storages(args), _storages(out)
    s.argument_B = sum(arg_B.values())
    s.alias_B = sum(n for k, n in out_B.items() if k in arg_B)
    s.output_B = sum(out_B.values())
    s.temp_B = tracer.peak - s.argument_B - s.output_B + s.alias_B
    return out, s
