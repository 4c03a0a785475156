"""Hooks through which a step shows its structure to a trace.

Two traces read them.  The dry run's op-level analysis
(``repro_torch.tuning.trace_analysis``) reads two hooks:

* ``region(tag, fn, *args)`` runs ``fn(*args)`` as the kernel region
  ``tag``: the reference's ``named_scope("krnl_...")`` around the oracle
  forms of its kernels.  A trace leaves such a region's ops out of the
  per-op traffic and credits the kernel's stream traffic instead.
* ``repeat(fn, *args)`` runs ``fn(*args)``, a call that its step repeats
  on inputs of the same shapes (the microbatch loop of a train step): a
  trace may account a repeat from the record of the first call instead of
  running it again.

Without a trace in the calling thread each hook is one thread-local read
and the plain call, so the hooks cost nothing on the kernel path.

The program's own spans are the other: ``span(name)`` marks a phase of
the program (a compiled step's whole call, its binding check, a train
step's forward, backward and optimizer, the serving loop's parts).  A span
is on while the operator's switch is set (``tracing(True)``: the
``--trace`` of ``launch/serve.py`` and ``launch/train.py``) or while a
``torch.profiler`` records.  When off it costs one thread-local read, one
flag read and the profiler's own check, and makes no event, no range and
no record.  When on it

* opens the host range ``"repro_torch." + name`` among the profiler's
  events, so that the program's phases lie on the profiler's timeline
  beside the device's work.  The range is a function's and not a user's
  (``record_function``'s): the profiler copies a user's range onto the
  device's timeline, where a trace would count it as the device's work;
* keeps a ``Record``: the host start on the profiler's clock
  (``time.time_ns``), the host milliseconds from entry to exit and, where
  its work is on the card, the device milliseconds from pairs of timing
  events on the current stream (read when first asked for);
* adds one to the name's call count (``counters()``).

A span entered while a CUDA graph is captured for a compiled step
(``collecting``) records a pair of timing events into the graph instead,
whatever the switch says, and the step reads their times after each
traced replay (``runtime/graphs.py``): a replay runs no Python, so this is
how the phases of a compiled train step are timed.  A span entered while
a graph is captured for anything else is off.  Inside ``merged()``
the spans of one name make one record, their times summed (a train step's
phases over its microbatches).  ``records(name)``, ``counters()``,
``summary()`` (the ``[trace]`` lines) and ``reset()`` read and clear them.
"""
from __future__ import annotations

import contextlib
import math
import threading
import time
from typing import Dict, List, Optional

import torch

_TLS = threading.local()

#: the prefix of a span's range among the profiler's events
PREFIX = "repro_torch."
#: the counters of a compiled step's calls, by how each call ran
CALL_KINDS = ("eager", "capture", "replay")

_switch = False
_lock = threading.Lock()
_records: Dict[str, List["Record"]] = {}
_counts: Dict[str, int] = {}


def set_active(tracer):
    """Make ``tracer`` this thread's trace; returns the previous one."""
    prev = getattr(_TLS, "tracer", None)
    _TLS.tracer = tracer
    return prev


def region(tag: str, fn, *args):
    tracer = getattr(_TLS, "tracer", None)
    if tracer is None:
        return fn(*args)
    return tracer.region(tag, fn, args)


def repeat(fn, *args):
    tracer = getattr(_TLS, "tracer", None)
    if tracer is None:
        return fn(*args)
    return tracer.repeat(fn, args)


# ---------------------------------------------------------------------------
# The program's spans
# ---------------------------------------------------------------------------


def tracing(on: bool) -> bool:
    """Sets the operator's switch; returns its previous setting."""
    global _switch
    prev, _switch = _switch, bool(on)
    return prev


class Record:
    """One span's times.  ``host_ms`` is None for a phase timed inside a
    graph's replay (no Python ran); ``device_ms`` is None where no timing
    events were recorded, else the sum over the span's pairs, read (and
    the events let go) at the first access."""

    __slots__ = ("name", "start_ns", "host_ms", "_events", "_device_ms")

    def __init__(self, name: str, start_ns: int, host_ms: Optional[float], events: list):
        self.name, self.start_ns, self.host_ms = name, start_ns, host_ms
        self._events = events
        self._device_ms = None

    @property
    def device_ms(self) -> Optional[float]:
        if self._events:
            total = self._device_ms or 0.0
            for a, b in self._events:
                b.synchronize()
                total += a.elapsed_time(b)
            self._device_ms, self._events = total, None
        return self._device_ms


def _record(name: str, start_ns: int, host_ms: Optional[float], events: list) -> Record:
    merged = getattr(_TLS, "merged", None)
    with _lock:
        r = merged.get(name) if merged is not None else None
        if r is not None:  # the same phase again in this step: summed
            if host_ms is not None:
                r.host_ms = (r.host_ms or 0.0) + host_ms
            r._events = (r._events or []) + events
            return r
        r = Record(name, start_ns, host_ms, events)
        _records.setdefault(name, []).append(r)
        _counts[name] = _counts.get(name, 0) + 1
        if merged is not None:
            merged[name] = r
        return r


def _timing_event(external: bool = False):
    e = torch.cuda.Event(enable_timing=True, external=external)
    e.record()
    return e


class _Off:
    """A span that is off: it does nothing."""

    on = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def timed(self, card: bool = True):
        return self

    def count(self, kind: str) -> None:
        pass


OFF = _Off()


class _Timed:
    """A pair of timing events on the current stream around a block, added
    to its span's device time."""

    def __init__(self, span: "_Span"):
        self.span = span

    def __enter__(self):
        self.start = _timing_event()
        return self

    def __exit__(self, *exc):
        self.span.events.append((self.start, _timing_event()))
        return False


class _Span:
    on = True

    def __init__(self, name: str, card: bool):
        self.name, self.card = name, card
        self.events: list = []

    def __enter__(self):
        self.start_ns = time.time_ns()
        self._range = torch._C._profiler._RecordFunctionFast(PREFIX + self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter()
        if self.card:
            self._card = self.timed().__enter__()
        return self

    def __exit__(self, *exc):
        if self.card:
            self._card.__exit__(*exc)
        host_ms = (time.perf_counter() - self._t0) * 1e3
        self._range.__exit__(*exc)
        _record(self.name, self.start_ns, host_ms, self.events)
        return False

    def timed(self, card: bool = True):
        """The device time of the block on the current stream, added to the
        span's (nothing where ``card`` is false)."""
        return _Timed(self) if card else OFF

    def count(self, kind: str) -> None:
        """One more ``kind`` call of this span's step (``CALL_KINDS``)."""
        key = f"{self.name}.{kind}"
        with _lock:
            _counts[key] = _counts.get(key, 0) + 1

    def replayed(self, captured: list) -> List[Record]:
        """The records of the phases ``captured`` into a graph (``(name,
        start event, end event)``, in order) for the replay this span just
        launched: one a name, its device time the sum over its pairs.  Read
        them (``settle``) before the graph replays again: the next replay
        records the same events."""
        pairs: Dict[str, list] = {}
        for name, a, b in captured:
            pairs.setdefault(name, []).append((a, b))
        return [_record(name, self.start_ns, None, p) for name, p in pairs.items()]


class _Captured(_Off):
    """A span inside a graph's capture: a pair of timing events recorded into
    the graph, collected for the step that captures it."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.start = _timing_event(external=True)
        return self

    def __exit__(self, *exc):
        _TLS.collect.append((self.name, self.start, _timing_event(external=True)))
        return False


def span(name: str, *, card: bool = False):
    """A context manager over a phase named ``name`` (see the module's
    docstring).  ``card``: the phase's work is on the card, timed by a pair
    of events on the current stream around it."""
    if getattr(_TLS, "collect", None) is not None and _capturing():
        return _Captured(name)
    if _switch or torch._C._autograd._profiler_enabled():
        return OFF if _capturing() else _Span(name, card)
    return OFF


def _capturing() -> bool:
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


@contextlib.contextmanager
def collecting(into: list):
    """Spans entered while a CUDA graph is captured inside the block add
    ``(name, start event, end event)`` to ``into``."""
    prev = getattr(_TLS, "collect", None)
    _TLS.collect = into
    try:
        yield into
    finally:
        _TLS.collect = prev


@contextlib.contextmanager
def merged():
    """Spans of one name inside the block make one record, their times
    summed (a train step's phases over its microbatches)."""
    if getattr(_TLS, "merged", None) is not None:
        yield
        return
    _TLS.merged = {}
    try:
        yield
    finally:
        _TLS.merged = None


def settle(records: List[Record]) -> None:
    """Reads the device times of ``records`` now (one wait on their events)."""
    for r in records:
        r.device_ms


def records(name: str) -> List[Record]:
    """The records of span ``name``, in the order the spans ended."""
    with _lock:
        return list(_records.get(name, ()))


def counters() -> Dict[str, int]:
    """Calls by span name, and a compiled step's calls by kind
    (``<name>.eager``, ``.capture``, ``.replay``)."""
    with _lock:
        return dict(_counts)


def reset() -> None:
    with _lock:
        _records.clear()
        _counts.clear()


def _p95(values: List[float]) -> float:
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def summary() -> List[str]:
    """One ``[trace]`` line a span: calls; host ms, mean and 95th percentile;
    device ms, mean; for a compiled step its calls by kind."""
    with _lock:
        names = list(_records)
        counts = dict(_counts)
    lines = []
    for name in names:
        recs = records(name)
        host = [r.host_ms for r in recs if r.host_ms is not None]
        dev = [d for d in (r.device_ms for r in recs) if d is not None]
        line = f"[trace] {name} calls {counts.get(name, len(recs))}"
        line += (f" host_ms mean {sum(host) / len(host):.4f} p95 {_p95(host):.4f}"
                 if host else " host_ms -")
        line += f" device_ms mean {sum(dev) / len(dev):.4f}" if dev else " device_ms -"
        if any(f"{name}.{k}" in counts for k in CALL_KINDS):
            line += "".join(f" {k} {counts.get(f'{name}.{k}', 0)}" for k in CALL_KINDS)
        lines.append(line)
    return lines
