"""The device trace of a ``--trace 1`` run: ``torch.profiler`` around the
whole measured window, reduced here to what the readers and the result
line need.

* ``busy_s``: the union of the intervals in which an operation (kernel,
  copy, set) ran on the device; ``window_s``: the window's length, from
  the harness's first to its last device event.
* kernel time and count by name (``kernel(substring)``), for rooflines;
* ``breakdown``: the ten device operations that took most time, and the
  ten longest idle gaps, each named by the harness's host span
  (``span(name)``, a ``record_function`` named ``portbench.<name>``) that
  was open while the device waited.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

PREFIX = "portbench."
NAME_CHARS = 160  # of a device operation's name in the breakdown


@contextlib.contextmanager
def span(name: str, on: bool):
    """A host span the trace can name an idle gap by (nothing when off)."""
    if not on:
        yield
        return
    import torch

    with torch.profiler.record_function(PREFIX + name):
        yield


@dataclass
class Trace:
    busy_s: float
    window_s: float
    by_name: dict  # kernel name -> [seconds, count]
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernel(self, part: str) -> Tuple[float, int]:
        """Seconds and launches of the device operations whose name holds
        ``part``."""
        s = n = 0
        for name, (sec, cnt) in self.by_name.items():
            if part in name:
                s += sec
                n += cnt
        return s, n

    @property
    def idle_share(self) -> Optional[float]:
        if self.window_s <= 0:
            return None
        return max(0.0, 1.0 - self.busy_s / self.window_s)


class Profiler:
    """``with Profiler(on) as p:`` profiles the block; ``p.reduce(window_s)``
    then gives the ``Trace``."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None

    def __enter__(self):
        if self.on:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def reduce(self, window_s: float) -> Optional[Trace]:
        if self.prof is None:
            return None
        import torch

        dev, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            if e.name().startswith(PREFIX):  # the harness's span, on either timeline
                if e.device_type() != torch.autograd.DeviceType.CUDA:
                    host.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                                 e.name()[len(PREFIX):]))
            elif e.device_type() == torch.autograd.DeviceType.CUDA:
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        return reduce_events(dev, host, window_s)


def reduce_events(dev, host, window_s: float) -> Trace:
    """``dev``: (start ns, end ns, name) of device operations; ``host``: the
    harness's spans, the same."""
    by_name = defaultdict(lambda: [0.0, 0])
    for s, e, name in dev:
        by_name[name][0] += (e - s) / 1e9
        by_name[name][1] += 1
    dev = sorted(dev)
    busy, gaps, cur_s, cur_e = 0, [], None, None
    for s, e, _ in dev:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    gaps.sort(key=lambda g: g[0] - g[1])

    def label(g):
        mid = (g[0] + g[1]) / 2
        open_ = [h for h in host if h[0] <= mid <= h[1]]
        return min(open_, key=lambda h: h[1] - h[0])[2] if open_ else "outside the harness's spans"

    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return Trace(busy_s=busy / 1e9, window_s=window_s, by_name=dict(by_name),
                 device_ops=[[name[:NAME_CHARS], sec] for name, (sec, _) in top_ops],
                 idle_gaps=[[label(g), (g[1] - g[0]) / 1e9] for g in gaps[:10]])
