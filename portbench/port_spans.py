"""What the readers of the program's own spans share: the records a span
of the program (``runtime/trace_hooks.py`` of ``repro_torch``) kept over
the window.  The program records its spans while the profiler of a
``--trace 1`` run records, so that they are the window's calls; a reader
takes them only where their count is the harness's count of its own span
around the same calls, and otherwise reads nothing and adds a note.  A
program without spans reads nothing."""
from __future__ import annotations

from typing import List, Optional


def window_records(run, name: str, harness_span: str) -> Optional[list]:
    """The program's records of span ``name`` in the window, or None."""
    from repro_torch.runtime import trace_hooks

    records = getattr(trace_hooks, "records", None)
    if records is None:
        return None
    recs = records(name)
    calls = len(run.spans.get(harness_span, []))
    if not recs and not calls:
        return None
    if len(recs) != calls:
        run.notes.append(f"{name}: {len(recs)} records of the program, {calls} "
                         f"{harness_span!r} spans of the harness in the window")
        return None
    return recs


def mean(values: List[Optional[float]]) -> Optional[float]:
    """The mean, or None where a value is missing (a phase the card did not
    time: the CPU runs of the tests)."""
    if not values or any(v is None for v in values):
        return None
    return sum(values) / len(values)


def mean_device_ms(run, name: str, harness_span: str) -> Optional[float]:
    recs = window_records(run, name, harness_span)
    return None if recs is None else mean([r.device_ms for r in recs])
