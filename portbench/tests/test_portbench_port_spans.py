"""The readers of the program's own spans (``port_spans.py``) at the tiny
size on the CPU.  On the card a ``--trace 1`` run's profiler sets the
program's spans on over the window; here a stand-in for the profiler sets
the program's switch over the window alone.

* the train phases' readers return None (nothing times a phase on the
  CPU), though the phases are recorded;
* a record count that differs from the harness's span count reads None,
  with a note; a program without spans reads None."""
import time
import types

import pytest
import torch

from portbench import harness, spec
from portbench.tests.tiny import shrink
from repro_torch.runtime import trace_hooks

PHASES = ("train_forward_ms", "train_backward_ms", "train_optimizer_ms")


class _SwitchedWindow:
    """In the harness's ``Profiler``'s place: the program's switch set over
    the window, as a recording profiler sets its spans on there."""

    def __init__(self, on):
        pass

    def __enter__(self):
        trace_hooks.reset()
        trace_hooks.tracing(True)
        return self

    def __exit__(self, *exc):
        trace_hooks.tracing(False)
        return False

    def reduce(self, window_s):
        return None


@pytest.fixture
def switched(monkeypatch):
    monkeypatch.setattr(harness, "Profiler", _SwitchedWindow)
    yield
    trace_hooks.tracing(False)
    trace_hooks.reset()


def _run(cell, logged=None):
    return harness.run_cell(cell, 2**33 + 11, 0.2, True, device=torch.device("cpu"),
                            started=time.perf_counter(), workload=shrink(spec.workload(cell)),
                            log=(logged.append if logged is not None else lambda *a: None))


def test_the_train_phase_readers_read_nothing_on_the_cpu(switched):
    r = _run("rwkv6-3b-8l.train-2x2048")
    assert r["correct"], r["compared"]
    assert not set(PHASES) & set(r["metrics"])
    steps = r["attempted"]
    for name in ("train.forward", "train.backward", "train.optimizer"):
        recs = trace_hooks.records(name)
        assert len(recs) == steps and all(x.device_ms is None for x in recs)


def test_records_beyond_the_window_read_none_with_a_note():
    """The switch set over the whole run: set-up's calls are recorded too."""
    logged = []
    trace_hooks.reset()
    trace_hooks.tracing(True)
    try:
        r = _run("rwkv6-3b-8l.train-2x2048", logged)
    finally:
        trace_hooks.tracing(False)
        trace_hooks.reset()
    assert not set(PHASES) & set(r["metrics"])
    assert any("train.forward:" in line and "spans of the harness" in line for line in logged)


def test_a_program_without_spans_reads_none(monkeypatch):
    monkeypatch.delattr(trace_hooks, "records")
    run = types.SimpleNamespace(spans={"decode": [(0, 1)], "train": [(0, 1)]}, notes=[])
    for name in PHASES:
        assert spec.metric(name).read(run) is None
    assert run.notes == []
