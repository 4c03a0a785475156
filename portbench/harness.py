"""One run of one cell: set-up, the measured window, the traced reading, the
correctness check and the result line.

A driver (``portbench/drivers/<name>.py``) gives four functions over a
``Run``:

* ``setup(run)``: builds the program's objects for the cell, makes the
  weights and inputs from the seed, and warms up (and captures) every
  shape the window uses;
* ``window(run, seconds)``: runs the traffic for ``seconds`` on the host's
  clock (the last wave or step it began runs to its end), marking device
  events; it sets ``run.e2e`` (end-to-end metrics), ``run.attempted``,
  ``run.failed`` and what its metric readers need (``run.spans``,
  ``run.work``);
* ``release(run)``: frees the program's state, so that the reference fits;
* ``check(run)``: compares what the timed path produced with the plain
  reference, returning ``[(name, value, limit)]``: the run is correct
  where every value is at most its limit.
"""
from __future__ import annotations

import gc
import math
import sys
import time
from typing import Callable, Dict, List, Optional

from portbench import spec
from portbench.trace import Profiler

#: whole top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``: ``repro_torch`` is not ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


class Run:
    """What one run of a cell holds: its inputs, the program's objects the
    driver builds, the marks of the window and what the readers read."""

    def __init__(self, workload: dict, seed: int, seconds: float, trace: bool, device):
        self.workload = workload
        self.cell = workload["cell"]
        self.conf = workload["config_file"]
        self.name = workload["name"]
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = device
        self.on_card = getattr(device, "type", str(device)) == "cuda"
        self.e2e: Dict[str, float] = {}
        self.attempted = self.failed = 0
        self.spans: Dict[str, list] = {}  # name -> [(mark, mark)]
        self.work: Dict[str, object] = {}
        self.counters: Dict[str, int] = {}
        self.notes: List[str] = []
        self.state: Dict[str, object] = {}  # the driver's own
        self.tracing = None  # the reduced Trace of a --trace 1 run
        self.power: Optional[str] = None  # the card's name and power limit

    # -- the clock of the window: device events on the card, the host's
    #    clock elsewhere (the CPU runs of the tests) --------------------------
    def mark(self):
        if self.on_card:
            import torch

            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b) -> float:
        if self.on_card:
            return a.elapsed_time(b)
        return (b - a) * 1e3

    def sync(self):
        if self.on_card:
            import torch

            torch.cuda.synchronize(self.device)

    def span(self, name: str, a, b) -> None:
        self.spans.setdefault(name, []).append((a, b))

    def span_ms(self, name: str) -> List[float]:
        return [self.ms(a, b) for a, b in self.spans.get(name, [])]


def _power_limit() -> Optional[str]:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def _counters() -> Dict[str, int]:
    from repro_torch.runtime.graphs import kernel_counters

    return {k.__name__: int(k.launches) for k in kernel_counters()}


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device,
             started: float, root=spec.ROOT, workload: Optional[dict] = None,
             prepare: Optional[Callable[[Run], None]] = None,
             after: Optional[Callable[[Run], dict]] = None, log=None) -> dict:
    """One run of cell ``name``; returns the result object.  ``started`` is
    the host clock at the process's start.  ``workload`` replaces the cell
    as found by name (the tests shrink it); ``prepare(run)`` is called
    before the set-up, ``after(run)`` after the check, its result kept
    under ``after`` (``calibrate.py`` reads the control with it)."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    bench = spec.benchmark(root)
    w = workload or spec.workload(name, root)
    drv = spec.driver(w["cell"]["driver"], root)
    run = Run(w, seed, seconds, trace, device)
    if prepare is not None:
        prepare(run)

    t_setup = time.perf_counter()
    drv.setup(run)
    run.sync()
    # the set-up's objects out of the collector's way, so that a collection
    # in the window scans only what the window makes
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - started
    log(f"[portbench] {name} seed {seed}: set-up {setup_s:.3f} s, of which the driver's "
        f"{time.perf_counter() - t_setup:.3f} s (before it: the interpreter, the imports, the card)")
    before = _counters()
    with Profiler(trace and run.on_card) as prof:
        drv.window(run, seconds)
        run.sync()
    run.counters = {k: v - before.get(k, 0) for k, v in _counters().items()}
    run.e2e["setup_s"] = setup_s
    if run.on_card:
        import torch

        # the peak of the process so far: set-up and window, not the reference
        peak = int(torch.cuda.max_memory_allocated(device))
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
               "memory_peak_bytes": peak}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    if trace:
        run.tracing = prof.reduce(run.e2e.get("_window_s", 0.0))
        if run.tracing is not None:
            dev["busy_s"] = run.tracing.busy_s
            dev["window_s"] = run.tracing.window_s
    run.power = _power_limit() if run.on_card else None

    e2e_defs = spec.end_to_end(bench, name)
    if trace:
        metrics = {}
        for m in spec.per_layer(bench, name, [d["name"] for d in e2e_defs]):
            value = spec.metric(m["name"], root).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        metrics = {d["name"]: {"value": float(run.e2e[d["name"]]), "unit": d["unit"]}
                   for d in e2e_defs}

    gc.unfreeze()
    drv.release(run)
    t_ref = time.perf_counter()
    compared = drv.check(run)
    run.sync()
    log(f"[portbench] reference and check: {time.perf_counter() - t_ref:.3f} s")
    correct = bool(compared) and all(v <= lim for _, v, lim in compared) and not run.failed
    correct = correct and all(math.isfinite(v["value"]) for v in metrics.values())
    result = {"correct": correct, "attempted": int(run.attempted), "failed": int(run.failed),
              "metrics": metrics, "device": dev}
    if trace and run.tracing is not None:
        result["breakdown"] = {"device_ops": run.tracing.device_ops,
                               "idle_gaps": run.tracing.idle_gaps}
    if run.power:
        log(f"[portbench] card and power limit: {run.power}")
    for note in run.notes:
        log(f"[portbench] {note}")
    if after is not None:
        result["after"] = after(run)
    result["compared"] = {n: {"value": v, "limit": lim} for n, v, lim in compared}
    return result
