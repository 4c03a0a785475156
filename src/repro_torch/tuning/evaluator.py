"""Objective evaluators — the "system under test" side of paper Fig. 4.

* ``WallClockEvaluator`` — the paper-faithful measurement path: apply the
  configuration, run the step on the local device, report measured
  throughput (examples- or tokens-/second).
* ``RooflineEvaluator`` — the device-free path: trace the cell's step for
  one card with the candidate configuration (``launch/dryrun.py``) and
  report the roofline-estimated throughput (tokens/second).  A
  configuration whose peak bytes exceed the card's HBM is a *failed run*
  (-inf), exactly like a crashed measurement in the paper's harness.
  ``cache_path`` persists every analysis through the shared
  :class:`~repro_torch.tuning.cache.JsonCacheStore` (atomic writes,
  cross-process file locking), so concurrent tuning runs merge their
  analyses instead of clobbering each other; its keys are the reference's.
  A record also names the torch that traced it and its pod size
  (``provenance``): DTensor lays a mesh out differently from one torch to
  the next, and the key names no pod size, so an entry that names another
  torch or pod size, or none, is traced again and overwritten.

Both implement the explicit evaluator protocol
(``repro_torch.tuning.objective.Evaluator``): ``__call__(point) -> (value,
meta)``, declared via ``returns_meta = True`` so the tuner/executor never
have to sniff return types.  Both also opt into the **fidelity** protocol
(``supports_fidelity``) for multi-fidelity tuning: ``WallClockEvaluator``
scales its variance-adaptive timing loop, ``RooflineEvaluator`` drops to
the fast (1- and 2-period, extrapolated) trace; in both, a full-fidelity
request takes exactly the same code path as a plain no-fidelity call.

PyTorch runs eagerly and a CUDA launch returns before the card has done
the work, so every place where the reference package waits for a result
(``jax.block_until_ready``) synchronises the step's device here
(``torch.cuda.synchronize``); without it a CUDA step would time only its
launch.  The reference times its step compiled (``jax.jit(step)``), so on
the card ``WallClockEvaluator`` times replays of one CUDA graph of the
step (``runtime.graphs.GraphedStep``), not the eager step's dispatch.
"""
from __future__ import annotations

import json
import math
import time
from typing import Callable, Dict, Optional, Tuple

from repro_torch.tuning.cache import CacheStore, open_store
from repro_torch.tuning.cost_model import HBM_BYTES
from repro_torch.tuning.objective import Evaluator
from repro_torch.tuning.parameters import BASELINE, BackendConfig, config_from_point


def _cuda_devices(obj, out: set) -> set:
    """The CUDA devices of every tensor in ``obj`` (nested tuples, lists
    and dicts of tensors)."""
    if isinstance(obj, (tuple, list)):
        for o in obj:
            _cuda_devices(o, out)
    elif isinstance(obj, dict):
        for o in obj.values():
            _cuda_devices(o, out)
    elif getattr(obj, "is_cuda", False):
        out.add(obj.device)
    return out


def _wait(out, args) -> None:
    """Wait until the step's work is done on its device: synchronise every
    CUDA device its output or its inputs lie on.  Work on the CPU is
    finished when the call returns."""
    devices = _cuda_devices((out, args), set())
    if devices:
        import torch

        for dev in devices:
            torch.cuda.synchronize(dev)


def provenance(chips_per_pod: int) -> dict:
    """What a dry-run record depends on beyond its key: the torch whose
    sharding propagation laid the step out, and the chips of a pod."""
    import torch

    return {"torch": torch.__version__, "chips_per_pod": chips_per_pod}


class RooflineEvaluator(Evaluator):
    def __init__(
        self,
        arch: str,
        shape_name: str,
        *,
        multi_pod: bool = False,
        chips_per_pod: int = 1,
        base: BackendConfig = BASELINE,
        hbm_bytes: float = HBM_BYTES,
        cache_path: Optional[str] = None,
    ):
        self.arch = arch
        self.shape_name = shape_name
        self.multi_pod = multi_pod
        self.chips_per_pod = chips_per_pod
        self.base = base
        self.hbm_bytes = hbm_bytes
        # the shared store is loaded exactly once here; later in-memory
        # misses re-consult it (a locked file read) before tracing, so
        # entries written by concurrent hosts after startup are reused
        self.store: CacheStore = open_store(cache_path)
        self._cache: Dict[str, dict] = self.store.load()

    supports_fidelity = True

    def _key(self, bc: BackendConfig, fast: bool = False) -> str:
        d = {"arch": self.arch, "shape": self.shape_name, "mp": self.multi_pod,
             "bc": bc.__dict__}
        if fast:  # full-fidelity keys keep the historical format unchanged
            d["analysis"] = "fast"
        return json.dumps(d, sort_keys=True)

    def _current(self, rec: Optional[dict]) -> Optional[dict]:
        """``rec`` if this process's torch and pod size made it, else
        ``None`` (entries written before records named them included)."""
        mine = provenance(self.chips_per_pod)
        if rec is None or any(rec.get(k) != v for k, v in mine.items()):
            return None
        return rec

    def __call__(self, point: Dict,
                 fidelity: Optional[float] = None) -> Tuple[float, dict]:
        from repro_torch.launch.dryrun import analyze_cell  # lazy: the model stack

        # analysis-depth fidelity: a partial measurement traces 1 and 2
        # periods and extrapolates (``fast``) instead of the whole depth
        fast = fidelity is not None and fidelity < 1.0
        bc = config_from_point(point, self.base)
        key = self._key(bc, fast=fast)
        rec = self._current(self._cache.get(key))
        if rec is None:
            # in-memory miss: another host sharing this store may have
            # analysed it since __init__ — a locked file read is far cheaper
            # than a trace.  Merge every entry we don't already hold: each
            # concurrent-host record then costs one file read in all
            for k, v in self.store.load().items():
                if self._current(self._cache.get(k)) is None:
                    self._cache[k] = v
            rec = self._current(self._cache.get(key))
        if rec is None:
            # a miss, or an entry of another torch or pod size: trace anew
            rec = {**provenance(self.chips_per_pod), **analyze_cell(
                self.arch, self.shape_name, multi_pod=self.multi_pod,
                bc=bc, chips_per_pod=self.chips_per_pod, fast=fast,
            )}
            self._cache[key] = rec
            # merge-on-write under the store's file lock: concurrent tuning
            # runs sharing one cache file union their entries
            self.store.put(key, rec)
        # a full-fidelity request is byte-identical to a plain call,
        # meta included; only partial measurements are labeled
        fid_meta = {"fidelity": float(fidelity)} if fast else {}
        if rec.get("skipped"):
            return -math.inf, dict(fid_meta, skip_reason=rec["skip_reason"])
        mem = rec["memory"]["per_device_B"]
        meta = dict(fid_meta, roofline=rec["roofline"], mem_per_device_B=mem)
        if mem > self.hbm_bytes:
            return -math.inf, dict(meta, oom=True)
        return float(rec["roofline"]["throughput_tok_s"]), meta


#: two-sided 95% Student-t critical values by degrees of freedom (1-30);
#: beyond 30 the normal 1.96 is within ~2%
_T95 = (12.706, 4.303, 3.182, 2.776, 2.571, 2.447, 2.365, 2.306, 2.262,
        2.228, 2.201, 2.179, 2.160, 2.145, 2.131, 2.120, 2.110, 2.101,
        2.093, 2.086, 2.080, 2.074, 2.069, 2.064, 2.060, 2.056, 2.052,
        2.048, 2.045, 2.042)


def _t95(df: int) -> float:
    return _T95[df - 1] if 1 <= df <= len(_T95) else 1.96


class WallClockEvaluator(Evaluator):
    """Measured throughput of a step built from the configuration point.

    ``make_step(point) -> (step_fn, args, examples_per_step)``:
    the builder applies the point's backend parameters (Runtime knobs,
    microbatches, ...) and returns a step plus its inputs.

    Measurement is **variance-adaptive**: steps are timed one at a time
    until the 95% confidence half-width of the mean step time is within
    ``rel_halfwidth`` of the mean, or ``max_iters`` measurements were
    taken — so a stable configuration stops after ``min_iters`` steps
    while a jittery one keeps measuring up to the cap.  The caps default
    off the caller's ``iters`` (``min_iters = 2`` — the CI needs two
    samples — and ``max_iters = 4 * iters``), so a harness sized for cheap
    measurements stays cheap: ``iters=3`` usually costs 2 steps and
    never more than 12.  Note the methodology: per-step variance needs a
    per-step device synchronise, so each sample includes one host/device
    round trip that the pipelined loop amortizes across ``iters`` steps —
    for sub-millisecond steps this inflates ``step_seconds`` slightly and
    uniformly.  ``adaptive=False`` is the fixed-``iters`` pipelined loop.

    Fidelity (``supports_fidelity``): a partial measurement scales the
    iteration cap by ``fidelity`` and widens the target CI by
    ``1/fidelity`` — the bottom successive-halving rung is a couple of
    quick steps with a loose interval, the top rung the full adaptive
    loop.  ``fidelity=None``/1.0 is byte-identical to a plain call.

    Cost attribution: ``meta["cost_seconds"]`` is the **measurement-only**
    time (the timing loop), excluding step build and warmup (which also
    absorbs a kernel's first-use build or JIT compile) — a repeat
    measurement of this configuration pays only the timing loop, so
    charging the build to the configuration would mislead cost-aware
    (EI-per-second) acquisition.  The one-time overhead is reported
    separately as ``meta["build_seconds"]``.

    Compilation: where the step's arguments lie on the card, the step is
    compiled as the reference's ``jax.jit(step)`` compiles it: the
    ``warmup`` calls (at least one) run eagerly on the capture's stream,
    then ``step(*args)`` is captured into one CUDA graph and replayed once
    (``GraphedStep``; ``build_seconds`` includes the capture and that
    replay), and both timing loops time replays, each ended by a
    synchronise.  The graph is bound to ``args`` once a point; the timed
    replays check nothing.  The graph and its memory pool are released
    before the call returns.  A capture that fails raises with ``name``;
    an out-of-memory error keeps its type.  On the CPU the step runs
    eagerly.
    """

    supports_fidelity = True

    def __init__(
        self,
        make_step: Callable[[Dict], Tuple[Callable, tuple, float]],
        *,
        warmup: int = 1,
        iters: int = 3,
        adaptive: bool = True,
        rel_halfwidth: float = 0.05,
        min_iters: Optional[int] = None,
        max_iters: Optional[int] = None,
        name: str = "step",
    ):
        self.make_step = make_step
        self.name = name
        self.warmup = warmup
        self.iters = iters
        self.adaptive = adaptive
        self.rel_halfwidth = rel_halfwidth
        # caps scale with the caller's iters so harnesses sized for cheap
        # measurements stay cheap; the CI needs >= 2 samples for a
        # variance estimate, so 2 is the floor either way
        self.max_iters = max(2, 4 * iters if max_iters is None else max_iters)
        self.min_iters = min(self.max_iters,
                             max(2, 2 if min_iters is None else min_iters))

    def _measure(self, step, args, fidelity: float):
        """Adaptive timing loop: per-step seconds list."""
        if not self.adaptive:
            n = max(1, round(self.iters * fidelity))
            t0 = time.perf_counter()
            out = None
            for _ in range(n):
                out = step(*args)
            _wait(out, args)
            return [(time.perf_counter() - t0) / n] * n
        cap = max(self.min_iters, math.ceil(self.max_iters * fidelity))
        target = self.rel_halfwidth / fidelity
        times = []
        while len(times) < cap:
            t0 = time.perf_counter()
            _wait(step(*args), args)
            times.append(time.perf_counter() - t0)
            n = len(times)
            if n < self.min_iters:
                continue
            mean = sum(times) / n
            var = sum((t - mean) ** 2 for t in times) / (n - 1)
            halfwidth = _t95(n - 1) * math.sqrt(var / n)
            if halfwidth <= target * mean:
                break
        return times

    def __call__(self, point: Dict,
                 fidelity: Optional[float] = None) -> Tuple[float, dict]:
        f = 1.0 if fidelity is None else max(min(float(fidelity), 1.0), 1e-3)
        t_build0 = time.perf_counter()
        step, args, examples = self.make_step(point)
        graph = out = None
        try:
            if _cuda_devices(args, set()):
                from repro_torch.runtime.graphs import GraphedStep

                graph = GraphedStep(self.name, "measured step", warmup=self.warmup)
                measured = step
                run = lambda inputs=None: measured(*args)  # noqa: E731
                for _ in range(graph.warmup + 1):  # eager, then capture and a replay
                    out = graph.run({"arguments": args}, {}, run, run)
                step = lambda *_: graph.replay({})  # noqa: E731
            else:
                for _ in range(self.warmup):
                    out = step(*args)
            _wait(out, args)
            build_seconds = time.perf_counter() - t_build0
            times = self._measure(step, args, f)
        finally:
            if graph is not None:
                graph.release()
        n = len(times)
        dt = sum(times) / n
        mean = dt
        hw = 0.0
        if n >= 2:
            var = sum((t - mean) ** 2 for t in times) / (n - 1)
            hw = _t95(n - 1) * math.sqrt(var / n)
        meta = {
            "step_seconds": dt,
            "iters": n,
            "ci_rel_halfwidth": hw / mean if mean > 0 else 0.0,
            "build_seconds": build_seconds,
            # measurement-only cost: what a repeat measurement would pay
            "cost_seconds": float(sum(times)),
        }
        if f < 1.0:  # a full-fidelity request is byte-identical to a
            meta["fidelity"] = f  # plain call, meta included
        return examples / dt, meta
