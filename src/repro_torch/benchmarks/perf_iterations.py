"""§Perf hillclimbing: evaluate named BackendConfig variants on a
cell and emit the hypothesis -> change -> before/after log rows.

    PYTHONPATH=src python -m repro_torch.benchmarks.perf_iterations \
        --cell qwen2_train --out artifacts/perf_qwen2.json

Each variant is one hypothesis from the iteration loop (the reference's
EXPERIMENTS.md §Perf); ``run`` re-traces + re-analyzes the cell per
variant at the reference's 256-chip pod (``launch/dryrun.py`` on a fake
process group: device-free, nothing compiles) and reports all three
roofline terms + the dominant one.  ``run(..., fast=True)`` traces 1 and
2 periods and extrapolates (each row then says ``"analysis": "fast"``).

``--microbench`` runs the batched ask/tell throughput micro-benchmark
instead: every engine tunes the same deterministic objective (with a
simulated per-measurement cost) at parallelism 1 vs N, emitting

    microbench,<algo>,<parallelism>,<best>,<wall_seconds>

so the speedup of the parallel evaluation executor is directly visible.

``--async-loop`` adds the completion-driven vs batch-barrier comparison
on a *skewed-cost* objective (a quarter of the grid is ~8x slower —
exactly the shape that stalls a barrier loop), plus the disk-backed
memo-cache check (a second identical tuning run must re-evaluate
nothing), plus the BO suggestion-overhead bookkeeping.  The reference
gates its GP on **zero** new XLA compiles after a warmup run (its
bucketed, jitted surrogate); the port's GP (``core/gp.py``, PyTorch) has
no jit cache and compiles nothing, so that gate becomes the engine's
``ask_seconds``: every timed BO suggestion must be recorded there with a
finite time (per-ask latency lands in the emitted JSON).
``--remote`` adds the multi-host gate: two localhost ``launch/worker.py``
daemons (``python -m repro_torch.launch.worker``) serve the same skewed-cost objective and the remote executor
backend must be throughput-comparable to the thread backend at the same
parallelism, survive a mid-run worker kill with exactly-once accounting
(the dead worker's in-flight tasks are reinjected, never recorded as
config failures), and leave a memo (written by the tuner process — the
workers share no filesystem) that a thread-backend re-run fully reuses.

``--check`` turns all of these properties into exit-code gates, which
is what a CI job runs:

    PYTHONPATH=src python -m repro_torch.benchmarks.perf_iterations \
        --microbench --async-loop --multi-fidelity --remote --check

The wall-clock ratios are the gates of ``--check`` only; the tests hold
the accounting (nothing lost, nothing double-recorded, no re-evaluation)
and never a ratio of host timings.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time

from repro_torch.tuning.parameters import BASELINE

# hypothesis text -> (variant name, BackendConfig overrides)
CELLS = {
    # worst roofline fraction (attention-dominated small model)
    "qwen2_train": {
        "arch": "qwen2-0.5b",
        "shape": "train_4k",
        "variants": [
            ("baseline(paper-faithful defaults)", {}),
            ("H1 causal tile pruning: attention flops ~2x down "
             "(kernel pl.when skip)", {"attn_prune": True}),
            ("H2 remat names instead of full: drop recompute flops ~1.25x, "
             "memory grows", {"attn_prune": True, "remat": "names"}),
            ("H3 microbatches=2: halve activation memory, amortized step",
             {"attn_prune": True, "microbatches": 2}),
            ("H4 wider DP (dp=64,tp=4): small model needs little TP; "
             "less collective, better matmul shapes",
             {"attn_prune": True, "microbatches": 2, "log2_dp": 6}),
            ("H5 pure DP (dp=256,tp=1) + fsdp for params",
             {"attn_prune": True, "microbatches": 2, "log2_dp": 8}),
        ],
    },
    # most collective-bound cell: GSPMD MoE all-gathers TBs per step
    "qwen3_moe_train": {
        "arch": "qwen3-moe-30b-a3b",
        "shape": "train_4k",
        "variants": [
            ("baseline(paper-faithful GSPMD dispatch)", {}),
            ("H1 shard_map expert parallelism: local dispatch + single bf16 "
             "psum combine -> collective bytes should drop ~100x",
             {"moe_impl": "ep_local"}),
            ("H2 + causal tile pruning (attention flops ~2x down)",
             {"moe_impl": "ep_local", "attn_prune": True}),
            ("H3 + microbatches=4 (fit HBM: activations /4)",
             {"moe_impl": "ep_local", "attn_prune": True, "microbatches": 4}),
            ("H4 + remat names (less recompute at some activation cost)",
             {"moe_impl": "ep_local", "attn_prune": True, "microbatches": 4,
              "remat": "names"}),
            ("H5 + capacity factor 1.0 (smaller expert buffers)",
             {"moe_impl": "ep_local", "attn_prune": True, "microbatches": 4,
              "capacity_factor": 1.0}),
        ],
    },
    # collective-bound serving: per-token KV all-gathers (seq-sharded cache)
    "deepseek_decode": {
        "arch": "deepseek-coder-33b",
        "shape": "decode_32k",
        "variants": [
            ("baseline(paper-faithful defaults)", {}),
            ("H1 bf16 serving weights: halve weight footprint + reads",
             {"serve_bf16_params": True}),
            ("H2 + cache sharded by kv-heads (attention shard-local; "
             "needs tp<=8 for kv=8): dp=32,tp=8",
             {"serve_bf16_params": True, "cache_shard": "heads",
              "log2_dp": 5}),
            ("H3 + dp=16,tp=16 with head-sharded cache (kv 8%%16!=0 -> "
             "falls back to replicated cache: refutation probe)",
             {"serve_bf16_params": True, "cache_shard": "heads"}),
        ],
    },
}


#: the reference's pod: the §Perf cells are a 16 x 16 mesh at BASELINE
CHIPS_PER_POD = 256


def run(cell_key: str, emit=print, multi_pod: bool = False, *, fast: bool = False,
        chips_per_pod: int = CHIPS_PER_POD):
    from repro_torch.launch.dryrun import analyze_cell
    from repro_torch.train.train_step import MicrobatchSplitError

    cell = CELLS[cell_key]
    rows = []
    for label, overrides in cell["variants"]:
        bc = BASELINE.replace(**overrides)
        try:
            rec = analyze_cell(cell["arch"], cell["shape"], multi_pod=multi_pod,
                               bc=bc, chips_per_pod=chips_per_pod, fast=fast)
        except MicrobatchSplitError as e:
            # a variant the port cannot lay out (a device's batch that does
            # not split into the microbatches) is a failed measurement
            rows.append({"cell": cell_key, "variant": label, "overrides": overrides,
                         "error": f"{type(e).__name__}: {e}"})
            emit(f"perf,{cell_key},\"{label}\",error,{e}")
            continue
        r = rec["roofline"]
        row = {
            "cell": cell_key, "variant": label, "overrides": overrides,
            "compute_s": r["compute_s"], "memory_s": r["memory_s"],
            "collective_s": r["collective_s"], "bottleneck": r["bottleneck"],
            "est_step_s": r["est_step_s"],
            "throughput": r["throughput_tok_s"], "mfu": r["mfu"],
            "mem_GB": r["mem_per_device_GB"], "fits": r["fits_hbm"],
            "mesh": rec["mesh"], "analysis": rec["cost"]["analysis"],
            "collective_bytes": rec["collectives"]["weighted_bytes"],
            "trace_s": rec["compile_seconds"],
        }
        rows.append(row)
        emit(f"perf,{cell_key},\"{label}\",{r['compute_s']:.4f},"
             f"{r['memory_s']:.4f},{r['collective_s']:.4f},{r['bottleneck']},"
             f"{r['est_step_s']:.4f},{r['throughput_tok_s']:.4g},"
             f"{r['mfu']:.3f},{r['mem_per_device_GB']:.1f},{r['fits_hbm']}")
    return rows


def _bench_value(p) -> float:
    """The shared synthetic tuning landscape (max ~84 at inter_op=11,
    intra_op=60, build=3) — one definition so every gated benchmark and
    its margins measure the same objective."""
    a, b, c = p["inter_op"], p["intra_op"], p["build"]
    return float(50.0 * 2.718281828 ** (-((a - 11) / 5.0) ** 2)
                 + 0.3 * b - 0.004 * (b - 25) ** 2 + 7.0 * c)


def _bench_space():
    from repro_torch.core import CatDim, IntDim, SearchSpace
    return SearchSpace([IntDim("inter_op", 1, 16),
                        IntDim("intra_op", 0, 60, 5),
                        CatDim("build", (1, 2, 3))])


# skewed-cost parameters shared by the async and remote comparisons
_SKEW_FAST_S, _SKEW_SLOW_S = 0.02, 0.16


def _skewed_sleep_value(p, fast_s=_SKEW_FAST_S, slow_s=_SKEW_SLOW_S):
    time.sleep(slow_s if (p["inter_op"] + p["intra_op"]) % 4 == 0 else fast_s)
    return _bench_value(p)


def make_remote_bench_objective():
    """Factory the worker daemons import (--objective ...:name()): the
    same skewed-cost objective the local comparisons tune, built ON the
    worker so nothing but points and results crosses the wire."""
    from repro_torch.tuning.objective import Evaluator

    class SkewedBenchObjective(Evaluator):
        def __call__(self, p, fidelity=None):
            v = _skewed_sleep_value(p)
            return v, {"cost_seconds":
                       _SKEW_SLOW_S if (p["inter_op"] + p["intra_op"]) % 4
                       == 0 else _SKEW_FAST_S}

    return SkewedBenchObjective()


def run_microbench(budget: int = 24, parallelism: int = 4,
                   eval_seconds: float = 0.05, emit=print):
    """Batched ask/tell vs sequential loop on a deterministic objective.

    The objective's value is a pure function of the point; the sleep
    stands in for measurement cost (a real harness blocks on compile +
    run, releasing the GIL, which is exactly what the thread-pool
    executor overlaps).  Returns rows of
    ``(algo, parallelism, best, seconds)``.
    """
    from repro_torch.core import Tuner, TunerConfig

    def objective(p):
        time.sleep(eval_seconds)
        return _bench_value(p)

    make_space = _bench_space
    rows = []
    # same iteration budget: the executor should cut wall-clock ~par-fold
    for algo in ["bo", "ga", "nms", "random", "exhaustive"]:
        for par in (1, parallelism):
            t = Tuner(objective, make_space(),
                      TunerConfig(algorithm=algo, budget=budget, seed=0,
                                  verbose=False, parallelism=par))
            t0 = time.perf_counter()
            h = t.run()
            secs = time.perf_counter() - t0
            t.close()
            rows.append({"mode": "iteration_budget", "algo": algo,
                         "parallelism": par, "best": h.best().value,
                         "seconds": secs})
            emit(f"microbench,{algo},{par},{h.best().value:.4f},{secs:.3f}")
    # same wall-clock budget (the real production constraint): the parallel
    # executor measures ~par times more configurations in the same seconds
    wall = budget * eval_seconds / 2
    for algo in ["bo", "ga", "nms", "random"]:
        for par in (1, parallelism):
            t = Tuner(objective, make_space(),
                      TunerConfig(algorithm=algo, budget=10**9, seed=0,
                                  verbose=False, parallelism=par,
                                  wall_clock_budget=wall))
            h = t.run()
            t.close()
            rows.append({"mode": "wall_clock_budget", "algo": algo,
                         "parallelism": par, "best": h.best().value,
                         "n_evals": len(h), "wall_clock_s": wall})
            emit(f"microbench_wallclock,{algo},{par},"
                 f"{h.best().value:.4f},{len(h)}")
    return rows


def run_async_comparison(budget: int = 16, parallelism: int = 4,
                         fast_s: float = 0.02, slow_s: float = 0.16,
                         emit=print):
    """Completion-driven loop vs batch-barrier loop on a skewed-cost
    objective, plus the disk-backed memo-cache re-evaluation check.

    About a quarter of the grid costs ``slow_s`` and the rest ``fast_s``;
    a barrier loop pays ~``slow_s`` for every batch containing one slow
    point while the async loop keeps its other workers cycling, so at the
    same iteration budget the async loop should win on wall clock.
    Returns ``(rows, ok)`` where ``ok`` is the CI gate: async total
    beats the batch total AND a second identical tuning run re-evaluates
    nothing AND every timed BO suggestion is on the engine's
    ``ask_seconds`` with a finite time (the port's GP compiles nothing;
    see the module doc).
    """
    import math
    import tempfile

    from repro_torch.core import Tuner, TunerConfig
    from repro_torch.tuning.objective import CountingEvaluator

    def objective(p):
        time.sleep(slow_s if (p["inter_op"] + p["intra_op"]) % 4 == 0
                   else fast_s)
        return _bench_value(p)

    make_space = _bench_space

    # an untimed warmup run, as the reference's (there it fills the GP's
    # jit cache; here it keeps the timed runs' first-call costs, torch's
    # lazy initialisation, out of the comparison)
    gated = ("bo", "ga", "nms", "random")
    warm = Tuner(objective, make_space(),
                 TunerConfig(algorithm="bo", budget=budget, seed=0,
                             verbose=False, parallelism=parallelism))
    warm.run()
    warm.close()
    rows, totals, bo_asks, bo_untimed = [], {"batch": 0.0, "async": 0.0}, 0, 0
    for algo in ["bo", "ga", "nms", "random"]:
        for loop in ("batch", "async"):
            t = Tuner(objective, make_space(),
                      TunerConfig(algorithm=algo, budget=budget, seed=0,
                                  verbose=False, parallelism=parallelism,
                                  loop=loop))
            t0 = time.perf_counter()
            h = t.run()
            secs = time.perf_counter() - t0
            t.close()
            if algo in gated:
                totals[loop] += secs
            rows.append({"mode": "async_vs_batch", "algo": algo, "loop": loop,
                         "parallelism": parallelism, "best": h.best().value,
                         "n_evals": len(h), "seconds": secs,
                         "gated": algo in gated})
            emit(f"asyncbench,{algo},{loop},{parallelism},"
                 f"{h.best().value:.4f},{secs:.3f}")
            if algo == "bo":
                ask_s = t.engine.ask_seconds
                bo_asks += len(ask_s)
                bo_untimed += sum(1 for a in ask_s if not math.isfinite(a))
                rows.append({
                    "mode": "bo_suggestion_overhead", "loop": loop,
                    "per_ask_seconds": [round(s, 5) for s in ask_s],
                    "mean_ask_seconds": sum(ask_s) / max(len(ask_s), 1),
                    "max_ask_seconds": max(ask_s, default=0.0),
                })
                emit(f"bo_suggestion,{loop},asks={len(ask_s)},"
                     f"mean={sum(ask_s) / max(len(ask_s), 1) * 1e3:.1f}ms")
    rows.append({"mode": "bo_ask_seconds", "asks": bo_asks, "untimed": bo_untimed})
    emit(f"bo_ask_seconds,asks={bo_asks},untimed={bo_untimed}")
    speedup = totals["batch"] / max(totals["async"], 1e-9)
    rows.append({"mode": "async_vs_batch_total", "gated_algos": list(gated),
                 "batch_seconds": totals["batch"],
                 "async_seconds": totals["async"], "speedup": speedup})
    emit(f"asyncbench_total({'+'.join(gated)}),batch={totals['batch']:.3f},"
         f"async={totals['async']:.3f},speedup={speedup:.2f}x")

    # second run of the same tuning job must hit the disk memo: 0 re-evals
    counting = CountingEvaluator(objective)
    with tempfile.TemporaryDirectory() as d:
        memo = str(pathlib.Path(d) / "memo.json")

        def run_once():
            t = Tuner(counting, make_space(),
                      TunerConfig(algorithm="random", budget=budget, seed=0,
                                  verbose=False, parallelism=1,
                                  memo_cache_path=memo))
            h = t.run()
            t.close()
            return h

        run_once()
        first = counting.calls
        run_once()
        re_evals = counting.calls - first
    rows.append({"mode": "memo_cache_second_run",
                 "first_run_evals": first, "second_run_re_evals": re_evals})
    emit(f"memocache,first={first},second_run_re_evals={re_evals}")

    # regression gate, not a race: a 10% tolerance absorbs scheduling noise
    # on loaded CI runners while still catching a real loss of the async
    # loop's ~1.5x structural win (the emitted speedup shows the margin);
    # the bookkeeping gate has no tolerance
    ok = (totals["async"] < totals["batch"] * 1.1 and re_evals == 0
          and bo_asks > 0 and bo_untimed == 0)
    return rows, ok


def run_multi_fidelity_comparison(budget: int = 20, parallelism: int = 4,
                                  fast_s: float = 0.04, slow_s: float = 0.32,
                                  emit=print):
    """Successive-halving (ASHA rungs + preemption) vs the full-fidelity
    async loop on the skewed-cost objective.

    Both runs spend the same logical budget (``budget`` full-measurement
    equivalents).  The multi-fidelity run screens at 1/9 cost and
    promotes the top third per rung, so it should complete a
    full-fidelity measurement within 1% of the full run's best value in
    well under half the full run's wall clock — that ratio is the CI
    gate, together with exactly-once accounting under preemption: every
    real objective call is recorded exactly once (nothing lost when a
    preempt lands after a worker started, nothing double-recorded when
    it is cancelled first).

    Low fidelity is simulated honestly: cost scales with fidelity and
    the value carries a deterministic point-dependent bias that shrinks
    as fidelity rises, so promotion decisions are made on noisy
    rankings, exactly like short-run measurements in the paper's
    harness.
    """
    from repro_torch.core import Tuner, TunerConfig
    from repro_torch.tuning.objective import Evaluator

    true_value = _bench_value

    class SkewedFidelityObjective(Evaluator):
        supports_fidelity = True

        def __init__(self):
            self.log = []  # (t_done, key, fidelity, value) per real call

        def __call__(self, p, fidelity=None):
            f = 1.0 if fidelity is None else float(fidelity)
            base = slow_s if (p["inter_op"] + p["intra_op"]) % 4 == 0 else fast_s
            time.sleep(base * f)
            v = true_value(p)
            # deterministic measurement bias, shrinking with fidelity
            wiggle = ((p["inter_op"] * 13 + p["intra_op"] * 7
                       + p["build"] * 3) % 9 - 4) / 2.0
            v += (1.0 - f) * wiggle
            key = (p["inter_op"], p["intra_op"], p["build"])
            self.log.append((time.perf_counter(), key, f, v))
            # declared cost: the simulated measurement is the cost model's
            # training signal and must stay deterministic
            return v, {"cost_seconds": base * f}

    make_space = _bench_space

    # -- full-fidelity reference run -----------------------------------------
    full_obj = SkewedFidelityObjective()
    t_full = Tuner(full_obj, make_space(),
                   TunerConfig(algorithm="random", budget=budget, seed=0,
                               verbose=False, parallelism=parallelism))
    t0 = time.perf_counter()
    h_full = t_full.run()
    full_seconds = time.perf_counter() - t0
    t_full.close()
    best_full = h_full.best().value

    # -- successive-halving run, same logical budget -------------------------
    mf_obj = SkewedFidelityObjective()
    t_mf = Tuner(mf_obj, make_space(),
                 TunerConfig(algorithm="random", budget=budget, seed=0,
                             verbose=False, parallelism=parallelism,
                             multi_fidelity=True))
    t0 = time.perf_counter()
    h_mf = t_mf.run()
    mf_seconds = time.perf_counter() - t0
    rungs = t_mf.rung_scheduler.stats()
    t_mf.close()

    # time-to-target: first *full-fidelity* measurement within 1% of the
    # full run's best value (partial values are biased by construction and
    # do not count as "reached")
    target = best_full - 0.01 * abs(best_full)
    t_target = None
    for t_done, _key, f, v in sorted(mf_obj.log):
        if f >= 1.0 and v >= target:
            t_target = t_done - t0
            break

    # exactly-once accounting under preemption: every real measurement is
    # recorded exactly once — no losses (a preempt landing after the worker
    # started must still record) and no double-records (a cancelled preempt
    # must record nothing)
    measured = [e for e in h_mf.evals if not e.meta.get("memoized")]
    lost = len(mf_obj.log) - len(measured)
    seen_keys = [( *(e.point[k] for k in ("inter_op", "intra_op", "build")),
                  round(e.fidelity, 9)) for e in measured]
    double = len(seen_keys) - len(set(seen_keys))

    ratio = (t_target / full_seconds) if t_target is not None else float("inf")
    ok = t_target is not None and ratio <= 0.5 and lost == 0 and double == 0
    rows = [{
        "mode": "multi_fidelity", "algo": "random",
        "parallelism": parallelism, "budget_full_equivalents": budget,
        "full_best": best_full, "full_seconds": full_seconds,
        # None when nothing reached the top rung — the ratio gate then
        # fails cleanly (t_target stays None) instead of crashing here
        "mf_best_full_fidelity": max(
            (v for _t, _k, f, v in mf_obj.log if f >= 1.0), default=None),
        "mf_measurements": len(measured), "mf_seconds": mf_seconds,
        "time_to_within_1pct_s": t_target,
        "time_to_target_ratio": None if t_target is None else round(ratio, 4),
        "lost_results": lost, "double_recorded": double,
        "rungs": rungs,
    }]
    emit(f"mfbench,random,{parallelism},best_full={best_full:.4f},"
         f"full_s={full_seconds:.3f},t_target="
         f"{-1.0 if t_target is None else t_target:.3f},"
         f"ratio={ratio:.3f},lost={lost},double={double}")
    for row in rungs:
        emit(f"mfrung,{row['rung']},fidelity={row['fidelity']},"
             f"started={row['started']},completed={row['completed']},"
             f"promoted={row['promoted']},preempted={row['preempted']}")
    return rows, ok


def run_remote_comparison(budget: int = 16, parallelism: int = 4,
                          emit=print):
    """The remote executor backend against two real localhost worker
    daemons (subprocesses of ``launch/worker.py``), gated three ways:

    * **throughput** — completion-driven scaling over the fleet (2
      workers x 2 slots = the thread backend's parallelism) must be
      comparable to the thread backend on the same skewed-cost
      objective (RPC overhead is per-message milliseconds; the gate
      allows 1.5x plus a small absolute cushion for connection setup
      noise on loaded CI runners);
    * **worker kill mid-run** — one worker is killed while measurements
      are in flight; its tasks must be reinjected onto the survivor
      (never recorded as config failures), the run must still complete
      the full budget, and accounting must be exactly-once: nothing
      lost, nothing double-recorded, every recorded value bit-equal to
      the deterministic objective;
    * **shared memo across backends** — the memo written by the remote
      run (by the *tuner* process: workers share no filesystem with the
      store) must drive a second identical run on the local thread
      backend to zero re-evaluations.

    Returns ``(rows, ok)``.
    """
    import os
    import subprocess
    import sys
    import tempfile
    import threading

    from repro_torch.benchmarks.elastic_smoke import free_port, wait_port
    from repro_torch.core import Tuner, TunerConfig
    from repro_torch.tuning.objective import CountingEvaluator

    def objective(p):  # local twin of the worker-side objective
        return _skewed_sleep_value(p)

    make_space = _bench_space
    src = pathlib.Path(__file__).resolve().parents[2]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(src)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])

    def spawn_worker(port):
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.worker",
             "--host", "127.0.0.1", "--port", str(port),
             "--slots", "2", "--heartbeat", "0.5", "--objective",
             "repro_torch.benchmarks.perf_iterations:make_remote_bench_objective()"],
            env=env, cwd=str(src.parent),
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    ports = [free_port() for _ in range(3)]
    workers = [spawn_worker(p) for p in ports]  # third = the kill victim
    rows = []
    point_key = ("inter_op", "intra_op", "build")
    try:
        # a worker still importing torch on a loaded host is not listening
        # yet, and a Tuner gives each worker only its connect timeout
        for port, w in zip(ports, workers):
            wait_port(port, timeout_s=120.0, proc=w)
        with tempfile.TemporaryDirectory() as d:
            memo_clean = str(pathlib.Path(d) / "memo_remote.json")
            memo_kill = str(pathlib.Path(d) / "memo_kill.json")

            # -- thread-backend reference at the same parallelism ---------
            t = Tuner(objective, make_space(),
                      TunerConfig(algorithm="random", budget=budget, seed=0,
                                  verbose=False, parallelism=parallelism))
            t0 = time.perf_counter()
            h_thread = t.run()
            thread_s = time.perf_counter() - t0
            t.close()

            # -- clean remote runs: 2 workers x 2 slots.  Timed twice
            # (fresh memo each, so nothing is a cache hit) and gated on
            # the best: with 4+ processes on a small CI runner a single
            # timing can eat an arbitrary scheduling stall, and the gate
            # asks whether the backend CAN match the thread backend, not
            # whether the runner was quiet.
            remote_timings = []
            for memo_path in (memo_clean,
                              str(pathlib.Path(d) / "memo_remote2.json")):
                t = Tuner(objective, make_space(),
                          TunerConfig(algorithm="random", budget=budget,
                                      seed=0, verbose=False,
                                      memo_cache_path=memo_path,
                                      workers=[f"127.0.0.1:{ports[0]}",
                                               f"127.0.0.1:{ports[1]}"]))
                fleet_par = t.executor.parallelism
                t0 = time.perf_counter()
                h_remote = t.run()
                remote_timings.append(time.perf_counter() - t0)
                t.close()
            remote_s = min(remote_timings)
            ratio = remote_s / max(thread_s, 1e-9)
            remote_exact = all(e.value == _bench_value(e.point)
                               for e in h_remote.evals)
            rows.append({"mode": "remote_vs_thread", "algo": "random",
                         "parallelism": parallelism,
                         "fleet_parallelism": fleet_par,
                         "thread_seconds": thread_s,
                         "remote_seconds": remote_s,
                         "remote_timings": [round(s, 4)
                                            for s in remote_timings],
                         "ratio": round(ratio, 4),
                         "n_evals": len(h_remote),
                         "values_exact": remote_exact,
                         "best_thread": h_thread.best().value,
                         "best_remote": h_remote.best().value})
            emit(f"remotebench,random,{parallelism},thread={thread_s:.3f},"
                 f"remote={remote_s:.3f},ratio={ratio:.2f}")

            # -- worker kill mid-run: reinjection + exactly-once ----------
            t = Tuner(objective, make_space(),
                      TunerConfig(algorithm="random", budget=budget, seed=0,
                                  verbose=False, memo_cache_path=memo_kill,
                                  workers=[f"127.0.0.1:{ports[0]}",
                                           f"127.0.0.1:{ports[2]}"]))
            # kill once the memo proves the run is underway (>= 2 results
            # flushed): deterministic mid-run, unlike a wall-clock timer
            def kill_when_underway():
                give_up = time.time() + 30
                while time.time() < give_up:
                    try:
                        if len(json.loads(
                                pathlib.Path(memo_kill).read_text())) >= 2:
                            break
                    except (OSError, json.JSONDecodeError):
                        pass
                    time.sleep(0.01)
                workers[2].kill()

            killer = threading.Thread(target=kill_when_underway, daemon=True)
            killer.start()
            t0 = time.perf_counter()
            h_kill = t.run()
            kill_run_s = time.perf_counter() - t0
            t.close()
            killer.join(timeout=35)
            measured = [e for e in h_kill.evals
                        if not e.meta.get("memoized")]
            keys = [tuple(e.point[k] for k in point_key) for e in measured]
            kill_lost = budget - len(h_kill)
            kill_double = len(keys) - len(set(keys))
            kill_exact = all(e.value == _bench_value(e.point)
                             for e in h_kill.evals)
            worker_was_killed = workers[2].poll() is not None
            rows.append({"mode": "remote_worker_kill",
                         "kill_run_seconds": round(kill_run_s, 3),
                         "worker_was_killed": worker_was_killed,
                         "n_evals": len(h_kill), "lost": kill_lost,
                         "double_recorded": kill_double,
                         "values_exact": kill_exact})
            emit(f"remotekill,killed={worker_was_killed},"
                 f"n={len(h_kill)},lost={kill_lost},double={kill_double},"
                 f"exact={kill_exact}")

            # -- memo written by the tuner host, honored across backends --
            counting = CountingEvaluator(objective)
            t = Tuner(counting, make_space(),
                      TunerConfig(algorithm="random", budget=budget, seed=0,
                                  verbose=False, parallelism=parallelism,
                                  memo_cache_path=memo_clean))
            h_memo = t.run()
            t.close()
            rows.append({"mode": "remote_memo_cross_backend",
                         "second_run_re_evals": counting.calls,
                         "n_evals": len(h_memo)})
            emit(f"remotememo,second_run_re_evals={counting.calls}")

        ok = (remote_s <= thread_s * 1.5 + 0.25
              and remote_exact
              and worker_was_killed  # else the kill gate proved nothing
              and kill_lost == 0 and kill_double == 0 and kill_exact
              and counting.calls == 0)
        return rows, ok
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
        for w in workers:
            w.wait(timeout=10)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=sorted(CELLS))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--fast", action="store_true",
                    help="trace 1 and 2 periods and extrapolate (each row says so)")
    ap.add_argument("--chips-per-pod", type=int, default=CHIPS_PER_POD)
    ap.add_argument("--out", default=None)
    ap.add_argument("--microbench", action="store_true",
                    help="run the ask/tell parallel-executor micro-benchmark")
    ap.add_argument("--async-loop", action="store_true",
                    help="add the completion-driven vs batch-barrier "
                         "comparison + memo-cache re-evaluation check")
    ap.add_argument("--multi-fidelity", action="store_true",
                    help="add the successive-halving vs full-fidelity "
                         "time-to-target comparison + exactly-once "
                         "preemption accounting check (runs at "
                         "max(--budget, 20) full-measurement equivalents: "
                         "smaller budgets leave too few rung completions "
                         "for a stable gate)")
    ap.add_argument("--remote", action="store_true",
                    help="add the remote-executor gate: two localhost "
                         "worker daemons vs the thread backend at the same "
                         "parallelism, a mid-run worker kill (reinjection + "
                         "exactly-once accounting), and the memo shared "
                         "across backends")
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero if the async loop does not beat the "
                         "batch loop, the memo cache re-evaluates, a BO "
                         "suggestion goes untimed, successive halving "
                         "misses its time-to-target / accounting gates, or "
                         "the remote backend misses its throughput / "
                         "exactly-once / shared-memo gates (CI gate)")
    ap.add_argument("--parallelism", type=int, default=4)
    ap.add_argument("--budget", type=int, default=24)
    args = ap.parse_args(argv)
    ok = True
    failures = []
    if args.microbench or args.async_loop or args.multi_fidelity \
            or args.remote:
        rows = []
        if args.microbench:
            rows += run_microbench(budget=args.budget,
                                   parallelism=args.parallelism)
        if args.async_loop:
            async_rows, ok_async = run_async_comparison(
                budget=min(args.budget, 16), parallelism=args.parallelism)
            rows += async_rows
            if not ok_async:
                failures.append(
                    "async-loop: completion-driven loop did not beat the "
                    "batch barrier, the memo cache re-evaluated, or a BO "
                    "suggestion was missing from ask_seconds")
        if args.multi_fidelity:
            mf_budget = max(args.budget, 20)
            if mf_budget != args.budget:
                print(f"mfbench_note,budget_floored,{args.budget}->"
                      f"{mf_budget} (gate needs enough rung completions)")
            mf_rows, ok_mf = run_multi_fidelity_comparison(
                budget=mf_budget, parallelism=args.parallelism)
            rows += mf_rows
            if not ok_mf:
                failures.append(
                    "multi-fidelity: successive halving did not reach within "
                    "1% of the full-fidelity best in <= 0.5x its wall clock, "
                    "or preemption lost/double-recorded a result")
        if args.remote:
            remote_rows, ok_remote = run_remote_comparison(
                budget=min(args.budget, 16), parallelism=args.parallelism)
            rows += remote_rows
            if not ok_remote:
                failures.append(
                    "remote: the two-worker fleet was not throughput-"
                    "comparable to the thread backend, a mid-run worker "
                    "kill lost or double-recorded a result, or the memo "
                    "written by the remote run was not honored by a "
                    "thread-backend re-run")
        ok = not failures
    else:
        if not args.cell:
            ap.error("--cell is required unless --microbench, --async-loop, "
                     "--multi-fidelity or --remote is given")
        rows = run(args.cell, multi_pod=args.multi_pod, fast=args.fast,
                   chips_per_pod=args.chips_per_pod)
    if args.out:
        p = pathlib.Path(args.out)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(rows, indent=1))
    if args.check and not ok:
        raise SystemExit("benchmark regression: " + "; ".join(failures))


if __name__ == "__main__":
    main()
