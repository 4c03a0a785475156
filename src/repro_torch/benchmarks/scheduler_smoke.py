"""Scheduler-zoo smoke: the gate of the trial schedulers.

Two gates over the ``TrialScheduler`` seam:

* **hedging** — on a skewed objective (low-fidelity screening is
  deterministically biased against part of the space, measurement cost
  proportional to fidelity), HyperBand's staggered brackets must
  *confirm* a value within 1% of the true optimum at **full fidelity**
  in <= ``HB_WALL_RATIO`` x ASHA's wall clock — or confirm it at all
  when ASHA never does (the skew tricks the single aggressive ladder
  into culling the optimum at its bottom rung; brackets hedge);
* **fork-kill** — a PBT run over a real ``launch/worker.py`` fleet
  survives a mid-run SIGKILL of one measurement host: the killed
  worker's in-flight steps (checkpoint-fork ``state`` blobs riding the
  v2 task payload) are reinjected onto the survivor, the run completes
  its budget, and the history holds **0 duplicate and 0 lost**
  (lineage, step) records — exactly-once accounting through fork,
  re-dispatch, and death — with at least one exploit/explore fork
  actually exercised.

Workers serve ``make_fork_objective()`` from this module: value is a
deterministic function of the point plus a small warm-start bonus per
resumed step, so lineages measurably benefit from their checkpoints.

Usage (a CI job runs exactly this):

    PYTHONPATH=src python -m repro_torch.benchmarks.scheduler_smoke --check \
        --out BENCH_schedulers.json
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import signal
import threading
import time

from repro_torch.benchmarks.elastic_smoke import _env, free_port, reap, wait_port

HB_WALL_RATIO = 1.2    # hyperband wall-to-within-1% / asha's must be <= this
HEDGE_SLEEP_S = 0.04   # full-fidelity measurement cost (scales with f)
HEDGE_BUDGET = 60      # full-measurement equivalents per scheduler run
PBT_BUDGET = 30
PBT_STEP_SLEEP_S = 0.05
KILL_AFTER_EVALS = 8


# ---------------------------------------------------------------------------
# gate (a): HyperBand hedges the skew without losing ASHA's wall clock
# ---------------------------------------------------------------------------

def _true_value(p) -> float:
    return float(p["a"] * 10 + p["b"] + (5 if p["c"] == "y" else 0))


def make_skewed_objective():
    """Fidelity-capable objective whose cheap screening lies about part
    of the space: points with odd ``a`` look up to ~60% worse than they
    are at low fidelity (the bias decays linearly with fidelity).  An
    aggressive single ladder culls the true optimum at its bottom rung;
    staggered brackets hedge.  Cost is fidelity-proportional."""
    from repro_torch.tuning.objective import Evaluator

    class SkewedObjective(Evaluator):
        supports_fidelity = True

        def __init__(self):
            self.log = []  # (t, true_value) per real measurement

        def __call__(self, point, fidelity=None):
            f = 1.0 if fidelity is None else float(fidelity)
            time.sleep(HEDGE_SLEEP_S * f)
            v = _true_value(point)
            if point["a"] % 2 == 1:
                v *= 1.0 - 0.6 * (1.0 - f)  # skew: odd-a looks bad cheap
            self.log.append((time.perf_counter(), _true_value(point), f))
            return v, {"cost_seconds": HEDGE_SLEEP_S * f}

    return SkewedObjective()


def _wall_to_within(log, optimum: float, frac: float = 0.01):
    """Seconds from the first measurement until a FULL-fidelity
    measurement confirms a true value within ``frac`` of the optimum;
    None if never.  Cheap screens don't count: a scheduler only "finds"
    the optimum once it has promoted it all the way up, which is exactly
    what the skew tries to prevent."""
    if not log:
        return None
    t0, best = log[0][0], -math.inf
    for t, v, f in log:
        if f < 1.0:
            continue
        best = max(best, v)
        if best >= optimum * (1.0 - frac):
            return t - t0
    return None


def bench_hedging(emit) -> dict:
    from repro_torch.core import (IntDim, CatDim, MultiFidelityConfig, SearchSpace,
                            Tuner, TunerConfig)

    # small enough that both schedulers can cover it within the budget
    # (the gate measures wall clock to the optimum, not whether it is
    # ever found); the optimum sits at odd a, squarely under the skew
    space = SearchSpace([IntDim("a", 0, 5), IntDim("b", 0, 5),
                         CatDim("c", ["x", "y"])])
    optimum = _true_value({"a": 5, "b": 5, "c": "y"})
    walls = {}
    for kind in ("asha", "hyperband"):
        obj = make_skewed_objective()
        # parallelism=1 keeps the random-engine stream deterministic per
        # seed, so the gate never flakes on thread completion order
        t = Tuner(obj, space, TunerConfig(
            algorithm="random", budget=HEDGE_BUDGET, seed=7, verbose=False,
            parallelism=1,
            multi_fidelity=MultiFidelityConfig(
                enabled=True, scheduler=kind, min_fidelity=1 / 9, eta=3)))
        t.run()
        t.close()
        walls[kind] = _wall_to_within(obj.log, optimum)
    both = all(w is not None for w in walls.values())
    ratio = (walls["hyperband"] / walls["asha"]) if both else None
    # the gate: hyperband must confirm the optimum, and do so within
    # HB_WALL_RATIO x asha's wall — where asha never confirming at all
    # (the skew culled the optimum below the top rung) counts as a win
    ok = walls["hyperband"] is not None and (
        walls["asha"] is None
        or walls["hyperband"] <= HB_WALL_RATIO * walls["asha"])
    emit(f"[scheduler-smoke] hedging: asha {walls['asha']} s vs hyperband "
         f"{walls['hyperband']} s to full-fidelity within-1% confirmation "
         f"(ratio {ratio if ratio is None else round(ratio, 2)})")
    return {"asha_wall_s": walls["asha"], "hyperband_wall_s": walls["hyperband"],
            "ratio": None if ratio is None else round(ratio, 3),
            "gate": HB_WALL_RATIO, "ok": ok}


# ---------------------------------------------------------------------------
# gate (b): PBT checkpoint-fork survives a mid-run worker SIGKILL
# ---------------------------------------------------------------------------

def make_fork_objective():
    """Deterministic fork-capable objective served by worker daemons:
    each resumed step adds a small warm-start bonus, so checkpoints are
    worth carrying and a dropped ``state`` blob is observable."""
    from repro_torch.tuning.objective import Evaluator

    class ForkObjective(Evaluator):
        supports_fidelity = True
        supports_fork = True

        def __call__(self, point, fidelity=None, resume_state=None):
            time.sleep(PBT_STEP_SLEEP_S)
            warm = int((resume_state or {}).get("warm", 0))
            v = float(point["a"] * 10 + point["b"]) + 0.01 * warm
            return v, {"fork_state": {"warm": warm + 1},
                       "cost_seconds": PBT_STEP_SLEEP_S}

    return ForkObjective()


def bench_fork_kill(root, emit) -> dict:
    from repro_torch.core import (IntDim, MultiFidelityConfig, SearchSpace, Tuner,
                            TunerConfig)

    p1, p2 = free_port(), free_port()
    w1 = _spawn_fork_worker(root, p1)
    w2 = _spawn_fork_worker(root, p2)
    try:
        wait_port(p1)
        wait_port(p2)
        space = SearchSpace([IntDim("a", 0, 9), IntDim("b", 0, 9)])
        mf = MultiFidelityConfig(enabled=True, scheduler="pbt",
                                 min_fidelity=0.5)
        mf.pbt.population = 4
        tuner = Tuner(make_fork_objective(), space, TunerConfig(
            algorithm="random", budget=PBT_BUDGET, seed=11, verbose=False,
            workers=[f"127.0.0.1:{p1}", f"127.0.0.1:{p2}"],
            multi_fidelity=mf))
        done = threading.Event()

        def _run():
            try:
                tuner.run()
            finally:
                done.set()

        t = threading.Thread(target=_run, daemon=True)
        t.start()
        # kill one measurement host once the run is warm (steps in
        # flight, forks plausible): its tasks — state blobs included —
        # must be reinjected onto the survivor
        deadline = time.time() + 60
        while len(tuner.history) < KILL_AFTER_EVALS \
                and time.time() < deadline:
            time.sleep(0.02)
        killed_at = len(tuner.history)
        w1.send_signal(signal.SIGKILL)
        w1.wait(timeout=10)
        finished = done.wait(timeout=120)
        stats = tuner.rung_scheduler.stats()[0]
        pairs = [(e.lineage, e.rung) for e in tuner.history.evals]
        dupes = len(pairs) - len(set(pairs))
        lost = 0 if finished else 1  # a hung run == lost work
        warm = sum(1 for e in tuner.history.evals
                   if (e.meta.get("fork_state") or {}).get("warm", 0) > 1)
        tuner.close()
    finally:
        reap(w1, w2)
    emit(f"[scheduler-smoke] fork-kill: {len(pairs)} steps recorded "
         f"(killed host at {killed_at}), {dupes} duplicates, "
         f"forks={stats['forks']}, warm-resumed={warm}")
    return {"steps": len(pairs), "killed_at_evals": killed_at,
            "duplicates": dupes, "lost": lost, "forks": stats["forks"],
            "warm_resumed": warm, "finished": finished,
            "ok": (finished and dupes == 0 and lost == 0
                   and stats["forks"] >= 1 and warm >= 1)}


def _spawn_fork_worker(root, port):
    import subprocess
    import sys

    cmd = [sys.executable, "-m", "repro_torch.launch.worker",
           "--host", "127.0.0.1", "--port", str(port), "--slots", "2",
           "--heartbeat-s", "0.2", "--objective",
           "repro_torch.benchmarks.scheduler_smoke:make_fork_objective()"]
    return subprocess.Popen(cmd, env=_env(root), cwd=str(root),
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)


def run_smoke(emit=print) -> dict:
    root = pathlib.Path(__file__).resolve().parents[3]
    t0 = time.perf_counter()
    hedging = bench_hedging(emit)
    fork_kill = bench_fork_kill(root, emit)
    gates = {
        "hyperband_hedges_within_wall_gate": hedging["ok"],
        "pbt_fork_survives_sigkill": fork_kill["ok"],
    }
    return {"bench": "scheduler_smoke",
            "hb_wall_ratio_gate": HB_WALL_RATIO,
            "wall_s": round(time.perf_counter() - t0, 3),
            "hedging": hedging, "fork_kill": fork_kill,
            "gates": gates, "ok": all(gates.values())}


def main(argv=None):
    import sys

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="write the JSON artifact here")
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero if any gate fails")
    args = ap.parse_args(argv)

    result = run_smoke()
    print(json.dumps(result, indent=2))
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(result, indent=2))
        print(f"[scheduler-smoke] wrote {args.out}")
    if args.check and not result["ok"]:
        failed = [g for g, ok in result["gates"].items() if not ok]
        print(f"[scheduler-smoke] FAILED gates: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
