"""Quickstart: the paper's contribution in a few lines.

Tunes the measured training throughput of a dense LM (``dense_lm``:
qwen2-0.5b) over the framework's knobs (batch, microbatches, remat, the
attention tile) with all three of the paper's gradient-free engines, then
prints the per-engine bests and exploration coverage (Table 2 style).

    PYTHONPATH=src python -m repro_torch.examples.quickstart               # the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu  # the CPU

On the card (``--device cuda``, the default; raises when there is none)
the model is qwen2-0.5b at its published width and depth, 512 tokens a
sequence, f32, through the hand-written kernels; ``--device cpu`` runs the
reference's setting: the reduced config, 64 tokens a sequence.
"""
import argparse
import time

from repro_torch.benchmarks.workloads import MEASURED_WORKLOADS, MeasuredEvaluator
from repro_torch.core import SearchSpace, Tuner, TunerConfig

ALGOS = ("bo", "ga", "nms")


def _timed(ask, into: list):
    """``ask`` with the seconds of each call appended to ``into``."""
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return ask(*args, **kwargs)
        finally:
            into.append(time.perf_counter() - t0)

    return timed


def tune(objective, space: SearchSpace, *, budget: int = 12, seed: int = 0,
         algos=ALGOS, verbose: bool = True, emit=print) -> dict:
    """Run each engine on ``objective`` over ``space``.  Per engine: its
    ``history``, ``best`` evaluation, range ``coverage``, wall ``seconds``
    and the seconds of each of its asks (``ask_seconds``)."""
    results = {}
    for algo in algos:
        tuner = Tuner(objective, space,
                      TunerConfig(algorithm=algo, budget=budget, seed=seed,
                                  verbose=verbose))
        asks = []
        tuner.engine.ask = _timed(tuner.engine.ask, asks)
        t0 = time.perf_counter()
        history = tuner.run()
        seconds = time.perf_counter() - t0
        tuner.close()
        best = history.best()
        cov = history.sampled_range_fraction()
        results[algo] = {"history": history, "best": best, "coverage": cov,
                         "seconds": seconds, "ask_seconds": asks}
        emit(f"\n[{algo}] best {best.value:,.0f} tokens/s at {best.point}")
        emit(f"[{algo}] range coverage: "
             + ", ".join(f"{k}={100*v:.0f}%" for k, v in cov.items()) + "\n")

    winner = max(results, key=lambda a: results[a]["best"].value)
    emit(f"winner: {winner} ({results[winner]['best'].value:,.0f} tokens/s)")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    on_card = args.device == "cuda"
    workload = MEASURED_WORKLOADS[0]  # dense_lm (qwen2)
    space = SearchSpace.from_dicts(workload["space"])
    print(f"tuning {workload['name']}: dims={space.names} "
          f"(grid {space.grid_size()}) on {args.device}")

    objective = MeasuredEvaluator(workload, device=args.device, iters=2,
                                  reduced=not on_card, seq_len=512 if on_card else 64)
    return tune(objective, space)


if __name__ == "__main__":
    main()
