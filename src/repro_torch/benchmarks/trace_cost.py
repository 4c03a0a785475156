"""What the dry run's trace of a train step costs, with and without the
microbatch replay.

    PYTHONPATH=src python -m repro_torch.benchmarks.trace_cost [--microbatches 1,4,16]

Needs no card.  For each microbatch count it traces qwen2-0.5b's train_4k
step at remat ``dots`` and block_q 256 (the tuner's kind of point;
``launch/dryrun.py::trace_cell``, one card) twice: as the dry run does
(pure ops' results cached by layout, and the microbatch loop traced twice
and replayed thereafter, ``trace_hooks.repeat``), and with the op cache
alone (every microbatch traced).  Prints one JSON line each: both traces'
seconds and ops, and whether their counts and memory are equal.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_config, get_shape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import single_device_mesh
from repro_torch.runtime import trace_hooks
from repro_torch.tuning.parameters import BASELINE

ARCH, SHAPE, POINT = "qwen2-0.5b", "train_4k", {"remat": "dots", "block_q": 256}
FIELDS = ("flops", "traffic_included", "traffic_excluded", "argument_B", "temp_B",
          "output_B", "alias_B", "ops")


def trace(cfg, shape, bc, *, replay: bool):
    """The cell's ``TraceStats``; ``replay=False`` traces every call that the
    step marks as a repeat."""
    if replay:
        return dryrun.trace_cell(cfg, shape, single_device_mesh(), bc)
    orig = trace_hooks.repeat
    trace_hooks.repeat = lambda fn, *args: fn(*args)
    try:
        return dryrun.trace_cell(cfg, shape, single_device_mesh(), bc)
    finally:
        trace_hooks.repeat = orig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--microbatches", default="1,4,16")
    args = ap.parse_args(argv)
    cfg, shape = get_config(ARCH), get_shape(SHAPE)
    rows = []
    for mb in (int(m) for m in args.microbatches.split(",")):
        bc = BASELINE.replace(microbatches=mb, **POINT)
        replayed = trace(cfg, shape, bc, replay=True)
        cache_only = trace(cfg, shape, bc, replay=False)
        row = {"arch": ARCH, "shape": SHAPE, "microbatches": mb, **POINT,
               "replay_seconds": replayed.seconds, "cache_only_seconds": cache_only.seconds,
               "ops": cache_only.ops, "per_device_B": replayed.per_device_B,
               "equal": {k: getattr(replayed, k) == getattr(cache_only, k) for k in FIELDS}}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
