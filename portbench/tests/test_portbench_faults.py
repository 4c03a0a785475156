"""The check catches what it is there to catch.  On the CPU (no look for a
card), each cell's run at the tiny size with the program broken underneath
comes out not correct, once for each fault the cell can have; a sound run
comes out correct.  On the card (``card``), each cell at its own size:
the sound program within every limit and the control (the reference in
the precision below the cell's) over one of them."""
import time

import pytest
import torch

from portbench import faults, harness, spec
from portbench.tests.tiny import shrink

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _faults(cell):
    training = spec.cell(cell)["driver"] == "train_steps"
    return [(cell, f) for f in (faults.TRAINING if training else faults.SERVING)]


def _run(cell, seed, *, device, workload=None, after=None, seconds=0.2):
    return harness.run_cell(cell, seed, seconds, False, device=device,
                            started=time.perf_counter(), workload=workload, after=after,
                            log=lambda *a: None)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    r = _run(cell, 2**33 + 5, device=torch.device("cpu"), workload=shrink(spec.workload(cell)))
    assert r["correct"], r["compared"]


@pytest.mark.parametrize("cell,fault", [x for c in CELLS for x in _faults(c)])
def test_a_broken_run_is_not_correct(cell, fault):
    undo = faults.plant(fault, spec.cell(cell)["driver"] == "train_steps")
    try:
        r = _run(cell, 2**33 + 5, device=torch.device("cpu"),
                 workload=shrink(spec.workload(cell)))
    finally:
        undo()
    assert not r["correct"], r["compared"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card_the_control_fails_and_the_program_passes(cell, card):
    drv = spec.driver(spec.cell(cell)["driver"])
    r = _run(cell, 2**34 + 9, device=card, after=drv.control, seconds=2.0)
    assert r["correct"], r["compared"]
    limits = {k: v["limit"] for k, v in r["compared"].items()}
    assert any(r["after"][k] > limits[k] for k in limits), (r["after"], limits)
