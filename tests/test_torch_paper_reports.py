"""The paper's reports on the surrogate: the port's Fig. 5, Fig. 6 and
Table 2 emit the reference's rows.

At budget 8 every engine is deterministic across the packages (BO's first 8
points are its Latin-hypercube design), so the rows are compared as text.
Fig. 6's BO run is the reference's fixed 50 iterations: its gap row is
held within the surrogate's 2 % noise, and its ``exhaustive_hours`` field
is left out.  Both packages run in this one process: the surrogate's noise
hashes with Python's salted ``hash()``.
"""
import re

import pytest
import torch

from benchmarks import fig5_tuning_curves as ref_fig5
from benchmarks import fig6_exhaustive as ref_fig6
from benchmarks import table2_exploration as ref_table2
from repro_torch.benchmarks import fig5_tuning_curves as fig5
from repro_torch.benchmarks import fig6_exhaustive as fig6
from repro_torch.benchmarks import table2_exploration as table2

BUDGET = 8
SCHEDULERS = ["asha", "hyperband", "pbt"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(fn, *args, **kwargs):
    out = []
    ret = fn(*args, emit=out.append, **kwargs)
    return out, ret


def test_fig5_engines_emit_the_reference_rows():
    got, summary = _rows(fig5.run, budget=BUDGET, seeds=2)
    want, ref_summary = _rows(ref_fig5.run, budget=BUDGET, seeds=2)
    assert got == want
    assert summary == ref_summary
    assert sum(r.startswith("fig5,") for r in got) == 5 * 3 * 2 * BUDGET
    assert sum(r.startswith("fig5_winner,") for r in got) == 5


def test_fig5_schedulers_emit_the_reference_rows():
    got, _ = _rows(fig5.run_schedulers, SCHEDULERS, budget=BUDGET, seeds=1)
    want, _ = _rows(ref_fig5.run_schedulers, SCHEDULERS, budget=BUDGET, seeds=1)
    assert got == want
    assert {r.split(",")[2] for r in got if r.startswith("fig5_sched,")} == set(SCHEDULERS)


def test_fig5_cli_takes_the_scheduler_comparison(capsys):
    fig5.main(["--scheduler", "asha", "--budget", "4", "--seeds", "1"])
    rows = capsys.readouterr().out.splitlines()
    assert rows and all(r.startswith("fig5_sched") for r in rows)


def _no_hours(rows):
    return [re.sub(r"exhaustive_hours=[^,]*,", "", r) for r in rows]


def test_fig6_emits_the_reference_rows():
    got, res = _rows(fig6.run, "dense_lm")
    want, ref_res = _rows(ref_fig6.run, "dense_lm")
    gap = [r for r in got if r.startswith("fig6_tuner_gap,")]
    ref_gap = [r for r in want if r.startswith("fig6_tuner_gap,")]
    assert _no_hours([r for r in got if r not in gap]) == \
        _no_hours([r for r in want if r not in ref_gap])
    assert res["best"] == ref_res["best"] and res["sensitivity"] == ref_res["sensitivity"]
    assert len(gap) == 1 and abs(res["bo_gap"] - ref_res["bo_gap"]) <= 0.02
    assert any(r.startswith("fig6_cost,dense_lm,grid=384,") for r in got)


def test_table2_emits_the_reference_rows():
    got, means = _rows(table2.run, budget=BUDGET)
    want, ref_means = _rows(ref_table2.run, budget=BUDGET)
    assert got == want and means == ref_means


def test_table2_schedulers_emit_the_reference_rows():
    got, means = _rows(table2.run_schedulers, SCHEDULERS, budget=BUDGET)
    want, ref_means = _rows(ref_table2.run_schedulers, SCHEDULERS, budget=BUDGET)
    assert got == want and means == ref_means
