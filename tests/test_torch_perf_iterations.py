"""``repro_torch.benchmarks.perf_iterations`` against the reference's
``benchmarks/perf_iterations.py``.

* The synthetic landscape and its skewed cost are the reference's, bit for
  bit, and so are the §Perf cells.
* ``run`` gives the reference's row keys and values on the same analysis
  records, and runs for real on a small cell (decode_32k on a 2x2 pod,
  fast analysis).
* The gates' accounting: successive halving loses and double-records
  nothing, a memo re-run evaluates nothing, every BO suggestion is on
  ``ask_seconds``, and a remote fleet survives a worker kill exactly once.
  Wall-clock ratios are the gates of ``--check`` only: under a loaded test
  run they read the host's load, not the code.
"""
import itertools
import math
import sys
import types

import benchmarks.perf_iterations as ref
from repro_torch.benchmarks import perf_iterations as pi

SPACE = list(itertools.product(range(1, 17), range(0, 61, 5), (1, 2, 3)))


def test_the_landscape_and_its_skew_are_the_references_bit_for_bit(monkeypatch):
    for a, b, c in SPACE:
        p = {"inter_op": a, "intra_op": b, "build": c}
        assert pi._bench_value(p) == ref._bench_value(p)
    assert (pi._SKEW_FAST_S, pi._SKEW_SLOW_S) == (ref._SKEW_FAST_S, ref._SKEW_SLOW_S)
    slept = {"ours": [], "ref": []}
    for mod, key in ((pi, "ours"), (ref, "ref")):
        monkeypatch.setattr(mod.time, "sleep", slept[key].append)
        for a, b, c in SPACE[::7]:
            mod._skewed_sleep_value({"inter_op": a, "intra_op": b, "build": c})
    assert slept["ours"] == slept["ref"]
    assert pi.CELLS == ref.CELLS
    assert pi._bench_space().to_dicts() == ref._bench_space().to_dicts()


def _record(bc, chips=256):
    v = 1e6 * bc.block_q / (1 + bc.microbatches)
    return {"skipped": False, "mesh": {"data": 16, "model": 16},
            "cost": {"analysis": "full"}, "compile_seconds": 1.5,
            "collectives": {"weighted_bytes": 2e9},
            "roofline": {"compute_s": 0.1, "memory_s": 0.2 * bc.microbatches,
                         "collective_s": 0.05, "bottleneck": "memory",
                         "est_step_s": 0.2 * bc.microbatches, "throughput_tok_s": v,
                         "mfu": 0.3, "mem_per_device_GB": 40.0 / bc.microbatches,
                         "fits_hbm": True}}


def test_run_gives_the_reference_rows_on_the_same_records(monkeypatch):
    calls = {"ours": [], "ref": []}
    for name, key in (("repro_torch.launch.dryrun", "ours"), ("repro.launch.dryrun", "ref")):
        mod = types.ModuleType(name)

        def analyze_cell(arch, shape_name, *, multi_pod=False, bc=None, chips_per_pod=256,
                         fast=False, key=key):
            calls[key].append((arch, shape_name, multi_pod, dict(bc.__dict__), chips_per_pod))
            return _record(bc)

        mod.analyze_cell = analyze_cell
        monkeypatch.setitem(sys.modules, name, mod)
    lines = {"ours": [], "ref": []}
    for cell in sorted(ref.CELLS):
        ours = pi.run(cell, emit=lines["ours"].append)
        want = ref.run(cell, emit=lines["ref"].append)
        for o, w in zip(ours, want):
            assert set(w) <= set(o) and {k: o[k] for k in w} == w
        assert len(ours) == len(want)
    assert lines["ours"] == lines["ref"]
    # the reference's pod: 256 chips, as its analyze_cell defaults to
    assert [c[:4] for c in calls["ours"]] == [c[:4] for c in calls["ref"]]
    assert {c[4] for c in calls["ours"]} == {256}


def test_run_traces_a_small_cell(monkeypatch):
    monkeypatch.setitem(pi.CELLS, "tiny", {
        "arch": "qwen2-0.5b", "shape": "decode_32k",
        "variants": [("baseline", {"log2_dp": 1}),
                     ("bf16 weights", {"log2_dp": 1, "serve_bf16_params": True})]})
    rows = pi.run("tiny", emit=lambda *_: None, fast=True, chips_per_pod=4)
    assert [r["mesh"] for r in rows] == [{"data": 2, "model": 2}] * 2
    assert all(r["analysis"] == "fast" and r["collective_bytes"] > 0 for r in rows)
    assert rows[1]["mem_GB"] < rows[0]["mem_GB"]  # half the weights' bytes


def test_successive_halving_loses_and_double_records_nothing():
    rows, _ok = pi.run_multi_fidelity_comparison(budget=20, parallelism=4, fast_s=0.01,
                                                 slow_s=0.08, emit=lambda *_: None)
    row = rows[0]
    assert row["lost_results"] == 0 and row["double_recorded"] == 0
    assert row["mf_best_full_fidelity"] is not None


def test_a_memo_rerun_evaluates_nothing_and_every_bo_ask_is_timed():
    rows, _ok = pi.run_async_comparison(budget=8, parallelism=4, fast_s=0.005,
                                        slow_s=0.02, emit=lambda *_: None)
    by = {r["mode"]: r for r in rows}
    assert by["memo_cache_second_run"]["second_run_re_evals"] == 0
    assert by["memo_cache_second_run"]["first_run_evals"] == 8
    asks = by["bo_ask_seconds"]
    assert asks["asks"] > 0 and asks["untimed"] == 0
    timed = [r for r in rows if r["mode"] == "bo_suggestion_overhead"]
    assert all(len(r["per_ask_seconds"]) > 0 and math.isfinite(r["max_ask_seconds"])
               for r in timed)


def test_a_remote_fleet_survives_a_worker_kill_exactly_once():
    rows, _ok = pi.run_remote_comparison(budget=8, parallelism=4, emit=lambda *_: None)
    by = {r["mode"]: r for r in rows}
    kill = by["remote_worker_kill"]
    assert kill["worker_was_killed"] and kill["lost"] == 0 and kill["double_recorded"] == 0
    assert kill["values_exact"] and kill["n_evals"] == 8
    assert by["remote_vs_thread"]["values_exact"]
    assert by["remote_memo_cross_backend"]["second_run_re_evals"] == 0
