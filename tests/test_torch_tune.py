"""``repro_torch.launch.tune`` against the reference's ``repro.launch.tune``.

The analysis is stubbed in both packages by one deterministic function of
the backend config (``analyze_cell``), so that the comparison is of the
CLI, the evaluator and the engines: at one seed GA, NMS, random search
and BO give the reference's history, point for point and value for value
(exact).  The reference's CLI is given the one-card space (its mesh
dims taken out) and the card's 80 GB, which are the port's.  One real run traces qwen2-0.5b's
decode step for one card, and a second run from its memo cache evaluates
nothing.
"""
import functools
import math
import os
import sys
import types

import pytest

MESH_DIMS = ("log2_dp", "sharding_style")


def _record(bc):
    """A deterministic analysis: throughput and peak bytes from the point."""
    value = (1e5 * math.log2(bc.block_q) / (1 + abs(bc.block_kv - 512) / 256)
             / bc.microbatches ** 0.5 * {"none": 1.0, "dots": 0.9, "names": 0.8,
                                         "full": 0.7}[bc.remat])
    mem = 1.2e11 * (2 if bc.remat == "none" else 1) / bc.microbatches + 1e7 * bc.block_q
    return {"skipped": False, "memory": {"per_device_B": mem},
            "roofline": {"throughput_tok_s": value}}


def _stub(monkeypatch, name, calls, meshes=None):
    mod = types.ModuleType(name)

    def analyze_cell(arch, shape_name, *, multi_pod=False, bc=None, chips_per_pod=1,
                     fast=False):
        calls.append(bc)
        if meshes is not None:
            meshes.append((multi_pod, chips_per_pod))
        return _record(bc)

    mod.analyze_cell = analyze_cell
    monkeypatch.setitem(sys.modules, name, mod)


@pytest.fixture
def ref_tune(monkeypatch):
    # importing the reference's CLI sets 512 host devices unless
    # XLA_FLAGS is set; keep whatever the process has
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    import repro.launch.tune as rt

    space = rt.backend_space

    def backend_space(cfg, *, kind="train"):
        return [d for d in space(cfg, kind=kind) if d["name"] not in MESH_DIMS]

    monkeypatch.setattr(rt, "backend_space", backend_space)
    # and the card's 80 GB in place of the reference's 16 GB a chip
    monkeypatch.setattr(rt, "RooflineEvaluator",
                        functools.partial(rt.RooflineEvaluator, hbm_bytes=80e9))
    return rt


def _argv(algo, budget, *extra):
    return ["--arch", "qwen2-0.5b", "--shape", "train_4k", "--algo", algo,
            "--budget", str(budget), "--seed", "0", *extra]


def _trace(history):
    return [(e.point, e.value) for e in history.evals]


@pytest.mark.parametrize("algo,budget", [("ga", 12), ("nms", 12), ("random", 10), ("bo", 11)])
def test_history_equals_the_reference(algo, budget, ref_tune, monkeypatch):
    import repro_torch.launch.tune as pt

    ours_calls, ref_calls = [], []
    _stub(monkeypatch, "repro_torch.launch.dryrun", ours_calls)
    _stub(monkeypatch, "repro.launch.dryrun", ref_calls)
    ours = pt.main(_argv(algo, budget))
    ref = ref_tune.main(_argv(algo, budget))
    assert _trace(ours) == _trace(ref)
    assert len(ours.evals) == len(ref.evals) >= budget - 1
    assert [c.__dict__ for c in ours_calls] == [c.__dict__ for c in ref_calls]
    # the stub puts some points above 80 GB: they failed in both
    assert any(e.value == -math.inf for e in ours.evals) or algo == "nms"


def test_a_second_run_from_the_memo_cache_evaluates_nothing(tmp_path, monkeypatch, capsys):
    import repro_torch.launch.tune as pt

    calls = []
    _stub(monkeypatch, "repro_torch.launch.dryrun", calls)
    memo, out = str(tmp_path / "memo.json"), str(tmp_path / "hist.json")
    first = pt.main(_argv("bo", 8, "--memo-cache", memo, "--out", out))
    n = len(calls)
    assert n == len({tuple(sorted(c.__dict__.items())) for c in calls}) >= 7
    second = pt.main(_argv("bo", 8, "--memo-cache", memo))
    assert len(calls) == n  # nothing analysed again
    assert _trace(second) == _trace(first)
    assert all(e.meta.get("memoized") for e in second.evals)
    assert "[tune] best throughput" in capsys.readouterr().out


def test_multi_pod_is_not_ported(monkeypatch):
    """(Named for what it held before the port reached more than one card.)
    ``--multi-pod`` now runs: two pods of ``--chips-per-pod`` chips reach
    the analysis, and the space has the mesh dims."""
    import repro_torch.launch.tune as pt

    calls, meshes = [], []
    _stub(monkeypatch, "repro_torch.launch.dryrun", calls, meshes)
    hist = pt.main(_argv("random", 2, "--multi-pod", "--chips-per-pod", "256"))
    assert len(hist.evals) == 2 and set(meshes) == {(True, 256)}
    assert set(MESH_DIMS) <= set(hist.evals[0].point)


@pytest.mark.parametrize("algo,budget", [("ga", 10), ("bo", 9)])
def test_history_at_a_pod_equals_the_reference(algo, budget, monkeypatch):
    """At the reference's 256-chip pod the port's CLI gives the reference's
    history on the reference's own space, mesh dims included (its default)."""
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    import repro.launch.tune as rt
    import repro_torch.launch.tune as pt

    monkeypatch.setattr(rt, "RooflineEvaluator",
                        functools.partial(rt.RooflineEvaluator, hbm_bytes=80e9))
    ours_calls, ref_calls, meshes = [], [], []
    _stub(monkeypatch, "repro_torch.launch.dryrun", ours_calls, meshes)
    _stub(monkeypatch, "repro.launch.dryrun", ref_calls)
    ours = pt.main(_argv(algo, budget, "--chips-per-pod", "256"))
    ref = rt.main(_argv(algo, budget))
    assert _trace(ours) == _trace(ref)
    assert [c.__dict__ for c in ours_calls] == [c.__dict__ for c in ref_calls]
    assert set(meshes) == {(False, 256)}
    assert {d for d in MESH_DIMS} <= set(ours.evals[0].point)


def test_a_real_run_traces_one_card(tmp_path, capsys):
    """Two decode points of qwen2-0.5b at full width, traced for one H100:
    both fit (about 60 GB), memory-bound at the card's 3.35 TB/s."""
    import repro_torch.launch.tune as pt

    memo = str(tmp_path / "memo.json")
    hist = pt.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k", "--algo", "random",
                    "--budget", "2", "--memo-cache", memo])
    assert len(hist.evals) == 2
    for e in hist.evals:
        assert math.isfinite(e.value)
        roof = e.meta["roofline"]
        assert roof["bottleneck"] == "memory" and roof["fits_hbm"] is True
        assert 50e9 < e.meta["mem_per_device_B"] < 80e9
    assert set(hist.evals[0].point) == {"block_q", "block_kv"}  # no mesh dims on one card
    again = pt.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k", "--algo", "random",
                     "--budget", "2", "--memo-cache", memo])
    assert all(e.meta.get("memoized") for e in again.evals)
    assert "XLA_FLAGS" not in open(pt.__file__).read().split('"""', 2)[2]


def test_the_example_runs_the_tuning_cli(tmp_path, monkeypatch):
    from repro_torch.examples import tune_backend

    calls = []
    _stub(monkeypatch, "repro_torch.launch.dryrun", calls)
    hist = tune_backend.main(["--budget", "3", "--algo", "random",
                              "--memo-cache", str(tmp_path / "m.json"),
                              "--cache", str(tmp_path / "c.json")])
    assert len(hist.evals) == 3 and len(calls) == 3
