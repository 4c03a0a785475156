"""The port's kernel-tuning objective and sweep against the reference's, on
``device="cpu"`` (each kernel's plain version): registry spaces, the
evaluator and fidelity contracts, point hygiene, strict feasibility, the
cold-then-warm sweep, and the wall-clock loop run on the same scripted
clock in both packages.  The last test closes the loop on the CPU: sweep,
persist, build the serve steps with the DB, and check the kernels ran with
the recorded tiles."""
import math
import types

import jax.numpy as jnp
import pytest
import torch

import repro.tuning.evaluator as jeval
import repro_torch.kernels.ops as ops
import repro_torch.tuning.evaluator as teval
from repro.tuning.kernel_objective import KERNELS as REF_KERNELS
from repro.tuning.kernel_objective import kernel_space as ref_kernel_space
from repro_torch.benchmarks.kernel_sweep import lookup_latency_ms, run_sweep
from repro_torch.core.space import SearchSpace
from repro_torch.tuning.kernel_objective import KERNELS, KernelTuneEvaluator, kernel_space
from repro_torch.tuning.tundb import TuningDB, hardware_fingerprint

#: shapes of the models the repo supports at full width (the on-card sweep's)
FULL_WIDTH = {
    "ssm_scan": {"B": 2, "S": 2048, "D": 8192, "N": 16},
    "gla_scan": {"B": 2, "S": 2048, "H": 40, "dk": 64, "dv": 64},
    "flash_attention": {"B": 8, "Sq": 512, "Sk": 512, "H": 14, "K": 2, "dh": 64},
    "decode_attention": {"B": 8, "H": 14, "K": 2, "dh": 64, "Smax": 576},
    "rmsnorm": {"rows": 4096, "D": 896},
}
NAMES = sorted(KERNELS)


def test_registry_has_the_reference_kernels_and_default_shapes():
    assert sorted(REF_KERNELS) == NAMES
    for name in NAMES:
        assert KERNELS[name].shape == REF_KERNELS[name].shape
        assert set(KERNELS[name].knobs) == set(REF_KERNELS[name].knobs)


@pytest.mark.parametrize("width", ["default", "full"])
@pytest.mark.parametrize("name", NAMES)
def test_registry_spaces_equal_the_reference(name, width):
    shape = None if width == "default" else FULL_WIDTH[name]
    dims = kernel_space(name, shape)
    assert dims == ref_kernel_space(name, shape)
    space = SearchSpace.from_dicts(dims)
    assert space.grid_size() >= 2
    assert set(space.names) <= set(KERNELS[name].knobs)


def test_host_knobs_wait_for_a6():
    with pytest.raises(NotImplementedError, match="A6"):
        kernel_space("rmsnorm", host_knobs=True)


def test_evaluator_measures_and_reports_meta():
    ev = KernelTuneEvaluator("rmsnorm", {"rows": 32, "D": 32}, iters=2, device="cpu")
    value, meta = ev({"block_rows": 16})
    assert math.isfinite(value) and value > 0
    assert meta["kernel"] == "rmsnorm"
    assert meta["cost_seconds"] > 0 and meta["iters"] >= 2
    assert "fidelity" not in meta and meta["build_seconds"] > 0


def test_evaluator_fidelity_contract():
    ev = KernelTuneEvaluator("gla_scan", {"B": 1, "S": 16, "H": 1, "dk": 8, "dv": 8},
                             iters=2, device="cpu")
    assert ev.supports_fidelity
    v_part, meta = ev({"chunk": 8}, fidelity=0.25)
    assert math.isfinite(v_part)
    assert meta["fidelity"] == 0.25  # partial measurements are labeled


def test_evaluator_rejects_stray_point_keys():
    ev = KernelTuneEvaluator("rmsnorm", {"rows": 16, "D": 16}, device="cpu")
    with pytest.raises(ValueError, match="blok_rows"):
        ev({"blok_rows": 8})
    with pytest.raises(ValueError, match="host_devices"):
        ev({"block_rows": 8, "host_devices": 2})


def test_unknown_kernel_is_loud():
    with pytest.raises(ValueError, match="unknown kernel"):
        KernelTuneEvaluator("nope", device="cpu")


@pytest.mark.parametrize("name,point", [
    ("ssm_scan", {"chunk": 1024, "block_d": 1024}),    # B/C double-buffered > 227 KB
    ("ssm_scan", {"chunk": 2048, "block_d": 64}),      # B/C staging > 227 KB
    ("gla_scan", {"chunk": 512}),                      # r/k/w staging > 227 KB
    ("flash_attention", {"block_q": 512, "block_kv": 64}),
    ("decode_attention", {"block_kv": 512}),           # > 512 threads a block
])
def test_infeasible_point_scores_neg_inf_before_any_launch(name, point, monkeypatch):
    spec = KERNELS[name]
    built = []
    monkeypatch.setattr(spec, "_build_fn", lambda *a: built.append(a))
    ev = KernelTuneEvaluator(name, FULL_WIDTH[name], device="cpu")
    value, meta = ev(point)
    assert value == -math.inf and "infeasible" in meta["error"]
    assert built == []  # no inputs were made, nothing was launched
    # the wrapper alone would have clamped the request and run it
    assert spec.effective(FULL_WIDTH[name], point) != spec.config(point)


def test_sweep_cold_then_warm_measures_zero(tmp_path):
    path = str(tmp_path / "tundb.json")
    fp = hardware_fingerprint("cpu")
    kernels = ["rmsnorm", "gla_scan", "ssm_scan"]
    db = TuningDB(path, fingerprint=fp)
    rows, measured = run_sweep(kernels, db, budget=2, iters=2, device="cpu",
                               emit=lambda *a: None)
    assert measured > 0 and len(db) == 3
    for r in rows:
        assert not r["skipped"] and math.isfinite(r["value"]) and r["step_seconds"] > 0
    warm = TuningDB(path, fingerprint=fp)
    rows2, measured2 = run_sweep(kernels, warm, budget=2, iters=2, device="cpu",
                                 emit=lambda *a: None)
    assert measured2 == 0 and all(r["skipped"] for r in rows2)
    assert [r["best"] for r in rows2] == [r["best"] for r in rows]
    assert lookup_latency_ms(warm, kernels, trials=20) < 1.0


def _scripted_clock(deltas):
    """perf_counter returning a fixed sequence: each call advances by the
    next delta (cycled)."""
    state = {"t": 100.0, "i": 0}

    def perf_counter():
        state["t"] += deltas[state["i"] % len(deltas)]
        state["i"] += 1
        return state["t"]

    return types.SimpleNamespace(perf_counter=perf_counter)


@pytest.mark.parametrize("adaptive,fidelity", [(True, None), (True, 0.25),
                                               (False, None), (False, 0.5)])
def test_wallclock_evaluator_equals_reference_on_a_scripted_clock(monkeypatch, adaptive,
                                                                  fidelity):
    # step times alternate so the adaptive loop needs several samples
    deltas = [0.25, 0.001, 0.004, 0.001, 0.0065, 0.001, 0.0031, 0.001, 0.0052]
    results = []
    for mod, arg in ((jeval, jnp.zeros(())), (teval, torch.zeros(()))):
        monkeypatch.setattr(mod, "time", _scripted_clock(deltas))
        ev = mod.WallClockEvaluator(lambda p: (lambda x: x + 1, (arg,), 64.0),
                                    iters=3, adaptive=adaptive, rel_halfwidth=0.05)
        results.append(ev({}, fidelity=fidelity))
    (v_ref, m_ref), (v, m) = results
    assert v == v_ref and m == m_ref
    assert m["iters"] >= 2


def test_sweep_then_serve_picks_the_tuned_tiles_up(tmp_path, monkeypatch):
    """The loop closed on the CPU: sweep the three served kernels at the
    reduced model's call shapes, persist, build the steps with the DB, and
    check every consult hit and the kernels ran with the recorded tiles
    (after clamping)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as dec_mod
    from repro_torch.kernels import flash_attention as fla_mod
    from repro_torch.kernels import rmsnorm as rms_mod
    from repro_torch.models.model import build_model
    from repro_torch.models.params import split_params
    from repro_torch.models.runtime import Runtime
    from repro_torch.serve.serve_step import greedy_sample, make_decode_step, make_prefill_step

    cfg = get_config("qwen2-0.5b").reduced()
    B, S = 2, 16
    H, K, dh, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    shapes = {"flash_attention": {"B": B, "Sq": S, "Sk": S, "H": H, "K": K, "dh": dh},
              "decode_attention": {"B": B, "H": H, "K": K, "dh": dh, "Smax": S + 4},
              "rmsnorm": {"rows": B * S, "D": D}}
    fp = hardware_fingerprint("cpu")
    path = str(tmp_path / "tundb.json")
    rows, measured = run_sweep(list(shapes), TuningDB(path, fingerprint=fp), budget=3,
                               algorithm="ga", shapes=shapes, device="cpu",
                               emit=lambda *a: None)
    assert measured > 0

    seen = {}
    orig = ops._tuned

    def spy(db, kernel, dims, defaults):
        out = orig(db, kernel, dims, defaults)
        seen.setdefault(kernel, []).append((dict(dims), dict(out)))
        return out

    # what each wrapper ran with: its effective_config's answers
    ran = {}
    for mod, name in ((fla_mod, "flash_attention"), (dec_mod, "decode_attention"),
                      (rms_mod, "rmsnorm")):
        def effective(*a, _real=mod.effective_config, _name=name, **kw):
            out = _real(*a, **kw)
            ran.setdefault(_name, []).append(dict(out))
            return out

        monkeypatch.setattr(mod, "effective_config", effective)
    monkeypatch.setattr(ops, "_tuned", spy)

    db = TuningDB(path, fingerprint=fp)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params, _ = split_params(model.init(gen))
    rt = Runtime(compute_dtype="f32", attn_impl="cuda")
    cache, _ = split_params(model.init_cache(B, S + 4))
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, dtype=torch.int32)
    logits, cache = make_prefill_step(model, rt, tuning_db=db)(params, {"tokens": tokens}, cache)
    make_decode_step(model, rt, tuning_db=db)(params, greedy_sample(logits), cache)

    for r in rows:
        name, best = r["kernel"], r["best"]
        at_shape = [out for dims, out in seen[name] if dims == shapes[name]]
        assert at_shape and all(out == best for out in at_shape), (name, seen[name])
        assert KERNELS[name].effective(shapes[name], best) in ran[name]
    assert db.hits >= 3
