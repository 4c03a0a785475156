"""Training the two scan families (RWKV-6, Jamba) against the reference on
the CPU, and what the card's run of them needed: the trainer's in-place
(donated) optimizer step, the oracle-recompute nodes named by kernel, and
dry-run records that name the torch and the pod size they were made with.

* ``Trainer`` from the reference's weights (``models/convert.py``) against
  the reference's ``Trainer``, 3 steps of the reduced config, f32: each
  loss within rtol 1e-5 (as ``test_torch_train.py`` holds qwen2-0.5b).
  MoE at capacity factor 16, where no token is dropped (as the family
  tests run it).
* ``launch/train.main`` runs both families to its end on the CPU.
* ``--arch jamba-v0.1-52b --layers 8 --d-model 1024`` builds the
  reference's config field by field, and both packages' models hold the
  same number of parameters, counted from shapes alone (no values drawn).
* The donated AdamW step equals the functional one exactly (the same
  elementwise formulas, on slices of a stacked leaf).
"""
import dataclasses
import json
import math
import sys
import types

import jax
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.launch.train as ref_train_cli
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.models.model import build_model as ref_build_model
from repro.models.params import split_params as ref_split_params
from repro.models.runtime import Runtime as RefRuntime
from repro.optim.optimizer import OptimizerConfig as RefOptConfig
from repro.optim.optimizer import adamw_init as ref_adamw_init
from repro.train.trainer import Trainer as RefTrainer
from repro.train.trainer import TrainerConfig as RefTrainerConfig
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.params import split_params, tree_leaves
from repro_torch.models.runtime import Runtime
from repro_torch.optim import optimizer as O
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tuning.cache import JsonCacheStore
from repro_torch.tuning.evaluator import RooflineEvaluator, provenance
from repro_torch.tuning.parameters import config_from_point

FAMILIES = ("rwkv6-3b", "jamba-v0.1-52b")
B, S, STEPS = 2, 32, 3
OPT = dict(learning_rate=2e-3, warmup_steps=2, total_steps=6)
CF = 16.0  # MoE capacity factor at which no token is dropped


@pytest.mark.parametrize("arch", FAMILIES)
def test_trainer_with_reference_weights_matches_reference_trainer(arch):
    rcfg = ref_configs.get_config(arch).reduced()
    data = dict(vocab_size=rcfg.vocab_size, seq_len=S, global_batch=B)
    rparams, _ = ref_split_params(ref_build_model(rcfg).init(jax.random.PRNGKey(0)))
    port_params = params_from_numpy(jax.tree_util.tree_map(np.asarray, rparams),
                                    device="cpu")
    rtrainer = RefTrainer(rcfg, RefOptConfig(**OPT), RefDataConfig(**data),
                          RefTrainerConfig(steps=STEPS, log_every=0),
                          rt=RefRuntime(compute_dtype="f32", moe_capacity_factor=CF))
    # the reference's step donates its inputs: it gets params of its own
    rtrainer.params = rparams
    rtrainer.opt_state = ref_adamw_init(rparams, RefOptConfig(**OPT))
    rlog = rtrainer.run()
    trainer = Trainer(get_config(arch).reduced(), O.OptimizerConfig(**OPT), DataConfig(**data),
                      TrainerConfig(steps=STEPS, log_every=0, device="cpu"),
                      rt=Runtime(compute_dtype="f32", moe_capacity_factor=CF))
    trainer.params = port_params
    trainer.opt_state = O.adamw_init(port_params, O.OptimizerConfig(**OPT))
    log = trainer.run()
    assert [m["step"] for m in log] == [m["step"] for m in rlog] == list(range(STEPS))
    for got, want in zip(log, rlog):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    # the trainer's step updated its params in place
    assert all(a is b for a, b in zip(tree_leaves(trainer.params), tree_leaves(port_params)))


@pytest.mark.parametrize("arch", FAMILIES)
def test_launch_train_main_runs_the_family_on_cpu(arch, capsys):
    log = train_cli.main(["--device", "cpu", "--reduced", "--arch", arch, "--steps", "3",
                          "--batch", "2", "--seq", "32"])
    assert [m["step"] for m in log] == [0, 1, 2]
    assert all(math.isfinite(m["loss"]) for m in log)
    assert "[train] done: loss" in capsys.readouterr().out


class _Built(Exception):
    """Raised by a stand-in ``Trainer`` with the config a CLI built."""


def _cli_config(module, monkeypatch, argv):
    def stop(cfg, *a, **k):
        raise _Built(cfg)

    monkeypatch.setattr(module, "Trainer", stop)
    with pytest.raises(_Built) as built:
        module.main(argv)
    return built.value.args[0]


JAMBA_PERIOD = ["--arch", "jamba-v0.1-52b", "--layers", "8", "--d-model", "1024"]


def test_jamba_period_at_the_width_flag_is_the_reference_config(monkeypatch):
    ours = _cli_config(train_cli, monkeypatch, JAMBA_PERIOD + ["--device", "cpu"])
    ref = _cli_config(ref_train_cli, monkeypatch, JAMBA_PERIOD)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert (ours.num_layers, ours.d_model, ours.resolved_head_dim, ours.d_ff) == \
        (8, 1024, 32, 4096)
    assert (ours.moe.num_experts, ours.moe.top_k, ours.moe.d_expert) == (16, 2, 14336)


def _ref_count(cfg):
    model = ref_build_model(cfg)
    shapes = jax.eval_shape(lambda: ref_split_params(model.init(jax.random.PRNGKey(0)))[0])
    return sum(math.prod(s.shape) for s in jax.tree_util.tree_leaves(shapes))


def _port_count(cfg):
    params, _ = split_params(build_model(cfg).init(dryrun.MetaGenerator()))
    return sum(p.numel() for p in tree_leaves(params))


@pytest.mark.parametrize("argv", [["--arch", "rwkv6-3b"], JAMBA_PERIOD],
                         ids=["rwkv6-3b", "jamba-period-d1024"])
def test_parameter_count_from_shapes_equals_the_reference(argv, monkeypatch):
    ours = _cli_config(train_cli, monkeypatch, argv + ["--device", "cpu"])
    ref = _cli_config(ref_train_cli, monkeypatch, argv)
    n = _port_count(ours)
    assert n == _ref_count(ref)
    # what the card's run holds in f32 with AdamW: 16 bytes a parameter
    # (rwkv6-3b: 3.10 B; ``param_counts()``' analytic 3.63 B counts more)
    assert {"rwkv6-3b": 3.0e9 < n < 3.2e9,
            "jamba-v0.1-52b": 2.9e9 < n < 3.2e9}[ours.name]


# -- the donated optimizer step -----------------------------------------------------

SHAPES = {"experts": (2, 3, 8, 16), "stacked": (3, 8, 16), "stacked_vec": (3, 10),
          "w": (16, 12), "bias": (7,), "scalar": ()}


def _leaves(params, state):
    return tree_leaves(params) + tree_leaves(state["m"]) + tree_leaves(state["v"])


@pytest.mark.parametrize("slab", [None, 300, 16], ids=["whole", "slabs", "rows"])
@pytest.mark.parametrize("state_dtype,factored",
                         [("f32", False), ("bf16", False), ("f32", True)])
def test_donated_update_equals_the_functional_update(state_dtype, factored, slab,
                                                     monkeypatch):
    """Whole leaves; slabs of rows (``_SLAB`` 300: two of the three layers
    of ``stacked``, and of each expert row of ``experts``); and a row at a
    time, down to matrices (``_SLAB`` 16)."""
    if slab:
        monkeypatch.setattr(O, "_SLAB", slab)
    rng = np.random.default_rng(0)
    cfg = O.OptimizerConfig(learning_rate=1e-2, warmup_steps=1, state_dtype=state_dtype,
                            factored=factored)
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for k, s in SHAPES.items()}
    state = O.adamw_init(params, cfg)
    donated = {k: v.clone() for k, v in params.items()}
    dstate = O.adamw_init(donated, cfg)
    for _ in range(3):
        grads = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for k, s in SHAPES.items()}
        params, state, m = O.adamw_update(grads, state, params, cfg)
        leaves = _leaves(donated, dstate)
        donated, dstate, dm = O.adamw_update(grads, dstate, donated, cfg, donate=True)
        assert all(a is b for a, b in zip(_leaves(donated, dstate), leaves, strict=True))
        assert float(dm["grad_norm"]) == float(m["grad_norm"])
    for a, b in zip(_leaves(params, state), _leaves(donated, dstate), strict=True):
        assert torch.equal(a, b)


# -- the oracle backwards name their kernel -----------------------------------------


def _scan_args(rng, *shapes):
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).requires_grad_(True)
            for s in shapes]


@pytest.mark.parametrize("kernel", ["rmsnorm", "flash_attention", "ssm_scan", "gla_scan"])
def test_oracle_backward_node_names_its_kernel(kernel):
    """The ``_RefVJP`` node of each kernel's forward carries the kernel's
    name (``chip_smoke.py`` times each scan's oracle recompute by it), and
    its gradient is the oracle's."""
    rng = np.random.default_rng(0)
    b, s, d = 1, 16, 8
    calls = {
        "rmsnorm": lambda: (ops.rmsnorm, _scan_args(rng, (b, s, d), (d,)), {}),
        "flash_attention": lambda: (ops.attention, _scan_args(rng, *[(b, s, 2, d)] * 3), {}),
        "ssm_scan": lambda: (ops.ssm_scan, _scan_args(
            rng, (b, s, d), (b, s, d), (d, 4), (b, s, 4), (b, s, 4), (d,)), {"chunk": 8}),
        "gla_scan": lambda: (ops.gla_scan, _scan_args(
            rng, *[(b, s, 2, d)] * 4, (2, d)), {"chunk": 8}),
    }
    fn, args, kw = calls[kernel]()
    if kernel in ("ssm_scan", "gla_scan"):  # keep the decays stable
        with torch.no_grad():
            if kernel == "ssm_scan":
                args[1].abs_().mul_(0.1)
                args[2].abs_().neg_()
            else:
                args[3].copy_(torch.exp(-torch.exp(args[3] * 0.5 - 1.0)))
    out = fn(*args, impl="cuda", **kw)
    assert type(out.grad_fn).__name__ == "_RefVJPBackward" and out.grad_fn.kernel == kernel
    got = torch.autograd.grad(out.sum(), args)
    want = torch.autograd.grad(fn(*args, impl="chunked" if kernel != "rmsnorm" else "ref",
                                  **kw).sum(), args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


# -- dry-run records name their torch and pod size ----------------------------------


@pytest.mark.parametrize("chips", [1, 256])
def test_dry_run_record_names_torch_and_pod_size(chips):
    skipped = dryrun.analyze_cell("qwen2-0.5b", "long_500k", chips_per_pod=chips)
    assert skipped["skipped"]
    assert (skipped["torch"], skipped["chips_per_pod"]) == (torch.__version__, chips)
    if chips == 1:  # a traced record (seconds on one card)
        rec = dryrun.analyze_cell("whisper-base", "decode_32k")
        assert not rec["skipped"] and rec["memory"]["per_device_B"] > 0
        assert (rec["torch"], rec["chips_per_pod"]) == (torch.__version__, 1)


def _stub_analyze(monkeypatch, calls):
    def analyze_cell(arch, shape, *, multi_pod, bc, chips_per_pod, fast):
        calls.append(chips_per_pod)
        return {"skipped": False, "memory": {"per_device_B": 1.0},
                "roofline": {"throughput_tok_s": 456.0}, **provenance(chips_per_pod)}

    stub = types.ModuleType("repro_torch.launch.dryrun")
    stub.analyze_cell = analyze_cell
    monkeypatch.setitem(sys.modules, "repro_torch.launch.dryrun", stub)


STALE = {"other torch": {"torch": "0.0.0", "chips_per_pod": 1},
         "other pod size": {"torch": torch.__version__, "chips_per_pod": 256},
         "written before records named them": {}}


@pytest.mark.parametrize("stored", list(STALE.values()), ids=list(STALE))
@pytest.mark.parametrize("loaded", ["at start", "after start"])
def test_roofline_entry_of_another_torch_or_pod_size_is_traced_again(
        stored, loaded, tmp_path, monkeypatch):
    calls = []
    _stub_analyze(monkeypatch, calls)
    cache = str(tmp_path / "roofline.json")
    point = {"block_q": 256}
    key = RooflineEvaluator("qwen2-0.5b", "train_4k")._key(config_from_point(point))
    old = {"skipped": False, "memory": {"per_device_B": 1.0},
           "roofline": {"throughput_tok_s": 123.0}, **stored}
    if loaded == "at start":
        JsonCacheStore(cache).put(key, old)
    ev = RooflineEvaluator("qwen2-0.5b", "train_4k", cache_path=cache)
    if loaded == "after start":
        JsonCacheStore(cache).put(key, old)
    assert ev(point)[0] == 456.0 and calls == [1]
    assert ev(point)[0] == 456.0 and calls == [1]  # the fresh record is kept
    fresh = JsonCacheStore(cache).load()[key]  # and overwrote the stored one
    assert fresh["roofline"]["throughput_tok_s"] == 456.0
    assert (fresh["torch"], fresh["chips_per_pod"]) == (torch.__version__, 1)


def test_roofline_matching_entry_is_returned_without_a_trace(tmp_path, monkeypatch):
    calls = []
    _stub_analyze(monkeypatch, calls)
    cache = str(tmp_path / "roofline.json")
    point = {"block_q": 256}
    ev = RooflineEvaluator("qwen2-0.5b", "train_4k", chips_per_pod=256, cache_path=cache)
    key = ev._key(config_from_point(point))
    JsonCacheStore(cache).put(key, {"skipped": False, "memory": {"per_device_B": 1.0},
                                    "roofline": {"throughput_tok_s": 123.0},
                                    **provenance(256)})
    assert RooflineEvaluator("qwen2-0.5b", "train_4k", chips_per_pod=256,
                             cache_path=cache)(point)[0] == 123.0
    assert ev(point)[0] == 123.0 and calls == []


def test_dryrun_resume_skips_only_records_of_this_torch_and_pod_size(tmp_path, monkeypatch,
                                                                     capsys):
    traced = []

    def analyze_cell(arch, shape_name, *, multi_pod, bc, chips_per_pod, fast):
        traced.append((arch, shape_name))
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod, "skipped": True,
                "skip_reason": "stub", **provenance(chips_per_pod)}

    monkeypatch.setattr(dryrun, "analyze_cell", analyze_cell)
    out = tmp_path / "cells.json"
    lines = [{"arch": "qwen2-0.5b", "shape": shape, "multi_pod": False, "skipped": True,
              "skip_reason": "earlier", **prov}
             for shape, prov in (("train_4k", provenance(1)),
                                 ("prefill_32k", {"torch": "0.0.0", "chips_per_pod": 1}),
                                 ("decode_32k", {}))]
    (tmp_path / "cells.json.jsonl").write_text("".join(json.dumps(r) + "\n" for r in lines))
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        dryrun.main(["--arch", "qwen2-0.5b", "--shape", shape, "--out", str(out)])
    assert traced == [("qwen2-0.5b", "prefill_32k"), ("qwen2-0.5b", "decode_32k")]
    recs = {r["shape"]: r for r in json.loads(out.read_text())}
    assert recs["decode_32k"]["skip_reason"] == "stub"
    assert recs["decode_32k"]["torch"] == torch.__version__
