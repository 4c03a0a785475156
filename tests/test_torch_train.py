"""The training slice against the reference package on the CPU.

The reference's own initial weights go through ``params_from_numpy`` into
the port; both packages train ``qwen2-0.5b.reduced()`` in f32 on the same
synthetic batches (the reference's pipeline), and the port's step, remat
modes, microbatching, ``Trainer``, checkpoints and entry point are held
to the reference's.

Tolerances:

* losses and ``grad_norm``: rtol 1e-5 (f32, other summation orders);
* step-1 gradients: rtol 1e-4, atol 1e-6 * max|g| of the leaf;
* params after 3 steps, in units of the step's learning rate.  At step 1
  Adam's m̂/√v̂ is g/(|g|+eps), about sign(g).  Where |g| sits at rounding
  noise, the two packages' gradients can have opposite signs and the
  updates opposite directions, up to 2·lr·|g|/(|g|+eps) < 2·lr a step.
  So no element may be farther apart than 2·Σ lr_t (the worst case of a
  flip at every step), and since a flip needs a gradient at rounding
  noise, at most 1 element in 1,000 may be farther apart than 1e-3·lr.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.checkpoint.checkpointer import Checkpointer as RefCheckpointer
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticTokens as RefTokens
from repro.models.model import build_model as ref_build_model
from repro.models.params import split_params as ref_split_params
from repro.models.runtime import Runtime as RefRuntime
from repro.optim.optimizer import OptimizerConfig as RefOptConfig
from repro.optim.optimizer import adamw_init as ref_adamw_init
from repro.serve.serve_step import generate as ref_generate
from repro.train.train_step import cross_entropy as ref_cross_entropy
from repro.train.train_step import make_loss_fn as ref_make_loss_fn
from repro.train.train_step import make_train_step as ref_make_train_step
from repro.train.trainer import Trainer as RefTrainer
from repro.train.trainer import TrainerConfig as RefTrainerConfig
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.params import split_params, tree_map
from repro_torch.models.runtime import REMAT_MODES, Runtime
from repro_torch.optim.optimizer import OptimizerConfig, adamw_init
from repro_torch.runtime.fault_tolerance import FailureInjector
from repro_torch.serve.serve_step import generate
from repro_torch.train.train_step import (cross_entropy, make_loss_fn,
                                          make_train_step, value_and_grad)
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCH = "qwen2-0.5b"
B, S, STEPS = 4, 32, 3
OPT = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pairs(ref_tree, port_tree):
    """(path, reference leaf as numpy, port leaf as numpy) for every leaf."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref_tree)[0]:
        t = port_tree
        for key in path:
            t = t[key.key]
        out.append((jax.tree_util.keystr(path), np.asarray(leaf), t.detach().numpy()))
    return out


def _batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def ref():
    """The reference's params, batches, step-1 grads and a 3-step run."""
    rcfg = ref_configs.get_config(ARCH).reduced()
    rmodel = ref_build_model(rcfg)
    rparams, _ = ref_split_params(rmodel.init(jax.random.PRNGKey(0)))
    data = RefTokens(RefDataConfig(vocab_size=rcfg.vocab_size, seq_len=S, global_batch=B))
    batches = [data.batch_at(i) for i in range(STEPS)]
    rrt = RefRuntime(compute_dtype="f32")
    grad_fn = jax.jit(jax.grad(ref_make_loss_fn(rmodel, rrt), has_aux=True))
    grads1, _ = grad_fn(rparams, {k: jnp.asarray(v) for k, v in batches[0].items()})
    step = jax.jit(ref_make_train_step(rmodel, RefOptConfig(**OPT), rrt))
    p, o = rparams, ref_adamw_init(rparams, RefOptConfig(**OPT))
    metrics, params = [], []
    for b in batches:
        p, o, m = step(p, o, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
        params.append(p)
    return dict(rcfg=rcfg, rmodel=rmodel, params=rparams, batches=batches,
                grads1=grads1, metrics=metrics, params_after=params)


def _port_params(ref):
    return params_from_numpy(_np(ref["params"]), device="cpu")


def _port_run(ref, rt, microbatches=1, steps=STEPS):
    model = build_model(get_config(ARCH).reduced())
    params = _port_params(ref)
    step = make_train_step(model, OptimizerConfig(**OPT), rt, microbatches=microbatches)
    opt = adamw_init(params, OptimizerConfig(**OPT))
    metrics = []
    for b in ref["batches"][:steps]:
        params, opt, m = step(params, opt, _batch(b))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, params


def _assert_run_matches(ref, metrics, params, steps=STEPS):
    assert set(metrics[0]) == set(ref["metrics"][0]) == {
        "loss", "ce", "aux", "lr", "grad_norm", "clip", "loss_out"}
    for got, want in zip(metrics, ref["metrics"][:steps]):
        for k in ("loss", "ce", "loss_out", "grad_norm", "lr", "clip"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
        assert got["aux"] == want["aux"] == 0.0
    lr_sum = sum(m["lr"] for m in ref["metrics"][:steps])
    lr_last = ref["metrics"][steps - 1]["lr"]
    diffs = []
    for path, want, got in _pairs(ref["params_after"][steps - 1], params):
        assert got.shape == want.shape and got.dtype == want.dtype, path
        d = np.abs(got - want)
        assert d.max() <= 2 * lr_sum, (path, d.max(), lr_sum)
        diffs.append(d.ravel())
    diffs = np.concatenate(diffs)
    assert np.mean(diffs > 1e-3 * lr_last) <= 1e-3, np.quantile(diffs, [0.99, 0.999, 1.0])


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 5, 37))).astype(np.float32)
    targets = rng.integers(0, 37, (2, 5)).astype(np.int32)
    want = float(ref_cross_entropy(jnp.asarray(logits), jnp.asarray(targets)))
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("impl", ["ref", "cuda"])
def test_step_one_grads_match_reference(ref, impl):
    """``cuda`` on the CPU: the kernels' plain versions forward, the oracle
    backward (``_RefVJP``), as on the card."""
    model = build_model(get_config(ARCH).reduced())
    loss_fn = make_loss_fn(model, Runtime(compute_dtype="f32", attn_impl=impl))
    (loss, metrics), grads = value_and_grad(loss_fn, _port_params(ref),
                                            _batch(ref["batches"][0]))
    np.testing.assert_allclose(float(loss), ref["metrics"][0]["loss"], rtol=1e-5)
    assert float(metrics["loss"]) == float(loss)
    n = 0
    for path, want, got in _pairs(ref["grads1"], grads):
        assert got.shape == want.shape, path
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * np.abs(want).max(),
                                   err_msg=path)
        n += 1
    assert n == len(jax.tree_util.tree_leaves(ref["grads1"])) > 10


@pytest.mark.parametrize("impl", ["ref", "cuda"])
def test_three_steps_match_reference(ref, impl):
    metrics, params = _port_run(ref, Runtime(compute_dtype="f32", attn_impl=impl))
    _assert_run_matches(ref, metrics, params)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_microbatches_match_reference(ref, k):
    """k microbatches give the reference's one-batch step: the same loss,
    the same update."""
    metrics, params = _port_run(ref, Runtime(compute_dtype="f32"), microbatches=k)
    _assert_run_matches(ref, metrics, params)


def test_microbatches_must_divide_the_batch(ref):
    step = make_train_step(build_model(get_config(ARCH).reduced()),
                           OptimizerConfig(**OPT), Runtime(compute_dtype="f32"),
                           microbatches=3)
    params = _port_params(ref)
    with pytest.raises(ValueError, match="microbatches"):
        step(params, adamw_init(params, OptimizerConfig(**OPT)), _batch(ref["batches"][0]))


def _remat_grads(ref, remat, monkeypatch):
    """Step-1 loss and grads under ``remat``, the forward calls of attention
    (recompute included) and the bytes kept for the backward outside the
    checkpointed periods."""
    model = build_model(get_config(ARCH).reduced())
    rt = Runtime(compute_dtype="f32", attn_impl="cuda", remat=remat)
    calls, saved = [], []
    orig = L.ops.attention
    monkeypatch.setattr(L.ops, "attention", lambda *a, **kw: calls.append(1) or orig(*a, **kw))

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        (loss, _), grads = value_and_grad(make_loss_fn(model, rt), _port_params(ref),
                                          _batch(ref["batches"][0]))
    monkeypatch.setattr(L.ops, "attention", orig)
    return loss, grads, len(calls), sum(saved)


@pytest.mark.parametrize("remat", REMAT_MODES)
def test_remat_modes_match_reference_and_recompute(ref, remat, monkeypatch):
    """Every mode gives the reference's loss and grads.  Every mode but
    ``none`` runs each period's forward again in the backward (the kernels'
    forwards included: attention is counted here) and keeps fewer bytes
    for the backward outside its periods than ``none`` does."""
    layers = get_config(ARCH).reduced().num_layers
    loss, grads, calls, saved = _remat_grads(ref, remat, monkeypatch)
    np.testing.assert_allclose(float(loss), ref["metrics"][0]["loss"], rtol=1e-5)
    for path, want, got in _pairs(ref["grads1"], grads):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * np.abs(want).max(),
                                   err_msg=path)
    if remat == "none":
        assert calls == layers
    else:
        assert calls == 2 * layers
        assert saved < _remat_grads(ref, "none", monkeypatch)[3]


@pytest.mark.parametrize("grad", [True, False])
@pytest.mark.parametrize("remat", REMAT_MODES)
def test_residuals_are_marked_only_where_names_checkpoints(ref, remat, grad, monkeypatch):
    """``mixer_out`` and ``mlp_out`` are marked (a copy each) only in a
    period that runs under the ``names`` policy: with grad on, once each a
    layer in the forward, and again in the recompute (which stops early,
    after the last tensor the backward needs, so it may not reach
    ``mlp_out``); never without grad (serving) or under another mode."""
    layers = get_config(ARCH).reduced().num_layers
    model = build_model(get_config(ARCH).reduced())
    rt = Runtime(compute_dtype="f32", remat=remat)
    marks = []
    orig = lm._checkpoint_name
    monkeypatch.setattr(lm, "_checkpoint_name", lambda x, name: marks.append(name) or orig(x, name))
    loss_fn, batch = make_loss_fn(model, rt), _batch(ref["batches"][0])
    with torch.set_grad_enabled(grad):
        live = tree_map(lambda p: p.requires_grad_(grad), _port_params(ref))
        loss, _ = loss_fn(live, batch)
    forward = list(marks)
    on = grad and remat == "names"
    assert forward == (["mixer_out", "mlp_out"] * layers if on else [])
    if grad:
        loss.backward()
    assert (len(marks) > len(forward)) if on else marks == []


@pytest.mark.parametrize("remat", REMAT_MODES)
def test_every_remat_mode_trains(ref, remat):
    metrics, params = _port_run(ref, Runtime(compute_dtype="f32", remat=remat), steps=2)
    _assert_run_matches(ref, metrics, params, steps=2)


def test_trainer_with_reference_weights_matches_reference_trainer(ref):
    rcfg = ref["rcfg"]
    opt = dict(learning_rate=2e-3, warmup_steps=2, total_steps=4)
    data = dict(vocab_size=rcfg.vocab_size, seq_len=S, global_batch=B)
    rtrainer = RefTrainer(rcfg, RefOptConfig(**opt), RefDataConfig(**data),
                          RefTrainerConfig(steps=4, log_every=0),
                          rt=RefRuntime(compute_dtype="f32"))
    # the reference's step donates its inputs: hand it a copy
    rtrainer.params = jax.tree_util.tree_map(jnp.copy, ref["params"])
    rtrainer.opt_state = ref_adamw_init(rtrainer.params, RefOptConfig(**opt))
    rlog = rtrainer.run()
    trainer = Trainer(get_config(ARCH).reduced(), OptimizerConfig(**opt), DataConfig(**data),
                      TrainerConfig(steps=4, log_every=0, device="cpu"),
                      rt=Runtime(compute_dtype="f32"))
    trainer.params = _port_params(ref)
    trainer.opt_state = adamw_init(trainer.params, OptimizerConfig(**opt))
    log = trainer.run()
    assert [m["step"] for m in log] == [m["step"] for m in rlog] == [0, 1, 2, 3]
    for got, want in zip(log, rlog):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert got["seconds"] > 0


def test_trainer_loss_decreases():
    cfg = get_config(ARCH).reduced()
    trainer = Trainer(
        cfg,
        OptimizerConfig(learning_rate=2e-3, warmup_steps=5, total_steps=60),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8),
        TrainerConfig(steps=60, log_every=0, device="cpu"),
        rt=Runtime(compute_dtype="f32"),
    )
    log = trainer.run()
    first = np.mean([m["loss"] for m in log[:5]])
    last = np.mean([m["loss"] for m in log[-5:]])
    assert last < first - 0.5, (first, last)
    assert trainer.events == []


def test_failure_recovery_replays_the_stream(tmp_path):
    cfg = get_config(ARCH).reduced()
    common = dict(opt_cfg=OptimizerConfig(learning_rate=1e-3, warmup_steps=5, total_steps=40),
                  data_cfg=DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4),
                  rt=Runtime(compute_dtype="f32"))
    plain = Trainer(cfg, tcfg=TrainerConfig(steps=14, log_every=0, device="cpu"), **common)
    log_plain = plain.run()
    failing = Trainer(cfg, tcfg=TrainerConfig(steps=14, log_every=0, device="cpu",
                                              checkpoint_dir=str(tmp_path / "ck"),
                                              checkpoint_every=5),
                      failure_injector=FailureInjector(at_steps=[8]), **common)
    log_fail = failing.run()
    assert failing.events == ["failure at step 8", "elastic rescale dp 2->1",
                              "restored step 5"]
    # steps 5..7 ran twice: once before the failure, once after the restore
    assert [m["step"] for m in log_fail] == list(range(8)) + list(range(5, 14))
    replay = log_fail[:5] + log_fail[8:]
    assert [m["step"] for m in replay] == [m["step"] for m in log_plain] == list(range(14))
    np.testing.assert_allclose([m["loss"] for m in replay], [m["loss"] for m in log_plain],
                               rtol=1e-6)
    np.testing.assert_allclose([m["loss"] for m in log_fail[5:8]],
                               [m["loss"] for m in log_fail[8:11]], rtol=1e-6)
    assert Checkpointer(tmp_path / "ck").latest_step() == 14


def test_train_checkpoint_restore_serve_roundtrip(tmp_path):
    """Train in the port, checkpoint, restore into fresh params and serve;
    the reference restores the same checkpoint and serves the same tokens."""
    cfg = get_config(ARCH).reduced()
    rt = Runtime(compute_dtype="f32")
    trainer = Trainer(
        cfg,
        OptimizerConfig(learning_rate=2e-3, warmup_steps=5, total_steps=20),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=48, global_batch=8),
        TrainerConfig(steps=20, log_every=0, checkpoint_dir=str(tmp_path / "ck"),
                      checkpoint_every=10, device="cpu"),
        rt=rt,
    )
    log = trainer.run()
    assert log[-1]["loss"] < log[0]["loss"]

    model = build_model(cfg)
    fresh, _ = split_params(model.init(torch.Generator().manual_seed(7)))
    restored, meta = Checkpointer(tmp_path / "ck").restore(
        None, {"params": fresh, "opt": trainer.opt_state})
    assert meta["step"] == 20 and meta["config"] == cfg.name
    params = restored["params"]
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(trainer.params)):
        assert torch.equal(a, b)

    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    cache, _ = split_params(model.init_cache(2, 32))
    gen, _ = generate(model, params, {"tokens": torch.from_numpy(prompt)}, rt=rt,
                      cache=cache, steps=8)
    assert gen.shape == (2, 8) and gen.dtype == torch.int32

    rmodel = ref_build_model(ref_configs.get_config(ARCH).reduced())
    rfresh, _ = ref_split_params(rmodel.init(jax.random.PRNGKey(7)))
    rrestored, _ = RefCheckpointer(str(tmp_path / "ck")).restore(
        None, {"params": rfresh, "opt": ref_adamw_init(rfresh, RefOptConfig())})
    rcache, _ = ref_split_params(rmodel.init_cache(2, 32))
    rgen, _ = ref_generate(rmodel, jax.tree_util.tree_map(jnp.asarray, rrestored["params"]),
                           {"tokens": jnp.asarray(prompt)}, rt=RefRuntime(compute_dtype="f32"),
                           cache=rcache, steps=8)
    np.testing.assert_array_equal(gen.numpy(), np.asarray(rgen))


def test_launch_train_main_on_cpu(tmp_path, capsys):
    log = train_cli.main(["--device", "cpu", "--reduced", "--steps", "6", "--batch", "4",
                          "--seq", "16", "--microbatches", "2", "--remat", "full",
                          "--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "2",
                          "--inject-failure", "3"])
    assert [m["step"] for m in log] == [0, 1, 2, 2, 3, 4, 5]
    assert all(np.isfinite(m["loss"]) for m in log)
    out = capsys.readouterr().out
    assert "[train] done: loss" in out and "restored step 2" in out
    assert Checkpointer(tmp_path / "ck").latest_step() == 6


def test_launch_train_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_cli.main(["--reduced", "--steps", "1"])


def test_tuning_db_is_consulted_by_the_train_step(ref, tmp_path):
    """``tuning_db`` reaches the kernels' dispatch (``attn_impl="cuda"``):
    the flash attention and RMSNorm calls of a step look their tiles up."""
    from repro_torch.tuning.tundb import TuningDB, hardware_fingerprint

    db = TuningDB(str(tmp_path / "db.json"), fingerprint=hardware_fingerprint("cpu"))
    model = build_model(get_config(ARCH).reduced())
    rt = Runtime(compute_dtype="f32", attn_impl="cuda")
    step = make_train_step(model, OptimizerConfig(**OPT), rt, tuning_db=db)
    params = _port_params(ref)
    _, _, m = step(params, adamw_init(params, OptimizerConfig(**OPT)), _batch(ref["batches"][0]))
    np.testing.assert_allclose(float(m["loss"]), ref["metrics"][0]["loss"], rtol=1e-5)
    assert db.lookups >= 2  # memoised: one per kernel and call shape
