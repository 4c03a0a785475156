"""The port's AdamW against the reference's on the same numpy inputs:
``adamw_update`` for f32 / bf16 state x factored / not over three steps,
``lr_schedule``, ``global_norm`` and the gradient clip.

Tolerances: rtol 1e-6 on float32 values (both sides compute the same
elementwise formulas; a reduction may end one ulp apart).  A bfloat16
state leaf is compared by its bit pattern: the two float32 values it was
rounded from may straddle a rounding boundary, so neighbours (1 unit in
the last place) are accepted and nothing farther.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizer as R
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import optimizer as T

SHAPES = {
    "w": (16, 12),             # a matrix: decayed, factorable
    "blocks": {"wq": (3, 8, 16),   # stacked per-layer matrices
               "scale": (3, 10)},  # stacked vectors: ndim 2, decayed, not factorable
    "small": (4, 6),           # a matrix too small to factor
    "bias": (7,),              # a vector: no decay
}


def _tree(rng, scale=1.0):
    def make(shape):
        if isinstance(shape, dict):
            return {k: make(v) for k, v in shape.items()}
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    return make(SHAPES)


def _np(tree):
    def leaf(a):
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype.name == "bfloat16" else a
    return jax.tree_util.tree_map(leaf, tree)


def _torch_np(tree):
    if isinstance(tree, dict):
        return {k: _torch_np(v) for k, v in tree.items()}
    if tree.dtype == torch.bfloat16:
        return tree.view(torch.int16).numpy().view(np.uint16)
    return tree.numpy()


def _assert_tree_close(got, want, rtol=1e-6):
    want = _np(want)
    got = _torch_np(got)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, w in flat_w:
        g = got
        for key in path:
            g = g[key.key]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if w.dtype == np.uint16:  # bfloat16 bits: at most one ulp apart
            diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= 1, (path, diff.max())
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0, err_msg=str(path))


@pytest.mark.parametrize("state_dtype,factored", [("f32", False), ("f32", True),
                                                  ("bf16", False), ("bf16", True)])
def test_adamw_update_matches_reference(state_dtype, factored):
    rng = np.random.default_rng(0)
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10,
              state_dtype=state_dtype, factored=factored)
    params = _tree(rng)
    rparams = jax.tree_util.tree_map(jnp.asarray, params)
    tparams = params_from_numpy(params, device="cpu")
    rstate = R.adamw_init(rparams, R.OptimizerConfig(**kw))
    tstate = T.adamw_init(tparams, T.OptimizerConfig(**kw))
    _assert_tree_close(tstate, rstate)
    for step in range(3):
        grads = _tree(rng, scale=0.02)  # global norm ~0.5: no clip
        rparams, rstate, rm = R.adamw_update(
            jax.tree_util.tree_map(jnp.asarray, grads), rstate, rparams,
            R.OptimizerConfig(**kw))
        tparams, tstate, tm = T.adamw_update(
            params_from_numpy(grads, device="cpu"), tstate, tparams,
            T.OptimizerConfig(**kw))
        _assert_tree_close(tparams, rparams)
        _assert_tree_close(tstate["m"], rstate["m"])
        _assert_tree_close(tstate["v"], rstate["v"])
        assert int(tstate["count"]) == int(rstate["count"]) == step + 1
        assert tstate["count"].dtype == torch.int32
        for k in ("lr", "grad_norm", "clip"):
            np.testing.assert_allclose(float(tm[k]), float(rm[k]), rtol=1e-6)
        assert float(tm["clip"]) == 1.0


def test_factored_state_has_the_reference_shapes():
    params = params_from_numpy(_tree(np.random.default_rng(1)), device="cpu")
    v = T.adamw_init(params, T.OptimizerConfig(factored=True))["v"]
    assert set(v["w"]) == {"row", "col"}
    assert v["w"]["row"].shape == (16,) and v["w"]["col"].shape == (12,)
    assert v["blocks"]["wq"]["row"].shape == (3, 8)
    assert v["blocks"]["wq"]["col"].shape == (3, 16)
    for name in ("small", "bias"):
        assert isinstance(v[name], torch.Tensor) and v[name].shape == params[name].shape
    assert isinstance(v["blocks"]["scale"], torch.Tensor)  # 3 rows: below 8


@pytest.mark.parametrize("warmup,total,min_ratio", [(10, 100, 0.1), (0, 50, 0.0),
                                                    (20, 12, 0.1)])
def test_lr_schedule_matches_reference(warmup, total, min_ratio):
    kw = dict(learning_rate=3e-3, warmup_steps=warmup, total_steps=total,
              min_lr_ratio=min_ratio)
    steps = np.arange(0, 130, dtype=np.int32)
    want = np.array([float(R.lr_schedule(R.OptimizerConfig(**kw), jnp.asarray(s)))
                     for s in steps])
    got = T.lr_schedule(T.OptimizerConfig(**kw), torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(2)
    grads = _tree(rng, scale=3.0)  # global norm ~ 80: clipped
    want = float(R.global_norm(jax.tree_util.tree_map(jnp.asarray, grads)))
    tgrads = params_from_numpy(grads, device="cpu")
    np.testing.assert_allclose(float(T.global_norm(tgrads)), want, rtol=1e-6)

    params = _tree(rng)
    kw = dict(grad_clip=1.0, warmup_steps=0)
    rp, _, rm = R.adamw_update(jax.tree_util.tree_map(jnp.asarray, grads),
                               R.adamw_init(params, R.OptimizerConfig(**kw)),
                               jax.tree_util.tree_map(jnp.asarray, params),
                               R.OptimizerConfig(**kw))
    tparams = params_from_numpy(params, device="cpu")
    tp, _, tm = T.adamw_update(tgrads, T.adamw_init(tparams, T.OptimizerConfig(**kw)),
                               tparams, T.OptimizerConfig(**kw))
    assert float(tm["clip"]) < 0.05
    np.testing.assert_allclose(float(tm["clip"]), float(rm["clip"]), rtol=1e-6)
    _assert_tree_close(tp, rp)
    # the inputs are left as they were (the update is functional)
    np.testing.assert_array_equal(tparams["w"].numpy(), params["w"])
