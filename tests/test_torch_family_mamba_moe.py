"""Jamba's Mamba + MoE hybrid (``jamba-v0.1-52b``) against the reference
on the CPU: the Mamba mixer in all three modes, the MoE at the dropping
capacity of the config (the ``keep`` mask, the aux loss and the output)
and with ``moe_groups``, and the model (full-mode logits for every impl,
prefill + decode, a converted cache, one train step, the init tree).
Tolerances: ``test_torch_family_common.py``; the f32 states within 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro_torch.models import layers as L
from test_torch_family_common import (TOL, assert_tree_close, build_pair, cache_pair,
                                      check_converted_cache, check_full_logits,
                                      check_init_tree, check_prefill_decode,
                                      check_train_step, layer_pair, port_rt, ref_rt)

ARCH = "jamba-v0.1-52b"


@pytest.fixture(scope="module")
def pair():
    return build_pair(ARCH)


def _x(cfg, B, S, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model))).astype(np.float32)


@pytest.mark.parametrize("impl", ["ref", "chunked", "cuda"])
def test_mamba_full_mode(impl):
    rcfg, cfg, rp, p = layer_pair(RL.init_mamba, ARCH)
    x = _x(cfg, 2, 12, 0)
    want, _ = RL.mamba_apply(rp, jnp.asarray(x), cfg=rcfg, rt=ref_rt(), mode="full")
    got, c = L.mamba_apply(p, torch.from_numpy(x), cfg=cfg, rt=port_rt(impl, scan_chunk=4),
                           mode="full")
    assert c is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mamba_prefill_then_decode():
    """Prefill fills the conv window and the SSM state (f32); three decode
    steps carry them on; outputs and states match at every step."""
    rcfg, cfg, rp, p = layer_pair(RL.init_mamba, ARCH, seed=1)
    rc, c = cache_pair(RL.init_mamba_cache(rcfg, 2))
    assert c["conv"].dtype == c["h"].dtype == torch.float32
    held = dict(c)
    for step, xs in enumerate([_x(cfg, 2, 9, 2)] + [_x(cfg, 2, 1, 10 + i) for i in range(3)]):
        mode = "prefill" if step == 0 else "decode"
        want, rc = RL.mamba_apply(rp, jnp.asarray(xs), cfg=rcfg, rt=ref_rt(), mode=mode,
                                  cache=rc, pos=jnp.asarray(9 + step))
        got, c = L.mamba_apply(p, torch.from_numpy(xs), cfg=cfg, rt=port_rt(), mode=mode,
                               cache=c, pos=9 + step)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=mode)
        assert_tree_close(c, rc, atol=1e-5, rtol=1e-5)
    assert c["h"] is held["h"] and c["conv"] is held["conv"]  # updated in place


def test_mamba_init_is_computed():
    rcfg, cfg, rp, _ = layer_pair(RL.init_mamba, ARCH)
    p, _ = L.init_mamba(torch.Generator().manual_seed(0), cfg), None
    for name in ("A_log", "dt_b", "D", "conv_b"):
        np.testing.assert_allclose(p[name].value.numpy(), np.asarray(rp[name]), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def _moe(capacity_factor, groups=0, seed=5):
    rcfg, cfg, rp, p = layer_pair(RL.init_moe, ARCH, seed=seed)
    kw = dict(moe_capacity_factor=capacity_factor, moe_groups=groups)
    rrt = dataclasses.replace(ref_rt(), **kw)
    rt = dataclasses.replace(port_rt(), **kw)
    return rcfg, cfg, rp, p, rrt, rt


@pytest.mark.parametrize("groups", [0, 1, 4])
def test_moe_without_drops_matches(groups):
    rcfg, cfg, rp, p, rrt, rt = _moe(16.0, groups)
    x = _x(cfg, 2, 16, 6)
    want, raux = RL.moe_apply(rp, jnp.asarray(x), cfg=rcfg, rt=rrt)
    got, aux = L.moe_apply(p, torch.from_numpy(x), cfg=cfg, rt=rt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(raux), **TOL)


def _ref_keep(rp, x, rcfg, rrt):
    """The reference's keep mask, recomputed as ``_moe_apply_gspmd`` does."""
    m = rcfg.moe
    B, S, D = x.shape
    G = rrt.moe_groups or B
    T = B * S // G
    logits = (x.reshape(G, T, D) @ rp["router"]).astype(jnp.float32)
    _, top_i = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), m.top_k)
    C = max(1, int(np.ceil((rrt.moe_capacity_factor or m.capacity_factor) * T * m.top_k
                           / m.num_experts)))
    oh = jax.nn.one_hot(top_i, m.num_experts, dtype=jnp.int32).reshape(G, T * m.top_k, -1)
    rank_of = jnp.sum((jnp.cumsum(oh, axis=1) - oh) * oh, axis=-1).reshape(G, T, m.top_k)
    return np.asarray(rank_of < C), C


def test_moe_at_the_config_capacity_drops_the_same_slots():
    """capacity_factor 1.25 (the config's): slots past an expert's
    capacity go to the overflow slot.  The same slots are kept, and the
    outputs and aux loss match."""
    rcfg, cfg, rp, p, rrt, rt = _moe(0.0)
    x = _x(cfg, 2, 32, 7)
    keep_ref, C = _ref_keep(rp, jnp.asarray(x), rcfg, rrt)
    *_, C_port, _, keep = L.moe_route(p, torch.from_numpy(x), cfg=cfg, rt=rt)
    assert C_port == C == L.moe_capacity(cfg, rt, 32) == 20
    assert not keep_ref.all(), "the case must drop some slots"
    np.testing.assert_array_equal(keep.numpy(), keep_ref)
    want, raux = RL.moe_apply(rp, jnp.asarray(x), cfg=rcfg, rt=rrt)
    got, aux = L.moe_apply(p, torch.from_numpy(x), cfg=cfg, rt=rt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(raux), **TOL)


def test_moe_impls():
    """ep_local has no mesh rules on one card: the gspmd path, as the
    reference takes without rules; anything else raises."""
    rcfg, cfg, rp, p, rrt, rt = _moe(16.0)
    x = torch.from_numpy(_x(cfg, 2, 8, 8))
    a, _ = L.moe_apply(p, x, cfg=cfg, rt=rt)
    b, _ = L.moe_apply(p, x, cfg=cfg, rt=dataclasses.replace(rt, moe_impl="ep_local"))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="moe_impl"):
        L.moe_apply(p, x, cfg=cfg, rt=dataclasses.replace(rt, moe_impl="shard_map"))


def test_init_tree():
    assert check_init_tree(ARCH) == 2 * 7  # A_log and dt_b of the 7 Mamba positions


def test_full_logits_and_aux(pair):
    assert check_full_logits(pair) > 0  # 4 MoE layers' aux, summed


def test_prefill_then_decode(pair):
    rcache, cache = check_prefill_decode(pair)
    assert_tree_close(cache["layers"], rcache["layers"], atol=2e-2, rtol=1e-3)


def test_converted_cache_continues(pair):
    check_converted_cache(pair)


def test_one_train_step(pair):
    assert check_train_step(pair)["aux"] > 0


@pytest.mark.parametrize("remat", ["full", "dots", "names"])
def test_remat_wraps_the_hybrid_period(pair, remat):
    """Each remat mode recomputes a whole period (Mamba, attention, MoE
    blocks) and gives remat "none"'s loss and gradients."""
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.train_step import make_loss_fn, value_and_grad
    from test_torch_family_common import batch_np, torch_batch

    b = torch_batch(batch_np(pair["cfg"], 2, 8, seed=9, targets=True))
    out = {}
    for mode in ("none", remat):
        (loss, _), grads = value_and_grad(make_loss_fn(pair["model"], port_rt(remat=mode)),
                                          pair["params"], b)
        out[mode] = (float(loss), tree_leaves(grads))
    assert out[remat][0] == pytest.approx(out["none"][0], rel=1e-6)
    for g, g0 in zip(out[remat][1], out["none"][1]):
        torch.testing.assert_close(g, g0, rtol=1e-5, atol=1e-7)
