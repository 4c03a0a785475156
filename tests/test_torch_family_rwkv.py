"""RWKV-6 (``rwkv6-3b``) against the reference on the CPU: the time mix
and the channel mix in all three modes, and the model (full-mode logits
for every impl, prefill + decode, a converted cache, one train step, the
init tree).  Tolerances: ``test_torch_family_common.py``; the f32 states
within 1e-5."""
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

ARCH = "rwkv6-3b"


@pytest.fixture(scope="module")
def pair():
    return build_pair(ARCH)


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("impl", ["ref", "chunked", "cuda"])
def test_time_mix_full_mode(impl):
    rcfg, cfg, rp, p = layer_pair(RL.init_rwkv_tmix, ARCH)
    x = _x(cfg, 2, 12, 0)
    want, _ = RL.rwkv_tmix_apply(rp, jnp.asarray(x), cfg=rcfg, rt=ref_rt(), mode="full")
    got, c = L.rwkv_tmix_apply(p, torch.from_numpy(x), cfg=cfg, rt=port_rt(impl, scan_chunk=4),
                               mode="full")
    assert c is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_time_and_channel_mix_prefill_then_decode():
    """Prefill fills x_tmix, S and x_cmix (f32); three decode steps carry
    them on; outputs and states match the reference's at every step."""
    rcfg, cfg, rpt, pt = layer_pair(RL.init_rwkv_tmix, ARCH)
    _, _, rpc, pc = layer_pair(RL.init_rwkv_cmix, ARCH, seed=1)
    rc, c = cache_pair(RL.init_rwkv_cache(rcfg, 2))
    assert all(v.dtype == torch.float32 for v in c.values())
    rtm = {"x_tmix": rc["x_tmix"], "S": rc["S"]}
    tm = {"x_tmix": c["x_tmix"], "S": c["S"]}
    rcm, cm = {"x_cmix": rc["x_cmix"]}, {"x_cmix": c["x_cmix"]}
    x = _x(cfg, 2, 9, 2)
    for step, xs in enumerate([x] + [_x(cfg, 2, 1, 10 + i) for i in range(3)]):
        mode = "prefill" if step == 0 else "decode"
        want, rtm = RL.rwkv_tmix_apply(rpt, jnp.asarray(xs), cfg=rcfg, rt=ref_rt(),
                                       mode=mode, cache=rtm)
        got, tm = L.rwkv_tmix_apply(pt, torch.from_numpy(xs), cfg=cfg, rt=port_rt(),
                                    mode=mode, cache=tm)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=mode)
        assert_tree_close(tm, rtm, atol=1e-5, rtol=1e-5)
        want, rcm = RL.rwkv_cmix_apply(rpc, jnp.asarray(xs), cfg=rcfg, rt=ref_rt(),
                                       mode=mode, cache=rcm)
        got, cm = L.rwkv_cmix_apply(pc, torch.from_numpy(xs), cfg=cfg, rt=port_rt(),
                                    mode=mode, cache=cm)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=mode)
        assert_tree_close(cm, rcm, atol=1e-5, rtol=1e-5)
    # in place: the cache handed in holds the new state
    assert tm["S"] is c["S"] and cm["x_cmix"] is c["x_cmix"]


def test_channel_mix_full_mode_and_token_shift():
    rcfg, cfg, rp, p = layer_pair(RL.init_rwkv_cmix, ARCH, seed=3)
    x = _x(cfg, 2, 7, 4)
    want, rc = RL.rwkv_cmix_apply(rp, jnp.asarray(x), cfg=rcfg, rt=ref_rt(), mode="full")
    got, c = L.rwkv_cmix_apply(p, torch.from_numpy(x), cfg=cfg, rt=port_rt(), mode="full")
    assert c is None and rc is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    last = np.ones((2, cfg.d_model), np.float32)
    np.testing.assert_array_equal(
        L._token_shift(torch.from_numpy(x), torch.from_numpy(last)).numpy(),
        np.asarray(RL._token_shift(jnp.asarray(x), jnp.asarray(last))))


def test_init_tree():
    assert check_init_tree(ARCH) == 1  # w_bias of the one period position


def test_full_logits(pair):
    check_full_logits(pair)


def test_prefill_then_decode(pair):
    rcache, cache = check_prefill_decode(pair)
    assert_tree_close(cache["layers"], rcache["layers"], atol=1e-4, rtol=1e-4)


def test_converted_cache_continues(pair):
    check_converted_cache(pair)


def test_one_train_step(pair):
    check_train_step(pair)
