"""MLA (``minicpm3-4b``) against the reference on the CPU: the mixer in
all three modes (expanded attention with Q/K head dim dn + dr and V head
dim dv in the parallel modes, absorbed latent attention in decode), the
latent cache, and the model (full-mode logits for every impl, prefill +
decode, a converted cache, one train step, the init tree).  Tolerances:
``test_torch_family_common.py``; the bf16 latent cache within 1e-2 (one
bf16 ulp at these magnitudes)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro_torch.kernels import flash_attention as fla_mod
from repro_torch.models import layers as L
from test_torch_family_common import (TOL, assert_tree_close, build_pair, cache_pair,
                                      check_converted_cache, check_full_logits,
                                      check_init_tree, check_prefill_decode,
                                      check_train_step, layer_pair, port_rt, ref_rt)

ARCH = "minicpm3-4b"


@pytest.fixture(scope="module")
def pair():
    return build_pair(ARCH)


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("impl", ["ref", "chunked", "cuda"])
def test_mla_full_mode(impl):
    rcfg, cfg, rp, p = layer_pair(RL.init_mla, ARCH)
    x = _x(cfg, 2, 12, 0)
    want, _ = RL.mla_apply(rp, jnp.asarray(x), cfg=rcfg, rt=ref_rt(), mode="full")
    got, c = L.mla_apply(p, torch.from_numpy(x), cfg=cfg,
                         rt=port_rt(impl, block_q=8, block_kv=8), mode="full")
    assert c is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if impl == "cuda":  # dh = dn + dr = 24, dv = 16: the kernels' dv != dh route
        m = cfg.mla
        assert fla_mod.route(8, torch.bfloat16, m.qk_nope_head_dim + m.qk_rope_head_dim,
                             m.v_head_dim) == "fma"
        assert fla_mod.route(64, torch.bfloat16, 96, 64) == "mma"  # full width


def test_mla_prefill_then_decode():
    """Prefill writes the normalised latent and the rotated shared key into
    the bf16 cache; decode attends in the latent space (the oracle)."""
    rcfg, cfg, rp, p = layer_pair(RL.init_mla, ARCH, seed=1)
    rc, c = cache_pair(RL.init_mla_cache(rcfg, 2, 16))
    assert c["ckv"].dtype == torch.bfloat16 and c["ckv"].shape[-1] == cfg.mla.kv_lora_rank
    for step, xs in enumerate([_x(cfg, 2, 9, 2)] + [_x(cfg, 2, 1, 10 + i) for i in range(3)]):
        mode = "prefill" if step == 0 else "decode"
        pos = 9 + step - 1 if step else None
        want, rc = RL.mla_apply(rp, jnp.asarray(xs), cfg=rcfg, rt=ref_rt(), mode=mode,
                                cache=rc, pos=None if pos is None else jnp.asarray(pos))
        got, c = L.mla_apply(p, torch.from_numpy(xs), cfg=cfg, rt=port_rt(), mode=mode,
                             cache=c, pos=pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=mode)
        assert_tree_close(c, rc, atol=1e-2, rtol=0)
    with pytest.raises(IndexError):
        L.mla_apply(p, torch.from_numpy(_x(cfg, 2, 1, 20)), cfg=cfg, rt=port_rt(),
                    mode="decode", cache=c, pos=16)


def test_init_tree():
    check_init_tree(ARCH)


def test_full_logits(pair):
    check_full_logits(pair)


def test_prefill_then_decode(pair):
    rcache, cache = check_prefill_decode(pair)
    assert_tree_close(cache["layers"], rcache["layers"], atol=1e-2, rtol=0)


def test_converted_cache_continues(pair):
    check_converted_cache(pair)


def test_one_train_step(pair):
    check_train_step(pair)
