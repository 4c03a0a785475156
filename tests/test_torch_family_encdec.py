"""The Whisper-style encoder-decoder (``whisper-base``) against the
reference on the CPU: layernorm, the sinusoidal positions, the model
(full-mode logits for every impl, prefill + decode with the cross K/V
cache, a converted cache, one train step, the init tree), and the
``encoder_embeds`` batch of ``launch/serve.py``.  Tolerances:
``test_torch_family_common.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as RE
from repro.models import layers as RL
from repro_torch.launch import serve as serve_cli
from repro_torch.models import encdec as E
from repro_torch.models import layers as L
from test_torch_family_common import (TOL, assert_tree_close, build_pair,
                                      check_converted_cache, check_full_logits,
                                      check_init_tree, check_prefill_decode,
                                      check_train_step, params_from_numpy, port_rt,
                                      ref_rt)

ARCH = "whisper-base"


@pytest.fixture(scope="module")
def pair():
    return build_pair(ARCH)


def test_layernorm_and_positions():
    rng = np.random.default_rng(0)
    x = (3 * rng.standard_normal((2, 5, 64)) + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    want = RL.layernorm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), 1e-5)
    got = L.layernorm(params_from_numpy(p, device="cpu"), torch.from_numpy(x), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert set(L.init_layernorm(64)) == {"scale", "bias"}
    pos = np.arange(37)
    np.testing.assert_allclose(E._pos_enc(torch.from_numpy(pos), 64).numpy(),
                               np.asarray(RE._pos_enc(jnp.asarray(pos), 64)), atol=1e-5)
    np.testing.assert_array_equal(E.sinusoids(16, 8), RE.sinusoids(16, 8))


def test_encoder_matches(pair):
    cfg = pair["cfg"]
    e = np.random.default_rng(1).standard_normal((2, cfg.encoder_seq_len, cfg.d_model))
    e = e.astype(np.float32)
    want = RE.encode(pair["rparams"], jnp.asarray(e), cfg=pair["rcfg"], rt=ref_rt())
    for impl in ("ref", "cuda"):
        got = E.encode(pair["params"], torch.from_numpy(e), cfg=cfg,
                       rt=port_rt(impl, block_q=8, block_kv=8))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_init_tree():
    check_init_tree(ARCH)


def test_full_logits(pair):
    check_full_logits(pair)


def test_prefill_then_decode(pair):
    """The cross K/V hold the encoder's keys after prefill (bf16, KV heads)."""
    rcache, cache = check_prefill_decode(pair)
    cfg = pair["cfg"]
    k = cache["layers"]["cross"]["k"]
    assert k.dtype == torch.bfloat16 and k.shape == (
        cfg.num_layers, 2, cfg.encoder_seq_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    assert_tree_close(cache["layers"], rcache["layers"], atol=1e-2, rtol=0)


def test_converted_cache_continues(pair):
    check_converted_cache(pair)


def test_one_train_step(pair):
    check_train_step(pair)


def test_serve_cli_builds_encoder_embeds(capsys):
    cfg = serve_cli.get_config(ARCH).reduced()
    b = serve_cli.frontend_inputs(cfg, 3, "cpu")
    assert set(b) == {"encoder_embeds"} and b["encoder_embeds"].shape == (
        3, cfg.encoder_seq_len, cfg.d_model) and not b["encoder_embeds"].any()
    done = serve_cli.main(["--device", "cpu", "--arch", ARCH, "--requests", "3",
                           "--batch", "2", "--prompt-len", "8", "--gen-len", "4"])
    assert sorted(r for r, _ in done) == [0, 1, 2]
    assert all(t.shape == (4,) for _, t in done)
    assert "[serve] 3 requests, 16 tokens" in capsys.readouterr().out
