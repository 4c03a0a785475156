"""Every reduced config builds in the port and matches the reference on
the CPU; this file holds the dense, VLM and MoE-only configs (the other
families have files of their own, ``test_torch_family_*.py``), the cache
sizes and layer plans, the dtype-keeping cache conversion and the
runtimes the entry points build for the card.  Tolerances:
``test_torch_family_common.py``."""
import jax
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.models.model import build_model as ref_build_model
from repro.models.params import split_params as ref_split_params
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model
from repro_torch.models.convert import BF16_CACHE_LEAVES, cache_from_numpy
from repro_torch.models.params import split_params, tree_leaves
from test_torch_family_common import (batch_np, build_pair, check_converted_cache,
                                      check_full_logits, check_init_tree, check_prefill_decode,
                                      check_train_step, port_rt, torch_batch)

ARCHS = ["qwen2-0.5b", "h2o-danube-1.8b", "deepseek-coder-33b", "internvl2-26b",
         "qwen3-moe-30b-a3b", "grok-1-314b"]
CHECKS = {"init_tree": lambda pair: check_init_tree(pair["arch"]),
          "full_logits": check_full_logits, "prefill_decode": check_prefill_decode,
          "converted_cache": check_converted_cache, "train_step": check_train_step}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return build_pair(request.param)


@pytest.mark.parametrize("check", list(CHECKS))
def test_matches_reference(pair, check):
    CHECKS[check](pair)


@pytest.mark.parametrize("arch", list_archs())
def test_every_config_builds_and_runs(arch):
    """All 10 reduced configs: init, a full forward, prefill and a decode
    step, finite and of the reference's shapes."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params, _ = split_params(model.init(torch.Generator().manual_seed(0), dtype=torch.bfloat16))
    assert all(a.dtype == torch.bfloat16 for a in tree_leaves(params))  # cast at init
    b = torch_batch(batch_np(cfg, 2, 6))
    with torch.no_grad():
        logits, aux, _ = model.apply(params, b, rt=port_rt("cuda"))
        cache, _ = split_params(model.init_cache(2, 8))
        lp, _, cache = model.apply(params, b, rt=port_rt(), mode="prefill", cache=cache)
        ld, cache = model.decode_step(params, lp.argmax(-1).int(), cache, rt=port_rt())
    assert logits.shape == (2, 6, cfg.padded_vocab) and ld.shape == (2, 1, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(ld).all())
    assert bool(torch.isfinite(aux)) and cache["pos"] == 7


def _ref_cache_shapes(arch, B, L):
    rc, _ = ref_split_params(ref_build_model(ref_configs.get_config(arch).reduced())
                             .init_cache(B, L))
    return {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_flatten_with_path(rc)[0]}


def _cache_shapes(arch, B, L):
    c, _ = split_params(build_model(get_config(arch).reduced()).init_cache(B, L))
    out = {}

    def walk(t, path):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{path}['{k}']")
            elif isinstance(v, torch.Tensor):
                out[f"{path}['{k}']"] = tuple(v.shape)
    walk(c, "")
    return out, c


@pytest.mark.parametrize("arch", [a for a in list_archs() if a != "whisper-base"])
def test_cache_trees_match_the_reference(arch):
    """The init cache's leaves and shapes (whisper's cross K/V differ by
    design: see ``encdec.init_cache``)."""
    got, _ = _cache_shapes(arch, 2, 40)
    want = {k: v for k, v in _ref_cache_shapes(arch, 2, 40).items() if v}
    assert got == want


def test_sliding_window_and_latent_cache_sizes():
    cfg = get_config("h2o-danube-1.8b").reduced()
    shapes, _ = _cache_shapes("h2o-danube-1.8b", 2, 100)
    kv = [s for k, s in shapes.items() if k.endswith("['k']")]
    assert kv and all(s[2] == cfg.sliding_window for s in kv)  # ring buffer, not 100
    cfg = get_config("minicpm3-4b").reduced()
    shapes, c = _cache_shapes("minicpm3-4b", 2, 64)
    ckv = [s for k, s in shapes.items() if "ckv" in k]
    assert ckv and ckv[0][-1] == cfg.mla.kv_lora_rank  # compressed, not H * dh
    assert c["layers"]["pos0"]["mixer"]["ckv"].dtype == torch.bfloat16


def test_layer_plans():
    jamba = get_config("jamba-v0.1-52b")
    assert jamba.layer_period() == 8
    plan = jamba.layer_plan()
    assert sum(1 for m, _ in plan if m == "attn") == 4  # 1:7 over 32
    assert sum(1 for _, f in plan if f == "moe") == 16  # MoE every 2
    assert plan[:8] == ref_configs.get_config("jamba-v0.1-52b").layer_plan()[:8]
    for arch in list_archs():
        assert (get_config(arch).reduced().layer_plan()
                == ref_configs.get_config(arch).reduced().layer_plan())
    assert get_config("qwen2-0.5b").layer_period() == 1


def test_cache_from_numpy_keeps_each_leafs_type():
    """Mamba's and RWKV's states round-trip as f32 (values exact), the K/V
    and latent buffers as bf16, whatever type the numpy leaves arrive in."""
    rng = np.random.default_rng(0)
    tree = {"pos": np.int32(5), "layers": {
        "pos0": {"mixer": {"conv": rng.standard_normal((1, 2, 3, 8)),
                           "h": rng.standard_normal((1, 2, 8, 4)).astype(np.float32)}},
        "pos1": {"mixer": {"x_tmix": rng.standard_normal((1, 2, 8)).astype(np.float32),
                           "S": rng.standard_normal((1, 2, 2, 4, 4)).astype(np.float32)},
                 "mlp": {"x_cmix": rng.standard_normal((1, 2, 8)).astype(np.float32)}},
        "pos2": {"mixer": {"k": rng.standard_normal((1, 2, 4, 1, 8)).astype(np.float32),
                           "ckv": rng.standard_normal((1, 2, 4, 8)).astype(np.float32)}}}}
    c = cache_from_numpy(tree, device="cpu")
    assert c["pos"] == 5
    for pos, sub in tree["layers"].items():
        for part, leaves in sub.items():
            for name, a in leaves.items():
                got = c["layers"][pos][part][name]
                if name in BF16_CACHE_LEAVES:
                    assert got.dtype == torch.bfloat16
                    np.testing.assert_allclose(got.float().numpy(), a, rtol=1e-2, atol=1e-2)
                else:
                    assert got.dtype == torch.float32
                    np.testing.assert_array_equal(got.numpy(), a.astype(np.float32))


def test_entry_points_build_the_kernel_runtime_for_the_card():
    """Checked without a card: on the card both entry points select every
    kernel of their path, the scans included (``scan_impl="cuda"``); on the
    CPU the oracles."""
    for dtype in ("bf16", "f32"):
        rt = serve_cli.runtime(True, dtype)
        assert (rt.attn_impl, rt.scan_impl, rt.compute_dtype) == ("cuda", "cuda", dtype)
        rt = serve_cli.runtime(False, dtype)
        assert (rt.attn_impl, rt.scan_impl) == ("ref", "chunked")
    rt = train_cli.runtime(True, "full")
    assert (rt.attn_impl, rt.scan_impl, rt.compute_dtype, rt.remat) == ("cuda", "cuda", "f32",
                                                                        "full")
    assert (train_cli.runtime(False, "none").scan_impl) == "chunked"
