"""The slice as a whole against the reference package on the CPU: the
reference's own initial weights go through ``params_from_numpy`` into the
port, both run in f32 on their oracles (``impl="ref"``), and prefill
logits, 8 decode steps and the final KV cache are compared.

Tolerances: logits atol=rtol=2e-4 (f32, other summation orders); the KV
cache is bf16 on both sides, compared in float32 within 1e-2 (one bf16 ulp
at these magnitudes, where a rounding flips).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.models.model import build_model as ref_build_model
from repro.models.params import split_params as ref_split_params
from repro.models.runtime import Runtime as RefRuntime
from repro.serve.serve_step import make_decode_step as ref_make_decode_step
from repro.serve.serve_step import make_prefill_step as ref_make_prefill_step
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import CPU_TEST, build_model
from repro_torch.models import layers as L
from repro_torch.models.convert import cache_from_numpy, params_from_numpy
from repro_torch.models.params import split_params
from repro_torch.models.runtime import Runtime
from repro_torch.serve.serve_step import (generate, greedy_sample,
                                          make_decode_step, make_prefill_step)

ARCHS = ["qwen2-0.5b", "h2o-danube-1.8b"]  # dense GQA; sliding window + ring buffer


def _to_numpy(tree):
    def leaf(a):
        a = np.asarray(a)
        return a.astype(np.float32) if a.dtype.name == "bfloat16" else a
    return jax.tree_util.tree_map(leaf, tree)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """Reference model + params, and the port's model with the same weights."""
    arch = request.param
    rcfg = ref_configs.get_config(arch).reduced()
    rmodel = ref_build_model(rcfg)
    rparams, _ = ref_split_params(rmodel.init(jax.random.PRNGKey(0)))
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = params_from_numpy(_to_numpy(rparams), device="cpu")
    return arch, rcfg, rmodel, rparams, cfg, model, params


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_prefill_decode_and_cache_match_reference(pair):
    arch, rcfg, rmodel, rparams, cfg, model, params = pair
    B, S, steps = 2, 12, 8   # danube's reduced window is 8: prefill wraps the ring
    toks = _tokens(cfg, B, S)
    rrt = RefRuntime(compute_dtype="f32")
    rt = Runtime(compute_dtype="f32")

    rcache, _ = ref_split_params(rmodel.init_cache(B, S + steps))
    rlogits, rcache = ref_make_prefill_step(rmodel, rrt)(
        rparams, {"tokens": jnp.asarray(toks)}, rcache)
    cache, _ = split_params(model.init_cache(B, S + steps))
    logits, cache = make_prefill_step(model, rt)(
        params, {"tokens": torch.from_numpy(toks)}, cache)
    assert logits.shape == (B, 1, cfg.padded_vocab) == tuple(rlogits.shape)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), atol=2e-4, rtol=2e-4)
    assert cache["pos"] == int(rcache["pos"]) == S

    rdecode = ref_make_decode_step(rmodel, rrt)
    decode = make_decode_step(model, rt)
    for _ in range(steps):
        rtok = jnp.argmax(rlogits[:, -1], -1).astype(jnp.int32)[:, None]
        tok = greedy_sample(logits)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(rtok))
        rlogits, rcache = rdecode(rparams, rtok, rcache)
        logits, cache = decode(params, tok, cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), atol=2e-4, rtol=2e-4)

    assert cache["pos"] == int(rcache["pos"]) == S + steps
    rc = _to_numpy(rcache)
    for name in ("k", "v"):
        got = cache["layers"]["pos0"]["mixer"][name]
        want = rc["layers"]["pos0"]["mixer"][name]
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        if cfg.sliding_window:
            assert got.shape[2] == cfg.sliding_window  # ring buffer, not cache_len
        np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2, rtol=0)


def test_full_mode_logits_match_reference(pair):
    arch, rcfg, rmodel, rparams, cfg, model, params = pair
    toks = _tokens(cfg, 2, 12, seed=1)
    rlogits, raux, rc = rmodel.apply(rparams, {"tokens": jnp.asarray(toks)},
                                     rt=RefRuntime(compute_dtype="f32"))
    for impl in ("ref", "chunked", "cuda"):   # "cuda" on CPU: the plain versions
        with torch.no_grad():
            logits, aux, c = model.apply(
                params, {"tokens": torch.from_numpy(toks)},
                rt=Runtime(compute_dtype="f32", attn_impl=impl, block_q=8, block_kv=8))
        assert c is None and rc is None and float(aux) == float(raux) == 0.0
        assert logits.shape == (2, 12, cfg.padded_vocab)
        np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), atol=2e-4, rtol=2e-4)


def test_converted_cache_continues_the_reference_run(pair):
    """State carried across: a cache the reference prefilled serves the
    port's decode step."""
    arch, rcfg, rmodel, rparams, cfg, model, params = pair
    B, S = 2, 10
    toks = _tokens(cfg, B, S, seed=2)
    rrt = RefRuntime(compute_dtype="f32")
    rcache, _ = ref_split_params(rmodel.init_cache(B, S + 4))
    rlogits, rcache = ref_make_prefill_step(rmodel, rrt)(
        rparams, {"tokens": jnp.asarray(toks)}, rcache)
    cache = cache_from_numpy(_to_numpy(rcache), device="cpu")
    assert cache["pos"] == S
    rtok = jnp.argmax(rlogits[:, -1], -1).astype(jnp.int32)[:, None]
    rlogits2, _ = ref_make_decode_step(rmodel, rrt)(rparams, rtok, rcache)
    logits2, cache = make_decode_step(model, Runtime(compute_dtype="f32"))(
        params, torch.from_numpy(np.array(rtok)), cache)
    np.testing.assert_allclose(logits2.numpy(), np.asarray(rlogits2), atol=2e-4, rtol=2e-4)
    assert cache["pos"] == S + 1


def test_convert_handles_bfloat16_leaves():
    a = np.asarray(jnp.asarray([[1.0, -2.5], [3.25, 1e-3]], jnp.bfloat16))
    assert a.dtype.name == "bfloat16"
    tree = params_from_numpy({"w": a, "n": {"i": np.arange(3, dtype=np.int32)}}, device="cpu")
    assert tree["w"].dtype == torch.bfloat16 and tree["n"]["i"].dtype == torch.int32
    np.testing.assert_array_equal(tree["w"].float().numpy(), a.astype(np.float32))
    cast = params_from_numpy({"w": a.astype(np.float32), "i": np.arange(3)},
                             device="cpu", dtype=torch.bfloat16)
    assert cast["w"].dtype == torch.bfloat16 and cast["i"].dtype == torch.int64
    assert torch.equal(cast["w"], tree["w"])


def test_generate_matches_teacher_forcing():
    """Greedy generation step-by-step == argmax of full forward each step."""
    cfg = get_config("qwen2-0.5b").reduced()
    model = build_model(cfg)
    rt = CPU_TEST
    params, _ = split_params(model.init(torch.Generator().manual_seed(0)))
    B, S, G = 2, 16, 6
    prompt = torch.from_numpy(_tokens(cfg, B, S))
    cache, _ = split_params(model.init_cache(B, S + G))
    gen, cache = generate(model, params, {"tokens": prompt}, rt=rt, cache=cache, steps=G)
    assert gen.shape == (B, G) and gen.dtype == torch.int32 and cache["pos"] == S + G - 1

    toks = prompt
    for t in range(G):
        with torch.no_grad():
            logits, _, _ = model.apply(params, {"tokens": toks}, rt=rt)
        nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        np.testing.assert_array_equal(nxt[:, 0].numpy(), gen[:, t].numpy())
        toks = torch.cat([toks, nxt], dim=1)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_serve_main_on_cpu_answers_every_request(capsys, dtype):
    done = serve_cli.main(["--device", "cpu", "--dtype", dtype, "--requests", "16",
                           "--prompt-len", "16", "--gen-len", "5", "--batch", "8"])
    assert sorted(rid for rid, _ in done) == list(range(16))
    for _, toks in done:
        assert toks.shape == (5,) and toks.min() >= 0 and toks.max() < 256
    assert "[serve] 16 requests, 80 tokens" in capsys.readouterr().out


def test_serve_main_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve_cli.main(["--requests", "1"])


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_gives_the_reference_tree(arch):
    """Same structure, shapes, dtypes and logical axes; weights drawn from
    the same distribution (a ±2σ truncated normal of scale 1/sqrt(fan_in),
    whose standard deviation is 0.88/sqrt(fan_in)): every dense leaf's std
    is within 5 % of the reference leaf's."""
    rtree = ref_build_model(ref_configs.get_config(arch).reduced()).init(jax.random.PRNGKey(0))
    rvals, raxes = ref_split_params(rtree)
    tree = build_model(get_config(arch).reduced()).init(torch.Generator().manual_seed(0))
    vals, axes = split_params(tree)

    rflat = jax.tree_util.tree_flatten_with_path(rvals)[0]
    rax = {jax.tree_util.keystr(p): a for p, a in
           jax.tree_util.tree_flatten_with_path(raxes, is_leaf=lambda x: isinstance(x, tuple))[0]}

    def get(t, path):
        for key in path:
            t = t[key.key]
        return t

    n = 0
    for path, rleaf in rflat:
        leaf, ax = get(vals, path), get(axes, path)
        assert tuple(leaf.shape) == rleaf.shape, path
        assert leaf.dtype == torch.float32 and rleaf.dtype == jnp.float32
        assert tuple(ax) == tuple(rax[jax.tree_util.keystr(path)]), path
        rstd = float(np.asarray(rleaf).std())
        if rstd > 0 and rleaf.size >= 4096:
            assert abs(float(leaf.std()) - rstd) <= 0.05 * rstd, path
            assert float(leaf.abs().max()) <= 2.0 * rstd / 0.8796 * 1.01
        elif rstd == 0:
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(rleaf))  # ones / zeros
        n += 1
    assert n == len(jax.tree_util.tree_leaves(vals)) and n > 10


def test_cache_tree_and_not_yet_ported_families():
    """The dense family's cache tree.  (Every family is ported now; their
    trees are held by ``test_torch_arch_smoke.py`` and the family files.)"""
    cfg = get_config("h2o-danube-1.8b").reduced()
    cache, axes = split_params(build_model(cfg).init_cache(3, 40))
    assert cache["pos"] == 0
    k = cache["layers"]["pos0"]["mixer"]["k"]
    assert k.shape == (cfg.num_layers, 3, 8, cfg.num_kv_heads, 16) and k.dtype == torch.bfloat16
    assert axes["layers"]["pos0"]["mixer"]["k"] == (
        "layers", "batch", "cache_seq", "kv_heads", "head")


def test_rope_and_mlp_match_reference():
    from repro.models import layers as RL
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    for pos in (np.arange(5), np.full((2, 5), 7)):
        want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
        got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # GELU MLP (the SwiGLU one is covered by the model tests)
    import dataclasses
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), act="gelu")
    rcfg = dataclasses.replace(ref_configs.get_config("qwen2-0.5b").reduced(), act="gelu")
    rp, _ = ref_split_params(RL.init_mlp(jax.random.PRNGKey(0), rcfg))
    assert set(rp) == set(split_params(L.init_mlp(torch.Generator().manual_seed(0), cfg))[0])
    h = rng.standard_normal((2, 5, 64)).astype(np.float32)
    want = RL.mlp_apply(rp, jnp.asarray(h), cfg=rcfg, rt=RefRuntime(compute_dtype="f32"))
    got = L.mlp_apply(params_from_numpy(_to_numpy(rp), device="cpu"), torch.from_numpy(h),
                      cfg=cfg, rt=Runtime(compute_dtype="f32"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_rmsnorm_goes_through_the_kernel_dispatch_when_the_runtime_selects_it(monkeypatch):
    from repro_torch.kernels import ops
    calls = []
    orig = ops.rmsnorm
    monkeypatch.setattr(ops, "rmsnorm",
                        lambda *a, **kw: calls.append(kw["impl"]) or orig(*a, **kw))
    p = {"scale": torch.ones(8)}
    x = torch.randn(2, 3, 8, generator=torch.Generator().manual_seed(0))
    for impl, want in (("ref", "ref"), ("chunked", "ref"), ("cuda", "cuda")):
        L.rmsnorm(p, x, 1e-5, Runtime(attn_impl=impl))
        assert calls[-1] == want
