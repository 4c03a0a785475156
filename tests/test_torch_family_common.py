"""What the model-family tests share (no tests of its own): the reference
and the port built from the same reduced config, the reference's own
initial weights carried into the port by ``params_from_numpy``, and the
model-level checks each family file runs for its configs, in f32.

Tolerances: logits and the aux loss atol = rtol = 2e-4 (f32, other
summation orders; as ``test_torch_lm_serve.py``); a train step's loss,
cross entropy, aux loss and grad norm rtol 1e-4.  MoE configs run at
``moe_capacity_factor=16``, where no token is dropped, so that routing
(a discrete choice) matches exactly; the family files hold the dropping
capacity separately, at layer level.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as ref_configs
from repro.models.model import build_model as ref_build_model
from repro.models.params import split_params as ref_split_params
from repro.models.runtime import Runtime as RefRuntime
from repro.optim.optimizer import OptimizerConfig as RefOptConfig
from repro.optim.optimizer import adamw_init as ref_adamw_init
from repro.serve.serve_step import make_decode_step as ref_make_decode_step
from repro.serve.serve_step import make_prefill_step as ref_make_prefill_step
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.convert import cache_from_numpy, params_from_numpy
from repro_torch.models.params import split_params
from repro_torch.models.runtime import Runtime
from repro_torch.optim.optimizer import OptimizerConfig, adamw_init
from repro_torch.serve.serve_step import greedy_sample, make_decode_step, make_prefill_step
from repro_torch.train.train_step import make_train_step

TOL = dict(atol=2e-4, rtol=2e-4)
CF = 16.0  # MoE capacity factor at which no token is dropped
IMPLS = ("ref", "chunked", "cuda")  # "cuda" on the CPU: the kernels' plain versions
OPT = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)


def to_numpy(tree):
    """A reference value tree as numpy, bf16 leaves widened to f32."""
    def leaf(a):
        a = np.asarray(a)
        return a.astype(np.float32) if a.dtype.name == "bfloat16" else a
    return jax.tree_util.tree_map(leaf, tree)


def ref_rt(**kw):
    return RefRuntime(compute_dtype="f32", moe_capacity_factor=CF, **kw)


def port_rt(impl="ref", **kw):
    return Runtime(compute_dtype="f32", moe_capacity_factor=CF, attn_impl=impl,
                   scan_impl="chunked" if impl == "ref" else impl, **kw)


def build_pair(arch):
    """Reference model + params, and the port's model with the same weights."""
    rcfg = ref_configs.get_config(arch).reduced()
    rmodel = ref_build_model(rcfg)
    rparams, _ = ref_split_params(rmodel.init(jax.random.PRNGKey(0)))
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = params_from_numpy(to_numpy(rparams), device="cpu")
    return dict(arch=arch, rcfg=rcfg, rmodel=rmodel, rparams=rparams, cfg=cfg,
                model=model, params=params)


def batch_np(cfg, B, S, seed=0, targets=False):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if targets:
        b["targets"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.family == "vlm":
        b["image_embeds"] = (0.5 * rng.standard_normal(
            (B, cfg.num_frontend_tokens, cfg.d_model))).astype(np.float32)
    if cfg.encoder_layers:
        b["encoder_embeds"] = (0.5 * rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model))).astype(np.float32)
    return b


def jnp_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def check_init_tree(arch):
    """The port's own init gives the reference's tree: the same keys,
    shapes, dtypes and logical axes, and the same computed (not drawn)
    leaves: ones, zeros, Mamba's ``A_log`` / ``dt_b``, RWKV's ``w_bias``."""
    rtree = ref_build_model(ref_configs.get_config(arch).reduced()).init(jax.random.PRNGKey(0))
    rvals, raxes = ref_split_params(rtree)
    vals, axes = split_params(build_model(get_config(arch).reduced())
                              .init(torch.Generator().manual_seed(0)))
    rax = {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_flatten_with_path(
        raxes, is_leaf=lambda x: isinstance(x, tuple))[0]}
    n, computed = 0, 0
    for path, rleaf in jax.tree_util.tree_flatten_with_path(rvals)[0]:
        leaf, ax = vals, axes
        for key in path:
            leaf, ax = leaf[key.key], ax[key.key]
        assert tuple(leaf.shape) == rleaf.shape and leaf.dtype == torch.float32, path
        assert tuple(ax) == tuple(rax[jax.tree_util.keystr(path)]), path
        name = path[-1].key
        if float(np.asarray(rleaf).std()) == 0 or name in ("A_log", "dt_b", "w_bias"):
            np.testing.assert_allclose(leaf.numpy(), np.asarray(rleaf), rtol=1e-6, atol=1e-7,
                                       err_msg=str(path))
            computed += name in ("A_log", "dt_b", "w_bias")
        n += 1
    assert n == len(jax.tree_util.tree_leaves(rvals)) > 10
    return computed


def check_full_logits(pair):
    """Full-mode logits and aux loss against the reference, for every impl."""
    cfg, b = pair["cfg"], batch_np(pair["cfg"], 2, 12, seed=1)
    rlogits, raux, _ = pair["rmodel"].apply(pair["rparams"], jnp_batch(b), rt=ref_rt())
    for impl in IMPLS:
        with torch.no_grad():
            logits, aux, c = pair["model"].apply(
                pair["params"], torch_batch(b),
                rt=port_rt(impl, block_q=8, block_kv=8, scan_chunk=8))
        assert c is None and logits.shape == (2, 12, cfg.padded_vocab)
        np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), **TOL, err_msg=impl)
        np.testing.assert_allclose(float(aux), float(raux), **TOL, err_msg=impl)
    return float(raux)


def check_prefill_decode(pair, steps=4):
    """Prefill, then ``steps`` greedy decode steps: the same tokens, logits
    within the tolerance, the cache positions equal."""
    cfg, B, S = pair["cfg"], 2, 10
    b = batch_np(cfg, B, S, seed=2)
    rcache, _ = ref_split_params(pair["rmodel"].init_cache(B, S + steps + 1))
    rlogits, rcache = ref_make_prefill_step(pair["rmodel"], ref_rt())(
        pair["rparams"], jnp_batch(b), rcache)
    cache, _ = split_params(pair["model"].init_cache(B, S + steps + 1))
    logits, cache = make_prefill_step(pair["model"], port_rt())(
        pair["params"], torch_batch(b), cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), **TOL)
    rdecode = ref_make_decode_step(pair["rmodel"], ref_rt())
    decode = make_decode_step(pair["model"], port_rt())
    for _ in range(steps):
        rtok = jnp.argmax(rlogits[:, -1], -1).astype(jnp.int32)[:, None]
        tok = greedy_sample(logits)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(rtok))
        rlogits, rcache = rdecode(pair["rparams"], rtok, rcache)
        logits, cache = decode(pair["params"], tok, cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), **TOL)
    assert cache["pos"] == int(rcache["pos"]) == S + steps
    return to_numpy(rcache), cache


def check_converted_cache(pair):
    """A cache the reference prefilled continues in the port's decode step,
    every leaf in the type the reference stores it in."""
    cfg, B, S = pair["cfg"], 2, 9
    b = batch_np(cfg, B, S, seed=3)
    rcache, _ = ref_split_params(pair["rmodel"].init_cache(B, S + 2))
    rlogits, rcache = ref_make_prefill_step(pair["rmodel"], ref_rt())(
        pair["rparams"], jnp_batch(b), rcache)
    cache = cache_from_numpy(to_numpy(rcache), device="cpu")
    for path, rleaf in jax.tree_util.tree_flatten_with_path(rcache["layers"])[0]:
        leaf = cache["layers"]
        for key in path:
            leaf = leaf[key.key]
        assert leaf.dtype == {"bfloat16": torch.bfloat16, "float32": torch.float32}[
            np.asarray(rleaf).dtype.name], path
    rtok = jnp.argmax(rlogits[:, -1], -1).astype(jnp.int32)[:, None]
    rlogits2, _ = ref_make_decode_step(pair["rmodel"], ref_rt())(pair["rparams"], rtok, rcache)
    logits2, cache = make_decode_step(pair["model"], port_rt())(
        pair["params"], torch.from_numpy(np.array(rtok)), cache)
    np.testing.assert_allclose(logits2.numpy(), np.asarray(rlogits2), **TOL)
    assert cache["pos"] == S + 1


def check_train_step(pair):
    """One AdamW step from the same weights on the same batch: loss, cross
    entropy, aux loss and grad norm within rtol 1e-4."""
    cfg = pair["cfg"]
    b = batch_np(cfg, 2, 12, seed=4, targets=True)
    rstep = jax.jit(ref_make_train_step(pair["rmodel"], RefOptConfig(**OPT), ref_rt()))
    _, _, rm = rstep(pair["rparams"], ref_adamw_init(pair["rparams"], RefOptConfig(**OPT)),
                     jnp_batch(b))
    params = params_from_numpy(to_numpy(pair["rparams"]), device="cpu")
    step = make_train_step(pair["model"], OptimizerConfig(**OPT), port_rt())
    new, _, m = step(params, adamw_init(params, OptimizerConfig(**OPT)), torch_batch(b))
    for k in ("loss", "ce", "aux", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    return {k: float(v) for k, v in m.items()}


def layer_pair(ref_init, cfg_arch, seed=0):
    """A layer's reference params (values) and the same weights in the
    port, for the reduced config of ``cfg_arch``."""
    rcfg = ref_configs.get_config(cfg_arch).reduced()
    rp, _ = ref_split_params(ref_init(jax.random.PRNGKey(seed), rcfg))
    return rcfg, get_config(cfg_arch).reduced(), rp, params_from_numpy(to_numpy(rp), device="cpu")


def cache_pair(rcache_tree):
    """A reference cache P-tree (zeros) as reference values and as the
    port's tensors of the same types."""
    rc, _ = ref_split_params(rcache_tree)
    return rc, jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)).to(
            torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32), rc)


def assert_tree_close(got, want, **tol):
    """Every leaf of the port's dict tree against the reference's."""
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for key in path:
            g = g[key.key]
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, path
        np.testing.assert_allclose(g.float().numpy(), w.astype(np.float32), **tol,
                                   err_msg=str(path))
