"""Every module of the port that holds a kernel, against the reference
package on the CPU: the same numpy inputs go through the JAX function
(oracle, and the Pallas kernel in interpret mode) and through the port's
oracle, the kernel's plain version and the ``impl="cuda"`` dispatch (which
takes the plain version for a CPU tensor).

Tolerances are the reference tests' own: attention f32 2e-5, rmsnorm f32
1e-5, bf16 2e-2 (compared in float32); gradients 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as dec_mod
from repro_torch.kernels import flash_attention as fla_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rms_mod
from repro_torch.kernels._tiles import clamp_tile

SWEEP = [
    # B, Sq, Sk, H, K, dh, causal, window
    (1, 16, 16, 4, 4, 16, True, None),
    (2, 37, 37, 4, 2, 16, True, None),   # GQA + ragged edge
    (1, 64, 64, 8, 1, 32, True, None),   # MQA
    (1, 50, 50, 4, 4, 16, True, 9),      # sliding window
    (2, 13, 29, 4, 1, 8, False, None),   # cross-attention shape
    (1, 128, 128, 2, 2, 64, True, None),
]
IDS = [str(c) for c in SWEEP]


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _qkv(case, seed=0):
    B, Sq, Sk, H, K, dh, _, _ = case
    return _np(seed, B, Sq, H, dh), _np(seed + 1, B, Sk, K, dh), _np(seed + 2, B, Sk, K, dh)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", SWEEP, ids=IDS)
def test_attention_ref_matches_jax_ref(case):
    q, k, v = _qkv(case)
    want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=case[6], window=case[7], impl="ref")
    _close(ref.attention_ref(_t(q), _t(k), _t(v), causal=case[6], window=case[7]),
           want, 2e-5)


@pytest.mark.parametrize("case", SWEEP, ids=IDS)
def test_flash_plain_matches_jax_ref(case):
    q, k, v = _qkv(case)
    want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=case[6], window=case[7], impl="ref")
    got = fla_mod.flash_attention_plain(_t(q), _t(k), _t(v), causal=case[6],
                                        window=case[7], block_kv=16)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("case", SWEEP, ids=IDS)
def test_ops_attention_cuda_impl_on_cpu_matches_jax_ref(case):
    q, k, v = _qkv(case)
    want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=case[6], window=case[7], impl="ref")
    before = fla_mod.flash_attention.launches
    got = ops.attention(_t(q), _t(k), _t(v), causal=case[6], window=case[7],
                        impl="cuda", block_q=16, block_kv=16)
    _close(got, want, 2e-5)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert fla_mod.flash_attention.launches == before
    assert fla_mod.flash_attention.last_config["block_kv"] <= 16


@pytest.mark.parametrize("case", [SWEEP[1], SWEEP[3], SWEEP[4]],
                         ids=[IDS[1], IDS[3], IDS[4]])
def test_attention_matches_jax_pallas_interpret(case):
    q, k, v = _qkv(case)
    want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=case[6], window=case[7], impl="pallas",
                          block_q=16, block_kv=16)
    for got in (ref.attention_ref(_t(q), _t(k), _t(v), causal=case[6], window=case[7]),
                ops.attention(_t(q), _t(k), _t(v), causal=case[6], window=case[7],
                              impl="cuda", block_q=16, block_kv=16)):
        _close(got, want, 2e-5)


@pytest.mark.parametrize("case", [SWEEP[1], SWEEP[5]], ids=[IDS[1], IDS[5]])
def test_attention_bf16_matches_jax_ref(case):
    q, k, v = _qkv(case)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jops.attention(jq, jk, jv, causal=case[6], window=case[7],
                                     impl="ref"), np.float32)
    tq, tk, tv = (_t(a, torch.bfloat16) for a in (q, k, v))
    for got in (ref.attention_ref(tq, tk, tv, causal=case[6], window=case[7]),
                ops.attention(tq, tk, tv, causal=case[6], window=case[7], impl="cuda")):
        assert got.dtype == torch.bfloat16
        _close(got, want, 2e-2)


@pytest.mark.parametrize("case", SWEEP, ids=IDS)
def test_chunked_attention_matches_jax_ref(case):
    q, k, v = _qkv(case)
    want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=case[6], window=case[7], impl="ref")
    for unroll, prune in ((False, False), (True, False), (True, True)):
        got = ref.attention_chunked_ref(_t(q), _t(k), _t(v), causal=case[6],
                                        window=case[7], block_q=16,
                                        unroll=unroll, prune=prune)
        _close(got, want, 2e-5)
        jgot = jref.attention_chunked_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          causal=case[6], window=case[7], block_q=16,
                                          unroll=unroll, prune=prune)
        _close(got, jgot, 2e-5)


def test_dv_differs_from_dh():
    """MLA-shaped: qk head dim 24, v head dim 16 — every impl handles it."""
    q, k, v = _np(0, 2, 33, 4, 24), _np(1, 2, 33, 4, 24), _np(2, 2, 33, 4, 16)
    want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl="ref")
    assert want.shape == (2, 33, 4, 16)
    for kwargs in ({"impl": "ref"}, {"impl": "chunked", "block_q": 16},
                   {"impl": "chunked", "block_q": 16, "unroll": True, "prune": True},
                   {"impl": "cuda", "block_q": 16, "block_kv": 16}):
        got = ops.attention(_t(q), _t(k), _t(v), **kwargs)
        assert got.shape == (2, 33, 4, 16)
        _close(got, want, 2e-5)


def test_fully_masked_rows_are_exact_zeros():
    """Window smaller than the gap, and more queries than keys: rows that
    attend nothing give exact zeros, not NaN."""
    q, k, v = _np(0, 1, 8, 2, 8), _np(1, 1, 8, 2, 8), _np(2, 1, 8, 2, 8)
    for impl in ("ref", "cuda", "chunked"):
        out = ops.attention(_t(q), _t(k), _t(v), causal=False, window=1, impl=impl,
                            block_q=4, block_kv=4)
        assert not bool(torch.isnan(out).any())
    q2, k2, v2 = _np(3, 1, 40, 2, 16), _np(4, 1, 24, 1, 16), _np(5, 1, 24, 1, 16)
    want = jops.attention(jnp.asarray(q2), jnp.asarray(k2), jnp.asarray(v2), impl="ref")
    for impl in ("ref", "cuda"):
        out = ops.attention(_t(q2), _t(k2), _t(v2), impl=impl, block_q=16, block_kv=8)
        assert bool((out[:, :16] == 0).all())  # offset -16: the first 16 rows see no key
        _close(out, want, 2e-5)


def test_attention_grads_through_the_autograd_pairing_match_jax():
    """Kernel forward, oracle-recompute backward vs jax.grad of the oracle."""
    q, k, v = _np(0, 1, 32, 4, 16), _np(1, 1, 32, 2, 16), _np(2, 1, 32, 2, 16)
    g_ref = jax.grad(lambda q, k, v: jops.attention(q, k, v, impl="ref").sum(),
                     (0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for impl in ("cuda", "ref"):
        tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
        ops.attention(tq, tk, tv, impl=impl, block_q=16, block_kv=16).sum().backward()
        for got, want in zip((tq.grad, tk.grad, tv.grad), g_ref):
            _close(got, want, 1e-5)
    # only the inputs that ask for a gradient get one
    tq, tk, tv = _t(q).requires_grad_(), _t(k), _t(v)
    ops.attention(tq, tk, tv, impl="cuda").sum().backward()
    assert tq.grad is not None and tk.grad is None
    _close(tq.grad, g_ref[0], 1e-5)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lengths", [[50, 17, 1], [50, 0, 33]], ids=["ragged", "empty"])
def test_decode_attention_matches_jax(lengths):
    B, H, K, dh, Smax = 3, 8, 2, 16, 50
    q, k, v = _np(0, B, H, dh), _np(1, B, Smax, K, dh), _np(2, B, Smax, K, dh)
    jl = jnp.asarray(lengths, jnp.int32)
    want = jops.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jl, impl="ref")
    want_pal = jops.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jl,
                                     impl="pallas", block_kv=16)
    tl = torch.tensor(lengths, dtype=torch.int32)
    for got in (ref.decode_attention_ref(_t(q), _t(k), _t(v), tl),
                dec_mod.decode_attention_plain(_t(q), _t(k), _t(v), tl),
                ops.decode_attention(_t(q), _t(k), _t(v), tl, impl="cuda", block_kv=16)):
        _close(got, want, 2e-5)
        _close(got, want_pal, 2e-5)
        if 0 in lengths:
            assert bool((got[lengths.index(0)] == 0).all())
    assert dec_mod.decode_attention.launches == 0 or torch.cuda.is_available()


def test_decode_attention_bf16_and_mixed_cache():
    B, H, K, dh, Smax = 3, 8, 1, 16, 50   # MQA
    q, k, v = _np(0, B, H, dh), _np(1, B, Smax, K, dh), _np(2, B, Smax, K, dh)
    lengths = [50, 17, 1]
    jl, tl = jnp.asarray(lengths, jnp.int32), torch.tensor(lengths, dtype=torch.int32)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jops.decode_attention(jq, jk, jv, jl, impl="ref"), np.float32)
    tq, tk, tv = (_t(a, torch.bfloat16) for a in (q, k, v))
    for got in (ops.decode_attention(tq, tk, tv, tl, impl="ref"),
                ops.decode_attention(tq, tk, tv, tl, impl="cuda")):
        assert got.dtype == torch.bfloat16
        _close(got, want, 2e-2)
    # an f32 query over a bf16 cache equals the reference's upcast of the cache
    want32 = jops.decode_attention(jnp.asarray(q), jk.astype(jnp.float32),
                                   jv.astype(jnp.float32), jl, impl="ref")
    for impl in ("ref", "cuda"):
        got = ops.decode_attention(_t(q), tk, tv, tl, impl=impl)
        assert got.dtype == torch.float32
        _close(got, want32, 2e-5)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_matches_jax(dtype):
    jdt, tdt, tol = ((jnp.float32, torch.float32, 1e-5) if dtype == "f32"
                     else (jnp.bfloat16, torch.bfloat16, 2e-2))
    x, s = _np(0, 5, 33, 64), _np(1, 64)
    jx = jnp.asarray(x, jdt)
    want_ref = np.asarray(jops.rmsnorm(jx, jnp.asarray(s), impl="ref"), np.float32)
    want_pal = np.asarray(jops.rmsnorm(jx, jnp.asarray(s), impl="pallas", block_rows=8),
                          np.float32)
    tx = _t(x, tdt)
    for got in (ref.rmsnorm_ref(tx, _t(s)), rms_mod.rmsnorm_plain(tx, _t(s)),
                ops.rmsnorm(tx, _t(s), impl="cuda", block_rows=8)):
        assert got.dtype == tdt and got.shape == tx.shape
        _close(got, want_ref, tol)
        _close(got, want_pal, tol)
    assert rms_mod.rmsnorm.last_config == {"block_rows": 8}


@pytest.mark.parametrize("impl", ["ref", "cuda"])
def test_rmsnorm_grads_match_jax(impl):
    x, s = _np(0, 3, 7, 32), _np(1, 32)
    w = _np(2, 3, 7, 32)  # a non-trivial cotangent
    gx, gs = jax.grad(lambda x, s: (jops.rmsnorm(x, s, impl="ref") * w).sum(), (0, 1))(
        jnp.asarray(x), jnp.asarray(s))
    tx, ts = _t(x).requires_grad_(), _t(s).requires_grad_()
    (ops.rmsnorm(tx, ts, impl=impl) * _t(w)).sum().backward()
    _close(tx.grad, gx, 1e-5)
    _close(ts.grad, gs, 1e-5)


# ---------------------------------------------------------------------------
# tiles, dispatch, device rules
# ---------------------------------------------------------------------------


def test_tile_requests_are_clamped_to_feasible_powers_of_two():
    # the Runtime default of 512 x 512 is more than a block can hold: fp32
    # from 16 query rows on takes the register-tiled kernel (tiles 16..64)
    cfg = fla_mod.effective_config(512, 512, 512, 512, 64, 64)
    assert cfg == {"block_q": 64, "block_kv": 64}
    assert fla_mod.route(64) == "tiled"
    assert fla_mod.feasible(cfg, {"dh": 64}) and not fla_mod.feasible(
        {"block_q": 512, "block_kv": 512}, {"dh": 64})
    assert fla_mod.smem_bytes(256, 64, 64) <= fla_mod.MAX_SMEM_BYTES
    # two fp32 blocks of 64 x 64 fit an SM's shared memory
    assert 2 * fla_mod.smem_bytes(64, 64, 64, kernel="tiled", block_q=64) <= \
        fla_mod.MAX_SMEM_BYTES
    assert not fla_mod.feasible({"block_q": 64, "block_kv": 128}, {"dh": 64})
    # below 16 query rows the one-thread-a-row kernel takes any K/V tile
    assert fla_mod.effective_config(8, 8, 512, 512, 64, 64) == {"block_q": 8, "block_kv": 8}
    assert fla_mod.route(8) == fla_mod.route(8, torch.bfloat16) == "fma"
    # bf16 at 64 or 128 query rows takes the wgmma kernel (K/V tiles 16..128),
    # other bf16 calls from 16 rows on the mma.sync kernel: a warp per 16
    # rows, 8 warps at most, bf16 tiles
    assert fla_mod.effective_config(512, 512, 512, 512, 64, 64, torch.bfloat16) == \
        {"block_q": 128, "block_kv": 128}
    assert fla_mod.route(128, torch.bfloat16) == fla_mod.route(64, torch.bfloat16) == "wgmma"
    assert fla_mod.effective_config(64, 8, 512, 512, 64, 64, torch.bfloat16) == \
        {"block_q": 64, "block_kv": 16}
    assert fla_mod.route(32, torch.bfloat16) == "mma"
    assert fla_mod.effective_config(32, 512, 512, 512, 64, 64, torch.bfloat16) == \
        {"block_q": 32, "block_kv": 512}
    # what wgmma cannot take goes to mma.sync: a head dim that is no multiple
    # of 16, dv != dh, a view TMA cannot read
    assert fla_mod.route(128, torch.bfloat16, dh=24) == "mma"
    assert fla_mod.route(128, torch.bfloat16, dh=32, dv=16) == "mma"
    assert fla_mod.route(128, torch.bfloat16, tma_ok=False) == "mma"
    assert fla_mod.effective_config(512, 512, 512, 512, 64, 64, torch.bfloat16,
                                    tma_ok=False) == {"block_q": 128, "block_kv": 512}
    assert fla_mod.effective_config(8, 8, 512, 512, 64, 64, torch.bfloat16) == \
        {"block_q": 8, "block_kv": 8}
    assert fla_mod.uses_tensor_cores(16, torch.bfloat16)
    assert fla_mod.uses_tensor_cores(128, torch.bfloat16)
    assert not fla_mod.uses_tensor_cores(8, torch.bfloat16)
    assert not fla_mod.uses_tensor_cores(128, torch.float32)
    assert not fla_mod.feasible({"block_q": 256, "block_kv": 64}, {"dh": 64}, torch.bfloat16)
    assert not fla_mod.feasible({"block_q": 128, "block_kv": 256}, {"dh": 64}, torch.bfloat16)
    # never above the request, never above the padded sequence
    assert fla_mod.effective_config(100, 48, 1000, 1000, 16, 16) == {"block_q": 64, "block_kv": 32}
    assert fla_mod.effective_config(128, 128, 37, 29, 16, 16) == {"block_q": 64, "block_kv": 32}
    assert dec_mod.effective_config(512, 14, 2, 64) == {"block_kv": 64}
    assert dec_mod.effective_config(1, 8, 2, 16) == {"block_kv": dec_mod.MIN_BLOCK_KV}
    # block_rows bounds the rows a program holds; the grid fills the card
    assert rms_mod.effective_config(256, 4096, 896) == {"block_rows": 256}
    assert rms_mod.geometry(4096, 896, 256, 132)["tile_rows"] == 4
    assert rms_mod.geometry(4096, 896, 1, 132)["tile_rows"] == 1
    assert rms_mod.effective_config(256, 3, 64) == {"block_rows": 4}
    assert rms_mod.feasible({"block_rows": 4096}, {"D": 896})
    assert rms_mod.feasible({"block_rows": 1}, {"D": rms_mod.MAX_D})
    assert not rms_mod.feasible({"block_rows": 1}, {"D": rms_mod.MAX_D + 1})
    assert clamp_tile("t", 96, lambda t: t <= 16) == 16


@pytest.mark.parametrize("bad", [0, -4, 2.0, "8", True, None])
def test_tile_request_that_is_no_positive_integer_raises(bad):
    q, k, v = (_t(a) for a in (_np(0, 1, 8, 2, 8), _np(1, 1, 8, 2, 8), _np(2, 1, 8, 2, 8)))
    with pytest.raises(ValueError):
        fla_mod.flash_attention(q, k, v, block_q=bad)
    with pytest.raises(ValueError):
        dec_mod.decode_attention(q[:, 0], k, v, torch.tensor([3]), block_kv=bad)
    with pytest.raises(ValueError):
        rms_mod.rmsnorm(q, torch.ones(8), block_rows=bad)


def test_impl_vocabulary_and_unported_scans():
    """The scans are ported now: they take the same impl vocabulary as the
    other kernels and refuse the reference's spelling."""
    q, k, v = (_t(a) for a in (_np(0, 1, 8, 2, 8), _np(1, 1, 8, 2, 8), _np(2, 1, 8, 2, 8)))
    with pytest.raises(ValueError, match="cuda"):
        ops.attention(q, k, v, impl="pallas")
    with pytest.raises(ValueError):
        ops.rmsnorm(q, torch.ones(8), impl="triton")
    x, A, Bc = _t(_np(3, 1, 8, 4)), -_t(_np(4, 4, 2)).abs(), _t(_np(5, 1, 8, 2))
    with pytest.raises(ValueError, match="cuda"):
        ops.ssm_scan(x, x.abs(), A, Bc, Bc, torch.ones(4), impl="pallas")
    assert ops.ssm_scan(x, x.abs(), A, Bc, Bc, torch.ones(4), impl="cuda").shape == x.shape
    with pytest.raises(ValueError, match="cuda"):
        ops.gla_scan(q, k[:, :, :1].expand(1, 8, 2, 8), v, q.sigmoid(), torch.ones(2, 8),
                     impl="pallas")
    assert ops.gla_scan(q, q, v, q.sigmoid(), torch.ones(2, 8), impl="cuda").shape == v.shape


def test_wrappers_refuse_what_they_do_not_take():
    q, k, v = (_t(a) for a in (_np(0, 1, 8, 4, 8), _np(1, 1, 8, 2, 8), _np(2, 1, 8, 2, 8)))
    with pytest.raises(ValueError):
        fla_mod.flash_attention(q, k[:, :, :, :4], v)          # head dims differ
    with pytest.raises(ValueError):
        fla_mod.flash_attention(q[:, :, :3], k, v)             # H % K != 0
    with pytest.raises(ValueError):
        dec_mod.decode_attention(q[:, 0], k, v, torch.tensor([1, 2]))  # lengths shape
    with pytest.raises(ValueError):
        rms_mod.rmsnorm(q, torch.ones(4))
    # a tensor on the meta device is neither CPU nor CUDA: no silent fallback
    with pytest.raises(RuntimeError, match="device"):
        rms_mod.rmsnorm(torch.empty(4, 8, device="meta"), torch.ones(8, device="meta"))
    with pytest.raises(RuntimeError, match="device"):
        fla_mod.flash_attention(*(t.to("meta") for t in (q, k, v)))
