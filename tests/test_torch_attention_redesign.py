"""The redesigned attention kernels' host-side logic on the CPU: the decode
kernel's cache split (how many splits, which rows each takes, the merge's
arithmetic in ``decode_attention_plain``) against the reference package's
decode attention, and the flash wrapper's routing between its kernels
(which kernel takes which call, what each can launch, how a request is
clamped).  The kernels themselves run only on the card (``chip_smoke.py``,
phase ``kernels``).

Tolerance 2e-5 in float32, as the reference tests: a split only reorders
fp32 sums.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import decode_attention as dec_mod
from repro_torch.kernels import flash_attention as fla_mod
from repro_torch.kernels import ops

H100_SMS = 132


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, tol=2e-5):
    np.testing.assert_allclose(np.asarray(got.detach().float()), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# decode: the cache split
# ---------------------------------------------------------------------------

DECODE_CASES = {
    # B, H, K, dh, Smax, lengths
    "group7_ragged": (4, 14, 2, 16, 50, [50, 17, 3, 1]),   # short lengths empty the last splits
    "empty_beside_full": (3, 14, 2, 16, 40, [40, 0, 39]),  # length 0: exact zeros
    "mqa": (2, 8, 1, 32, 33, [33, 9]),
}


@pytest.mark.parametrize("n_splits", [1, 2, 3, 7])
@pytest.mark.parametrize("case", list(DECODE_CASES), ids=list(DECODE_CASES))
def test_split_plain_matches_jax_ref(case, n_splits):
    B, H, K, dh, Smax, lengths = DECODE_CASES[case]
    q, k, v = _np(0, B, H, dh), _np(1, B, Smax, K, dh), _np(2, B, Smax, K, dh)
    want = jops.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(lengths, jnp.int32), impl="ref")
    got = dec_mod.decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                         torch.from_numpy(v),
                                         torch.tensor(lengths, dtype=torch.int32),
                                         n_splits=n_splits)
    _close(got, want)
    for b, n in enumerate(lengths):
        if n == 0:
            assert bool((got[b] == 0).all())


def test_one_split_is_the_unsplit_arithmetic():
    B, H, K, dh, Smax, lengths = DECODE_CASES["group7_ragged"]
    q, k, v = (torch.from_numpy(a) for a in (_np(3, B, H, dh), _np(4, B, Smax, K, dh),
                                              _np(5, B, Smax, K, dh)))
    tl = torch.tensor(lengths, dtype=torch.int32)
    a = dec_mod.decode_attention_plain(q, k, v, tl)
    b = dec_mod.decode_attention_plain(q, k, v, tl, n_splits=1)
    assert torch.equal(a, b)


def test_split_plain_bf16_cache_under_f32_query():
    B, H, K, dh, Smax, lengths = DECODE_CASES["group7_ragged"]
    q, k, v = _np(6, B, H, dh), _np(7, B, Smax, K, dh), _np(8, B, Smax, K, dh)
    jk, jv = (jnp.asarray(a, jnp.bfloat16).astype(jnp.float32) for a in (k, v))
    want = jops.decode_attention(jnp.asarray(q), jk, jv, jnp.asarray(lengths, jnp.int32),
                                 impl="ref")
    tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (k, v))
    got = dec_mod.decode_attention_plain(torch.from_numpy(q), tk, tv,
                                         torch.tensor(lengths, dtype=torch.int32), n_splits=9)
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("args,want", [
    ((8, 2, 576, 64, H100_SMS), 9),      # the served shape: 144 blocks, one trip a split
    ((132, 2, 576, 64, H100_SMS), 1),    # B*K >= 2*SMs: one split
    ((8, 2, 40, 64, H100_SMS), 1),       # Smax < block_kv: one split
    ((8, 2, 8192, 64, H100_SMS), 16),    # a long cache: two blocks an SM at most
    ((1, 2, 32768, 32, H100_SMS), 132),
], ids=["served", "wide_batch", "short_cache", "cache_8k", "cache_32k_b1"])
def test_split_count(args, want):
    assert dec_mod.split_count(*args) == want


def test_split_rows_cover_each_length_once():
    lengths = torch.tensor([0, 1, 3, 10, 575, 576])
    for n in (1, 2, 7, 9):
        for length, r in zip(lengths.tolist(), dec_mod.split_rows(lengths, n).tolist()):
            # the kernel's ranges: split s takes [min(s r, L), min(s r + r, L))
            rows = [i for s in range(n) for i in range(min(s * r, length), min(s * r + r, length))]
            assert rows == list(range(length))


def test_cpu_call_records_one_split_and_matches_jax():
    B, H, K, dh, Smax, lengths = DECODE_CASES["empty_beside_full"]
    q, k, v = _np(9, B, H, dh), _np(10, B, Smax, K, dh), _np(11, B, Smax, K, dh)
    want = jops.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(lengths, jnp.int32), impl="ref")
    got = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               torch.tensor(lengths, dtype=torch.int32), impl="cuda")
    _close(got, want)
    assert dec_mod.decode_attention.last_splits == 1
    assert dec_mod.decode_attention.last_config == {"block_kv": 64}


# ---------------------------------------------------------------------------
# flash: which kernel takes which call
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kwargs,want", [
    (dict(block_q=128, dtype=torch.bfloat16), "wgmma"),
    (dict(block_q=64, dtype=torch.bfloat16, dh=128), "wgmma"),
    (dict(block_q=64, dtype=torch.bfloat16, dh=80), "wgmma"),     # padded to 128 on chip
    (dict(block_q=32, dtype=torch.bfloat16), "mma"),
    (dict(block_q=128, dtype=torch.bfloat16, dh=24), "mma"),      # no multiple of 16
    (dict(block_q=128, dtype=torch.bfloat16, dh=32, dv=16), "mma"),
    (dict(block_q=128, dtype=torch.bfloat16, tma_ok=False), "mma"),
    (dict(block_q=8, dtype=torch.bfloat16), "fma"),
    (dict(block_q=64, dtype=torch.float32), "tiled"),
    (dict(block_q=16, dtype=None), "tiled"),
    (dict(block_q=8, dtype=torch.float32), "fma"),
], ids=["bf16_128", "bf16_dh128", "bf16_dh80", "bf16_32", "bf16_dh24", "bf16_dv_ne_dh",
        "bf16_unaligned", "bf16_8", "f32_64", "f32_16_default_dtype", "f32_8"])
def test_route(kwargs, want):
    assert fla_mod.route(**kwargs) == want


def test_tma_alignment_of_views():
    x = torch.zeros(2, 100, 4, 64, dtype=torch.bfloat16)
    assert fla_mod.tma_aligned(x)
    assert fla_mod.tma_aligned(torch.zeros(2, 4, 100, 64, dtype=torch.bfloat16).transpose(1, 2))
    # a head stride of 68 elements (136 bytes) is no multiple of 16 bytes
    assert not fla_mod.tma_aligned(torch.zeros(1, 90, 2, 68, dtype=torch.bfloat16)[..., :64])
    # a K/V head broadcast by expand has stride 0
    assert not fla_mod.tma_aligned(torch.zeros(1, 9, 1, 64).expand(1, 9, 4, 64))
    # a size-1 dim's stride does not matter
    assert fla_mod.tma_aligned(torch.zeros(1, 9, 1, 64).expand(1, 9, 1, 64))


@pytest.mark.parametrize("config,dtype,ok", [
    ({"block_q": 128, "block_kv": 128}, torch.bfloat16, True),
    ({"block_q": 128, "block_kv": 16}, torch.bfloat16, True),
    ({"block_q": 128, "block_kv": 8}, torch.bfloat16, False),    # below wgmma's smallest tile
    ({"block_q": 64, "block_kv": 256}, torch.bfloat16, False),   # above its largest
    ({"block_q": 32, "block_kv": 512}, torch.bfloat16, True),    # mma.sync: 512 rows fit
    ({"block_q": 64, "block_kv": 64}, None, True),
    ({"block_q": 64, "block_kv": 8}, None, False),               # below the tiled kernel's tile
    ({"block_q": 128, "block_kv": 64}, None, False),             # above it
    ({"block_q": 8, "block_kv": 8}, None, True),                 # one thread a row
], ids=["wgmma_128x128", "wgmma_128x16", "wgmma_kv8", "wgmma_kv256", "mma_32x512",
        "tiled_64x64", "tiled_kv8", "tiled_q128", "fma_8x8"])
def test_feasible_follows_the_route(config, dtype, ok):
    assert fla_mod.feasible(config, {"dh": 64}, dtype) is ok


def test_flash_cpu_call_records_route_and_matches_jax():
    """At a wgmma-routed request (bf16, 128 x 128) and a tiled one (f32),
    the CPU call runs the plain version and records the kernel it would
    have launched."""
    q, k, v = _np(0, 2, 77, 14, 64), _np(1, 2, 190, 2, 64), _np(2, 2, 190, 2, 64)
    want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                          impl="ref")
    got = fla_mod.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  block_q=512, block_kv=512)
    _close(got, want)
    assert fla_mod.flash_attention.last_kernel == "tiled"
    assert fla_mod.flash_attention.last_config == {"block_q": 64, "block_kv": 64}
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = fla_mod.flash_attention(tq, tk, tv, block_q=512, block_kv=512)
    _close(got, want, 2e-2)
    assert fla_mod.flash_attention.last_kernel == "wgmma"
    assert fla_mod.flash_attention.last_config == {"block_q": 128, "block_kv": 128}
