"""The redesigned scan kernels' wrappers on the CPU: the split rules (lanes a
column or channel, columns a block, blocks a group) as pure functions of the
shapes and the SM count, the shared-memory and feasibility limits, and the
plain versions cut as the kernels cut the state -- each lane's partial over
its rows, summed over the lanes in the kernels' reduce-scatter order --
against the unsplit plain versions and the JAX reference package's naive
scans (``repro.kernels.ref``) on the same numpy inputs.

Tolerances are the reference tests' own f32 ones (tests/test_kernels_scans.py):
ssm atol = rtol = 2e-4; gla atol 2e-4, rtol 2e-3.  A split only reorders fp32
sums, so the split and unsplit plain versions agree far inside them.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import _tiles
from repro_torch.kernels import gla_scan as gla
from repro_torch.kernels import ssm_scan as ssm

H100_SMS = 132
SSM_TOL = dict(atol=2e-4, rtol=2e-4)
GLA_TOL = dict(atol=2e-4, rtol=2e-3)

# the sweep's shapes (Jamba v0.1's mixer, RWKV-6 3B) and one long sequence
SSM_SHAPES = [(2, 2048, 8192, 16), (1, 8192, 8192, 16)]
GLA_SHAPES = [(2, 2048, 40, 64, 64), (1, 8192, 40, 64, 64)]


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()), np.asarray(want, np.float32),
                               **tol)


def ssm_inputs(B, S, D, N, seed=0):
    rng = np.random.default_rng(seed)
    return (_np(rng, B, S, D), np.abs(_np(rng, B, S, D)) * 0.1, -np.abs(_np(rng, D, N)),
            _np(rng, B, S, N), _np(rng, B, S, N), _np(rng, D))


def gla_inputs(B, S, H, dk, dv, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = _np(rng, B, S, H, dk), _np(rng, B, S, H, dk), _np(rng, B, S, H, dv)
    w = np.exp(-np.exp(_np(rng, B, S, H, dk) * 0.5 - 1.0)).astype(np.float32)
    return r, k, v, w, _np(rng, H, dk)


# ---------------------------------------------------------------------------
# split rules
# ---------------------------------------------------------------------------


def _ssm_split_ok(sp, B, D, N, block_d):
    lanes, g, cpc = sp["lanes"], sp["groups"], sp["channels"]
    assert lanes == ssm.lanes_for(N) == max(1, ssm.pad_state(N) // 8)
    assert g & (g - 1) == 0 and cpc * g >= block_d
    assert sp["ctas"] == B * math.ceil(D / block_d) * g
    assert 32 <= sp["threads"] <= ssm.MAX_THREADS and sp["threads"] % 32 == 0
    assert sp["threads"] >= cpc * lanes


@pytest.mark.parametrize("shape", SSM_SHAPES, ids=str)
def test_ssm_split_fills_every_sm_at_the_default_request(shape):
    B, S, D, N = shape
    cfg = ssm.effective_config(128, 256, S, D, N)  # the ops / tuning default
    sp = ssm.split(B, D, N, cfg["block_d"], H100_SMS)
    _ssm_split_ok(sp, B, D, N, cfg["block_d"])
    assert sp["ctas"] >= H100_SMS
    assert ssm.feasible(cfg, {"N": N})


def test_ssm_split_at_the_sweep_shape():
    assert ssm.split(2, 8192, 16, 256, H100_SMS) == \
        {"lanes": 2, "groups": 4, "channels": 64, "ctas": 256, "threads": 128}
    assert ssm.split(1, 8192, 16, 256, H100_SMS) == \
        {"lanes": 2, "groups": 8, "channels": 32, "ctas": 256, "threads": 64}


@pytest.mark.parametrize("block_d", [8, 16, 64, 256, 1024, 8192])
@pytest.mark.parametrize("N", [1, 4, 8, 16, 33, 64])
@pytest.mark.parametrize("sms", [78, 114, 132])
def test_ssm_split_is_launchable_for_every_block_d(block_d, N, sms):
    B, D = 2, 8192
    sp = ssm.split(B, D, N, block_d, sms)
    _ssm_split_ok(sp, B, D, N, block_d)
    # the fewest groups that fill the card, unless a block would drop below a warp
    if sp["ctas"] < sms:
        threads = block_d * sp["lanes"]
        assert sp["groups"] >= threads // 32 or sp["groups"] * 2 > block_d


def _gla_split_ok(sp, B, H, dk, dv, chunk):
    lanes, cols = sp["lanes"], sp["cols"]
    assert gla.pad_key_dim(dk) // lanes in gla.LANE_ROWS
    assert cols in gla.COL_CHOICES
    assert sp["blocks"] == B * H * math.ceil(dv / cols)
    assert sp["threads"] % 32 == 0 and sp["threads"] <= gla.MAX_THREADS
    assert gla.smem_bytes(chunk, dk, cols) <= gla.MAX_SMEM_BYTES


@pytest.mark.parametrize("chunk", [64, 128])
@pytest.mark.parametrize("shape", GLA_SHAPES, ids=str)
def test_gla_split_fills_every_sm_in_the_fewest_waves(shape, chunk):
    B, S, H, dk, dv = shape
    cfg = gla.effective_config(chunk, S, dk, dv)  # 64: the tuning default; 128: the wrapper's
    sp = gla.split(B, H, dk, dv, H100_SMS, cfg["chunk"])
    _gla_split_ok(sp, B, H, dk, dv, cfg["chunk"])
    assert gla.feasible(cfg, {"dk": dk, "dv": dv})

    def waves(cols):
        lanes = gla.lanes_for(dk)
        per_sm = gla.resident(cfg["chunk"], dk, cols, lanes)
        return -(-B * H * -(-dv // cols) // (per_sm * H100_SMS))

    fits = [c for c in gla.COL_CHOICES if gla.smem_bytes(cfg["chunk"], dk, c)
            <= gla.MAX_SMEM_BYTES]
    assert waves(sp["cols"]) == min(waves(c) for c in fits)
    if (B, S) == (2, 2048):  # the sweep's shape: a block on every SM
        assert sp["blocks"] >= H100_SMS


def test_gla_split_at_the_sweep_shape():
    # two 115 KB blocks share an SM at chunk 64; at 128 a block is alone and
    # takes twice the lanes
    assert gla.split(2, 40, 64, 64, H100_SMS, 64) == \
        {"lanes": 8, "cols": 32, "blocks": 160, "threads": 64}
    assert gla.split(2, 40, 64, 64, H100_SMS, 128) == \
        {"lanes": 16, "cols": 32, "blocks": 160, "threads": 128}
    # one sequence at chunk 64: 16 columns a block, which at 8 rows a lane
    # would be one warp, so 4 rows a lane
    assert gla.split(1, 40, 64, 64, H100_SMS, 64) == \
        {"lanes": 16, "cols": 16, "blocks": 160, "threads": 64}
    # one sequence at chunk 128: 160 blocks alone on their SMs would take two
    # waves; 80 take one
    assert gla.split(1, 40, 64, 64, H100_SMS, 128) == \
        {"lanes": 16, "cols": 32, "blocks": 80, "threads": 128}


@pytest.mark.parametrize("chunk", [1, 8, 32, 64, 128])
@pytest.mark.parametrize("dk", [5, 8, 16, 24, 64, 128])
@pytest.mark.parametrize("dv", [8, 40, 64, 600])
def test_gla_split_is_launchable(dk, dv, chunk):
    c = gla.effective_config(chunk, 4096, dk, dv)["chunk"]  # as the wrapper clamps it
    for B, H in ((1, 1), (2, 40), (8, 64)):
        sp = gla.split(B, H, dk, dv, H100_SMS, c)
        _gla_split_ok(sp, B, H, dk, dv, c)


# ---------------------------------------------------------------------------
# shared memory, feasibility, clamping
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N,largest", [(1, 2048), (4, 2048), (8, 1024), (16, 512),
                                       (33, 128), (64, 128)])
def test_ssm_largest_feasible_chunk(N, largest):
    # B and C, double-buffered fp32: 16 * chunk * padded N bytes
    assert ssm.smem_bytes(largest, N) == 16 * largest * ssm.pad_state(N)
    assert ssm.feasible({"chunk": largest, "block_d": 1}, {"N": N})
    assert not ssm.feasible({"chunk": 2 * largest, "block_d": 1}, {"N": N})
    assert ssm.effective_config(1 << 20, 256, 1 << 20, 8192, N)["chunk"] == largest


@pytest.mark.parametrize("dk,largest", [(8, 512), (16, 512), (32, 256), (64, 128),
                                        (128, 64)])
def test_gla_largest_feasible_chunk(dk, largest):
    # r, k, w and 8 columns of v, double-buffered fp32
    assert gla.smem_bytes(largest, dk) == 8 * largest * (3 * gla.pad_key_dim(dk) + 8)
    assert gla.feasible({"chunk": largest}, {"dk": dk, "dv": 64})
    assert not gla.feasible({"chunk": 2 * largest}, {"dk": dk, "dv": 64})
    assert gla.effective_config(1 << 20, 1 << 20, dk, 64) == {"chunk": largest}


def test_effective_configs_stay_powers_of_two_and_clamp_to_the_data():
    assert ssm.effective_config(100, 100, 50, 12, 8) == {"chunk": 64, "block_d": 16}
    assert ssm.effective_config(3, 3, 2, 2, 16) == {"chunk": 2, "block_d": 2}
    assert gla.effective_config(100, 50, 8, 8) == {"chunk": 64}
    assert gla.effective_config(1, 5, 64, 64) == {"chunk": 1}
    with pytest.raises(ValueError):
        ssm.effective_config(0, 8, 16, 16, 16)
    with pytest.raises(ValueError):
        gla.effective_config(8, 16, 129, 8)


def test_cpu_calls_record_no_split():
    x, dt, A, Bi, Ci, Dv = (_t(a) for a in ssm_inputs(1, 9, 8, 4))
    ssm.ssm_scan(x, dt, A, Bi, Ci, Dv, chunk=8, block_d=8)
    assert ssm.ssm_scan.last_split is None and ssm.ssm_scan.last_config == \
        {"chunk": 8, "block_d": 8}
    r, k, v, w, u = (_t(a) for a in gla_inputs(1, 9, 2, 8, 8))
    gla.gla_scan(r, k, v, w, u, chunk=8)
    assert gla.gla_scan.last_split is None and gla.gla_scan.last_config == {"chunk": 8}


# ---------------------------------------------------------------------------
# the lane split and its sum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("padded,lanes", [(8, 1), (8, 2), (16, 4), (64, 8), (64, 16),
                                          (128, 32)])
def test_lane_index_covers_every_row_once(padded, lanes):
    idx = _tiles.lane_index(padded, lanes)
    assert idx.shape == (lanes, padded // lanes)
    assert sorted(idx.flatten().tolist()) == list(range(padded))
    # the lanes of one column read neighbouring 16-byte words
    assert idx[:, 0].tolist() == [4 * lane for lane in range(lanes)]


@pytest.mark.parametrize("lanes,ct", [(1, 1), (2, 1), (8, 1), (1, 4), (2, 4), (4, 4),
                                      (8, 4), (16, 4), (32, 4)])
def test_reduce_lanes_is_the_sum_over_lanes(lanes, ct):
    parts = _t(_np(np.random.default_rng(lanes * 10 + ct), lanes, ct, 3, 5))
    _close(_tiles.reduce_lanes(parts, ct), parts.sum(dim=0).numpy(), atol=1e-5, rtol=1e-6)
    # every index it builds lies on the parts' device (the card's, on the card)
    assert _tiles.reduce_lanes(parts.to("meta"), ct).shape == (ct, 3, 5)


@pytest.mark.parametrize("lanes", [2, 8])
def test_plain_splits_build_nothing_on_another_device(lanes):
    """The plain versions cut by lanes run on the card in chip_smoke.py; on
    the meta device any index built on the CPU raises as it would there."""
    x, dt, A, Bi, Ci, Dv = (_t(a).to("meta") for a in ssm_inputs(1, 3, 4, 16))
    assert ssm.ssm_scan_plain(x, dt, A, Bi, Ci, Dv, lanes=2).shape == (1, 3, 4)
    r, k, v, w, u = (_t(a).to("meta") for a in gla_inputs(1, 3, 2, 64, 12))
    assert gla.gla_scan_plain(r, k, v, w, u, lanes=lanes).shape == (1, 3, 2, 12)


# ---------------------------------------------------------------------------
# plain versions cut as the kernels cut the state
# ---------------------------------------------------------------------------

SSM_SPLIT_CASES = [(2, 20, 12, 4, 1), (2, 30, 12, 5, 1), (1, 25, 16, 16, 2),
                   (1, 17, 24, 16, 4), (2, 12, 8, 33, 8), (1, 10, 8, 64, 8),
                   (1, 9, 6, 64, 16)]


@pytest.mark.parametrize("case", SSM_SPLIT_CASES, ids=str)
def test_ssm_plain_split_matches_unsplit_and_jax(case):
    B, S, D, N, lanes = case
    args = ssm_inputs(B, S, D, N, seed=lanes)
    got = ssm.ssm_scan_plain(*(_t(a) for a in args), lanes=lanes)
    _close(got, ssm.ssm_scan_plain(*(_t(a) for a in args)), atol=1e-5, rtol=1e-5)
    _close(got, jref.ssm_scan_ref(*(_j(a) for a in args))[0], **SSM_TOL)


GLA_SPLIT_CASES = [(1, 16, 2, 8, 8, 1), (2, 15, 3, 8, 10, 2), (1, 20, 2, 16, 12, 4),
                   (1, 18, 3, 24, 9, 4), (2, 12, 2, 24, 16, 8), (1, 14, 2, 64, 20, 8),
                   (1, 10, 2, 64, 33, 16), (1, 8, 1, 128, 12, 32)]


@pytest.mark.parametrize("case", GLA_SPLIT_CASES, ids=str)
def test_gla_plain_split_matches_unsplit_and_jax(case):
    B, S, H, dk, dv, lanes = case
    args = gla_inputs(B, S, H, dk, dv, seed=lanes)
    got = gla.gla_scan_plain(*(_t(a) for a in args), lanes=lanes)
    _close(got, gla.gla_scan_plain(*(_t(a) for a in args)), atol=1e-5, rtol=1e-4)
    _close(got, jref.gla_scan_ref(*(_j(a) for a in args))[0], **GLA_TOL)


@pytest.mark.parametrize("shape", [(1, 12, 3, 64, 64), (2, 10, 2, 16, 40)], ids=str)
def test_gla_plain_split_at_the_lanes_the_wrapper_picks(shape):
    B, S, H, dk, dv = shape
    args = gla_inputs(B, S, H, dk, dv, seed=5)
    want = jref.gla_scan_ref(*(_j(a) for a in args))[0]
    for chunk in (8, 64, 128):
        lanes = gla.split(B, H, dk, dv, H100_SMS, chunk)["lanes"]
        _close(gla.gla_scan_plain(*(_t(a) for a in args), lanes=lanes), want, **GLA_TOL)


def test_ssm_plain_split_at_the_lanes_the_wrapper_picks():
    args = ssm_inputs(2, 16, 64, 16, seed=6)
    lanes = ssm.split(2, 64, 16, 256, H100_SMS)["lanes"]
    assert lanes == 2
    _close(ssm.ssm_scan_plain(*(_t(a) for a in args), lanes=lanes),
           jref.ssm_scan_ref(*(_j(a) for a in args))[0], **SSM_TOL)


def test_plain_split_keeps_bf16_rounding_once():
    args = gla_inputs(1, 10, 2, 16, 12, seed=2)
    got = gla.gla_scan_plain(*(_t(a).to(torch.bfloat16) for a in args[:4]), _t(args[4]),
                             lanes=4)
    assert got.dtype == torch.bfloat16
    want = gla.gla_scan_plain(*(_t(a).to(torch.bfloat16) for a in args[:4]), _t(args[4]))
    _close(got, want.float().numpy(), atol=2e-2, rtol=2e-2)

