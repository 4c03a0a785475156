"""The scan kernels' modules of the port (``ssm_scan``, ``gla_scan``) and their
oracles against the reference package on the CPU: the same numpy inputs go
through the JAX functions (oracles, and the Pallas kernels in interpret mode
on the smallest sweep row) and through the port's oracles, the kernels'
plain versions and the ``impl="cuda"`` dispatch (which takes the plain
version for a CPU tensor).

Tolerances are the reference tests' own (tests/test_kernels_scans.py):
ssm atol = rtol = 2e-4; gla atol 2e-4, rtol 2e-3; bf16 2e-2 (compared in
float32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import gla_scan as gla_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssm_scan as ssm_mod

SSM_SWEEP = [
    # B, S, D, N, chunk, block_d
    (1, 16, 8, 4, 8, 8),
    (2, 50, 12, 8, 16, 8),
    (1, 33, 24, 16, 8, 16),
    (2, 64, 16, 4, 32, 4),
]
GLA_SWEEP = [
    # B, S, H, dk, dv, chunk
    (1, 16, 2, 8, 8, 8),
    (2, 45, 3, 8, 8, 16),
    (1, 40, 4, 16, 16, 8),
]
SSM_TOL = dict(atol=2e-4, rtol=2e-4)
GLA_TOL = dict(atol=2e-4, rtol=2e-3)


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def ssm_inputs(case, seed=0):
    B, S, D, N = case[:4]
    rng = np.random.default_rng(seed)
    x = _np(rng, B, S, D)
    dt = np.abs(_np(rng, B, S, D)) * 0.1
    A = -np.abs(_np(rng, D, N))
    return x, dt, A, _np(rng, B, S, N), _np(rng, B, S, N), _np(rng, D)


def gla_inputs(case, seed=0):
    B, S, H, dk, dv = case[:5]
    rng = np.random.default_rng(seed)
    r, k, v = _np(rng, B, S, H, dk), _np(rng, B, S, H, dk), _np(rng, B, S, H, dv)
    w = np.exp(-np.exp(_np(rng, B, S, H, dk) * 0.5 - 1.0)).astype(np.float32)
    return r, k, v, w, _np(rng, H, dk)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32), dtype)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# oracles: (y, final state), with an initial state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", SSM_SWEEP, ids=[str(c) for c in SSM_SWEEP])
def test_ssm_oracles_match_jax(case):
    args = ssm_inputs(case)
    h0 = _np(np.random.default_rng(9), case[0], case[2], case[3])
    y, h = ref.ssm_scan_ref(*(_t(a) for a in args), _t(h0))
    yj, hj = jref.ssm_scan_ref(*(_j(a) for a in args), _j(h0))
    _close(y, yj, **SSM_TOL)
    _close(h, hj, **SSM_TOL)
    y, h = ref.ssm_scan_chunked_ref(*(_t(a) for a in args), _t(h0), chunk=case[4])
    yj, hj = jref.ssm_scan_chunked_ref(*(_j(a) for a in args), _j(h0), chunk=case[4])
    _close(y, yj, **SSM_TOL)
    _close(h, hj, **SSM_TOL)


@pytest.mark.parametrize("case", GLA_SWEEP, ids=[str(c) for c in GLA_SWEEP])
def test_gla_oracles_match_jax(case):
    args = gla_inputs(case)
    h0 = _np(np.random.default_rng(9), case[0], case[2], case[3], case[4])
    y, h = ref.gla_scan_ref(*(_t(a) for a in args), _t(h0))
    yj, hj = jref.gla_scan_ref(*(_j(a) for a in args), _j(h0))
    _close(y, yj, **GLA_TOL)
    _close(h, hj, **GLA_TOL)
    y, h = ref.gla_scan_chunked_ref(*(_t(a) for a in args), _t(h0), chunk=case[5])
    yj, hj = jref.gla_scan_chunked_ref(*(_j(a) for a in args), _j(h0), chunk=case[5])
    _close(y, yj, **GLA_TOL)
    _close(h, hj, **GLA_TOL)


def test_ssm_state_continuity():
    """Running the scan in two halves, the second from the first's final
    state, equals one run — for the naive and the chunked oracle."""
    x, dt, A, Bi, Ci, Dv = (_t(a) for a in ssm_inputs((1, 32, 8, 4)))
    y_full, h_full = ref.ssm_scan_ref(x, dt, A, Bi, Ci, Dv)
    for fn in (ref.ssm_scan_ref, lambda *a: ref.ssm_scan_chunked_ref(*a, chunk=8)):
        _, h1 = fn(x[:, :16], dt[:, :16], A, Bi[:, :16], Ci[:, :16], Dv)
        y2, h2 = fn(x[:, 16:], dt[:, 16:], A, Bi[:, 16:], Ci[:, 16:], Dv, h1)
        _close(h2, h_full.numpy(), atol=1e-5, rtol=1e-5)
        _close(y2, y_full[:, 16:].numpy(), atol=1e-5, rtol=1e-5)


def test_gla_state_continuity():
    r, k, v, w, u = (_t(a) for a in gla_inputs((1, 30, 2, 8, 8)))
    y_full, s_full = ref.gla_scan_ref(r, k, v, w, u)
    for fn in (ref.gla_scan_ref, lambda *a: ref.gla_scan_chunked_ref(*a, chunk=8)):
        _, s1 = fn(r[:, :13], k[:, :13], v[:, :13], w[:, :13], u)
        y2, s2 = fn(r[:, 13:], k[:, 13:], v[:, 13:], w[:, 13:], u, s1)
        _close(s2, s_full.numpy(), atol=1e-5, rtol=1e-4)
        _close(y2, y_full[:, 13:].numpy(), atol=1e-5, rtol=1e-4)


def test_gla_strong_decay_stays_finite():
    """Near-total forgetting per step: the chunked form (masked
    diff-then-exp) and the kernel path stay finite."""
    r, k, v, _, u = gla_inputs((1, 64, 2, 8, 8))
    w = np.full(r.shape, 1e-6, np.float32)
    want = jops.gla_scan(*(_j(a) for a in (r, k, v, w, u)), impl="ref")
    for impl in ("chunked", "cuda", "ref"):
        y = ops.gla_scan(*(_t(a) for a in (r, k, v, w, u)), impl=impl, chunk=32)
        assert bool(torch.isfinite(y).all()), impl
        _close(y, want, **GLA_TOL)


# ---------------------------------------------------------------------------
# ops dispatch (on CPU tensors impl="cuda" takes the plain version)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["ref", "chunked", "cuda"])
@pytest.mark.parametrize("case", SSM_SWEEP, ids=[str(c) for c in SSM_SWEEP])
def test_ops_ssm_scan_matches_jax(case, impl):
    args = ssm_inputs(case)
    kw = dict(chunk=case[4], block_d=case[5])
    jimpls = ("ref", "pallas") if case == SSM_SWEEP[0] else ("ref",)
    before = ssm_mod.ssm_scan.launches
    got = ops.ssm_scan(*(_t(a) for a in args), impl=impl, **kw)
    assert got.shape == args[0].shape and got.dtype == torch.float32
    for jimpl in jimpls:
        _close(got, jops.ssm_scan(*(_j(a) for a in args), impl=jimpl, **kw), **SSM_TOL)
    assert ssm_mod.ssm_scan.launches == before  # CPU tensors launch nothing
    if impl == "cuda":
        assert ssm_mod.ssm_scan.last_config == ssm_mod.effective_config(
            case[4], case[5], case[1], case[2], case[3])


@pytest.mark.parametrize("impl", ["ref", "chunked", "cuda"])
@pytest.mark.parametrize("case", GLA_SWEEP, ids=[str(c) for c in GLA_SWEEP])
def test_ops_gla_scan_matches_jax(case, impl):
    args = gla_inputs(case)
    jimpls = ("ref", "pallas") if case == GLA_SWEEP[0] else ("ref",)
    before = gla_mod.gla_scan.launches
    got = ops.gla_scan(*(_t(a) for a in args), impl=impl, chunk=case[5])
    assert got.shape == args[2].shape
    for jimpl in jimpls:
        _close(got, jops.gla_scan(*(_j(a) for a in args), impl=jimpl, chunk=case[5]),
               **GLA_TOL)
    assert gla_mod.gla_scan.launches == before
    if impl == "cuda":
        assert gla_mod.gla_scan.last_config == {"chunk": case[5]}


def test_plain_versions_match_jax_naive_scans():
    for case in SSM_SWEEP:
        args = ssm_inputs(case, seed=3)
        _close(ssm_mod.ssm_scan_plain(*(_t(a) for a in args)),
               jref.ssm_scan_ref(*(_j(a) for a in args))[0], **SSM_TOL)
    for case in GLA_SWEEP:
        args = gla_inputs(case, seed=3)
        _close(gla_mod.gla_scan_plain(*(_t(a) for a in args)),
               jref.gla_scan_ref(*(_j(a) for a in args))[0], **GLA_TOL)


def test_bf16_scans_match_jax():
    """bf16 in, bf16 out, fp32 state: the kernel path and the oracles against
    the reference's oracle run on the same bf16 inputs."""
    sargs = ssm_inputs(SSM_SWEEP[1])
    want = np.asarray(jops.ssm_scan(*(_j(a, jnp.bfloat16) for a in sargs), impl="ref"),
                      np.float32)
    for impl in ("ref", "chunked", "cuda"):
        got = ops.ssm_scan(*(_t(a, torch.bfloat16) for a in sargs), impl=impl, chunk=16)
        assert got.dtype == torch.bfloat16
        _close(got, want, atol=2e-2, rtol=2e-2)
    gargs = gla_inputs(GLA_SWEEP[1])
    want = np.asarray(jops.gla_scan(*(_j(a, jnp.bfloat16) for a in gargs), impl="ref"),
                      np.float32)
    for impl in ("ref", "chunked", "cuda"):
        got = ops.gla_scan(*(_t(a, torch.bfloat16) for a in gargs), impl=impl, chunk=16)
        assert got.dtype == torch.bfloat16
        _close(got, want, atol=2e-2, rtol=2e-2)


def test_ssm_grads_through_the_autograd_pairing_match_jax():
    """Kernel forward, chunked-oracle backward (same chunk) vs jax.grad
    through the reference's chunked oracle."""
    args = ssm_inputs(SSM_SWEEP[1])
    wgt = _np(np.random.default_rng(7), *args[0].shape)
    g_ref = jax.grad(lambda *a: (jops.ssm_scan(*a, impl="chunked", chunk=16) * wgt).sum(),
                     tuple(range(6)))(*(_j(a) for a in args))
    ts = [_t(a).requires_grad_() for a in args]
    (ops.ssm_scan(*ts, impl="cuda", chunk=16) * _t(wgt)).sum().backward()
    for got, want in zip(ts, g_ref):
        _close(got.grad, want, **SSM_TOL)


def test_gla_grads_through_the_autograd_pairing_match_jax():
    args = gla_inputs(GLA_SWEEP[1])
    wgt = _np(np.random.default_rng(7), *args[2].shape)
    g_ref = jax.grad(lambda *a: (jops.gla_scan(*a, impl="chunked", chunk=16) * wgt).sum(),
                     tuple(range(5)))(*(_j(a) for a in args))
    ts = [_t(a).requires_grad_() for a in args]
    (ops.gla_scan(*ts, impl="cuda", chunk=16) * _t(wgt)).sum().backward()
    for got, want in zip(ts, g_ref):
        _close(got.grad, want, **GLA_TOL)


# ---------------------------------------------------------------------------
# knobs, feasibility, refusals
# ---------------------------------------------------------------------------


def test_scan_knobs_are_clamped_and_checked():
    # Jamba's mixer: N=16 -> 8 states a lane, 2 lanes a channel; any block_d
    # launches (a group is split over blocks of <= 512 threads); B/C staging
    # double-buffered in 227 KB
    assert ssm_mod.lanes_for(16) == 2 and ssm_mod.lanes_for(8) == 1
    assert ssm_mod.feasible({"chunk": 128, "block_d": 256}, {"N": 16})
    assert ssm_mod.feasible({"chunk": 128, "block_d": 1024}, {"N": 16})
    assert not ssm_mod.feasible({"chunk": 2048, "block_d": 256}, {"N": 16})  # 512 KB
    assert not ssm_mod.feasible({"chunk": 8, "block_d": 8}, {"N": 65})
    assert ssm_mod.effective_config(2048, 8192, 2048, 8192, 16) == \
        {"chunk": 512, "block_d": 8192}
    assert ssm_mod.effective_config(128, 256, 50, 12, 8) == {"chunk": 64, "block_d": 16}
    # RWKV-6: dk=dv=64 -> chunk <= 128 of r/k/w/v staged, double-buffered
    assert gla_mod.feasible({"chunk": 128}, {"dk": 64, "dv": 64})
    assert not gla_mod.feasible({"chunk": 256}, {"dk": 64, "dv": 64})
    assert not gla_mod.feasible({"chunk": 8}, {"dk": 256, "dv": 64})
    assert gla_mod.block_cols(2, 40, 64, 64, 132, 64) == 32
    assert gla_mod.block_cols(1, 2, 64, 600, 132, 64) == 8
    assert gla_mod.effective_config(2048, 2048, 64, 64) == {"chunk": 128}
    assert gla_mod.effective_config(64, 45, 8, 8) == {"chunk": 64}


def test_scan_wrappers_refuse_what_they_do_not_take():
    x, dt, A, Bi, Ci, Dv = (_t(a) for a in ssm_inputs(SSM_SWEEP[0]))
    with pytest.raises(ValueError):
        ssm_mod.ssm_scan(x, dt, A[:4], Bi, Ci, Dv)               # A rows != D
    with pytest.raises(ValueError):
        ssm_mod.ssm_scan(x, dt, A, Bi[:, :3], Ci, Dv)            # B steps != S
    with pytest.raises(ValueError):
        ssm_mod.ssm_scan(x, dt, A, Bi, Ci, Dv, chunk=0)
    r, k, v, w, u = (_t(a) for a in gla_inputs(GLA_SWEEP[0]))
    with pytest.raises(ValueError):
        gla_mod.gla_scan(r, k, v, w, u[:1])                      # u heads != H
    with pytest.raises(ValueError):
        gla_mod.gla_scan(r, k[:, :3], v, w, u)
    with pytest.raises(ValueError):
        gla_mod.gla_scan(r, k, v, w, u, chunk=2.0)
    # a tensor on the meta device is neither CPU nor CUDA: no silent fallback
    with pytest.raises(RuntimeError, match="device"):
        ssm_mod.ssm_scan(*(a.to("meta") for a in (x, dt, A, Bi, Ci, Dv)))
    with pytest.raises(RuntimeError, match="device"):
        gla_mod.gla_scan(*(a.to("meta") for a in (r, k, v, w, u)))
