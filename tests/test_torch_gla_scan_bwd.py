"""K5's gradient (``kernels/gla_scan.py::gla_scan_bwd``, csrc/gla_scan_bwd.cu).

On the CPU: ``gla_scan_bwd_plain``, and ``ops.gla_scan(impl="cuda")`` on CPU
tensors through its ``autograd.Function`` (``_GlaScan``), give the gradients
that autograd gives through the chunked oracle (``gla_scan_chunked_ref``):
all five of dr, dk, dv, dw, du; f32 and bf16; a sequence a multiple of the
tile's chunk, not a multiple, and shorter than one; B, H > 1.  Decays near 1
(exp(-exp(-6))) and near 0 are held against a float64 recurrence as well:
near 0 the oracle's dw is (dL/dlog w) / w, whose f32 rounding the division
blows up, so there it is the oracle's w dw that is held.  One f64
``gradcheck``, and one case against the reference package's ``jax.grad``.

Tolerances, as a share of each gradient's largest magnitude: f32 1e-5 (the
plain version sits within ~5e-7 of a float64 answer, as the oracle does);
bf16 1e-2 (a gradient rounded to bf16 carries 2^-9 of its own magnitude).

On the card (``card``; skipped here): the kernels against the plain version
and against the oracle's autograd (its w dw: the decays reach 1e-5) at the
training cell's shape (B=2, S=2048, H=40, dk=dv=64, f32), each gradient
within 2e-5 of its largest magnitude (f32 sums over 2,048 steps whose
states reach ~2,600, as the forward's checks scale theirs); bf16 against
the plain version; two calls bit for bit; a graphed train step of rwkv6-3b
at 8 layers counting 8 ``gla_scan_bwd`` and 8 ``gla_scan`` launches a
replay, and launching no ``gla_kernel`` from its backward.

    python -m pytest -q tests/test_torch_gla_scan_bwd.py -m card   # on the card

(The ``card`` marker is registered in ``pyproject.toml``.)
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import gla_scan as gla
from repro_torch.kernels import ops, ref

CASES = [
    # B, S, H, dk, dv: S against the tile's chunk (bwd_chunk)
    (2, 64, 3, 8, 8),    # a multiple of it (32)
    (2, 45, 2, 8, 12),   # not a multiple
    (3, 5, 2, 16, 8),    # shorter than one (8)
]
NAMES = ("dr", "dk", "dv", "dw", "du")
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
NEAR_1 = -6.0  # w = exp(-exp(x)) with x around this: 0.9975
NEAR_0 = 2.0   # ... around this: ~6e-4, down to ~1e-20


def _inputs(case, seed=0, dtype=torch.float32, decay=-1.0, spread=0.5):
    B, S, H, dk, dv = case
    rng = np.random.default_rng(seed)
    n = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    r, k, v, dy = n(B, S, H, dk), n(B, S, H, dk), n(B, S, H, dv), n(B, S, H, dv)
    w = torch.exp(-torch.exp(n(B, S, H, dk) * spread + decay))
    u = n(H, dk)
    return [t.to(dtype) for t in (r, k, v, w, u)], dy.to(dtype)


def _oracle_grads(args, dy, chunk=16):
    xs = [a.detach().clone().requires_grad_(True) for a in args]
    return torch.autograd.grad(ref.gla_scan_chunked_ref(*xs, chunk=chunk)[0], xs, dy)


def _f64_scan(r, k, v, w, u):
    """The recurrence step by step in float64 (the exact answer)."""
    B, S, H, dk = r.shape
    st = torch.zeros((B, H, dk, v.shape[-1]), dtype=torch.float64, device=r.device)
    ys = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append((r[:, t, :, :, None] * (st + u[:, :, None] * kv)).sum(dim=2))
        st = w[:, t, :, :, None] * st + kv
    return torch.stack(ys, dim=1)


def _f64_grads(args, dy):
    xs = [a.detach().double().requires_grad_(True) for a in args]
    return torch.autograd.grad(_f64_scan(*xs), xs, dy.double())


def _assert_close(got, want, tol, what=""):
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, (what, name)
        scale = float(w.double().abs().max())
        err = float((g.double() - w.double()).abs().max())
        assert err <= tol * scale, f"{what} {name}: {err:.3e} > {tol} x {scale:.3e}"


# -- the plain version and the dispatch, on the CPU ------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_plain_gives_the_oracles_gradients(case, dtype):
    args, dy = _inputs(case, dtype=dtype)
    got = gla.gla_scan_bwd_plain(*args, dy)
    assert [g.dtype for g in got] == [dtype] * 5
    _assert_close(got, _oracle_grads(args, dy), TOL[dtype], str(case))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_cuda_dispatch_on_cpu_tensors_takes_the_plain_gradient(case, dtype):
    args, dy = _inputs(case, seed=1, dtype=dtype)
    xs = [a.clone().requires_grad_(True) for a in args]
    before = gla.gla_scan_bwd.launches
    out = ops.gla_scan(*xs, impl="cuda", chunk=8)
    assert type(out.grad_fn).__name__ == "_GlaScanBackward"
    got = torch.autograd.grad(out, xs, dy)
    assert gla.gla_scan_bwd.launches == before  # CPU tensors launch nothing
    assert gla.gla_scan_bwd.last_chunk == gla.bwd_chunk(case[1], case[3], case[4])
    _assert_close(got, _oracle_grads(args, dy), TOL[dtype], str(case))
    assert all(torch.equal(g, p) for g, p in zip(got, gla.gla_scan_bwd_plain(*args, dy)))


def test_cuda_dispatch_returns_only_the_gradients_asked_for():
    args, dy = _inputs(CASES[1])
    xs = [a.clone().requires_grad_(i in (0, 3)) for i, a in enumerate(args)]
    out = ops.gla_scan(*xs, impl="cuda")
    out.backward(dy)
    assert [x.grad is not None for x in xs] == [True, False, False, True, False]
    _assert_close([xs[0].grad, xs[3].grad], [g for i, g in enumerate(_oracle_grads(args, dy))
                                             if i in (0, 3)], TOL[torch.float32])


@pytest.mark.parametrize("decay", [NEAR_1, NEAR_0, -1.0], ids=["near 1", "near 0", "between"])
@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_decays_near_0_and_1(case, decay):
    """All five against a float64 recurrence; against the oracle too, whose
    dw near 0 is (dL/dlog w) / w with its f32 rounding blown up by 1/w:
    there its w dw (what a decay made as exp(-exp(x)) passes on) is held."""
    args, dy = _inputs(case, seed=2, decay=decay, spread=0.0 if decay == NEAR_1 else 0.5)
    if decay == NEAR_1:
        assert float((args[3] - np.exp(-np.exp(NEAR_1))).abs().max()) < 1e-6
    got = gla.gla_scan_bwd_plain(*args, dy)
    _assert_close(got, _f64_grads(args, dy), TOL[torch.float32], "float64")
    oracle = list(_oracle_grads(args, dy))
    if decay == NEAR_0:
        w = args[3]
        assert float(w.min()) < 1e-12
        got, oracle[3] = list(got), oracle[3] * w
        got[3] = got[3] * w
    _assert_close(got, oracle, TOL[torch.float32], "oracle")


def test_strong_decays_stay_finite():
    """A decay of 1e-6 at every step, and one below the oracle's clamp
    (1e-30): finite, and the float64 answer."""
    args, dy = _inputs(CASES[0], seed=3)
    args[3] = torch.full_like(args[3], 1e-6)
    args[3][:, 7] = 1e-35
    got = gla.gla_scan_bwd_plain(*args, dy)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _assert_close(got, _f64_grads(args, dy), TOL[torch.float32], "float64")


def test_f64_gradcheck():
    """The plain gradient (in float64 for float64 inputs) against finite
    differences of the float64 recurrence, at a tiny shape over two chunks."""

    class Scan(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            ctx.save_for_backward(*args)
            return _f64_scan(*args)

        @staticmethod
        def backward(ctx, g):
            return gla.gla_scan_bwd_plain(*ctx.saved_tensors, g, chunk=4)

    args, _ = _inputs((2, 7, 2, 3, 2), seed=4)
    xs = [a.double().requires_grad_(True) for a in args]
    assert torch.autograd.gradcheck(Scan.apply, xs, eps=1e-6, atol=1e-6, rtol=1e-5)


def test_matches_the_reference_packages_jax_grad():
    import jax
    import jax.numpy as jnp

    from repro.kernels import ops as jops

    args, dy = _inputs(CASES[1], seed=5)
    ja = [jnp.asarray(a.numpy()) for a in args]
    jdy = jnp.asarray(dy.numpy())
    loss = lambda *a: jnp.sum(jops.gla_scan(*a, impl="ref") * jdy)  # noqa: E731
    want = jax.grad(loss, argnums=tuple(range(5)))(*ja)
    got = gla.gla_scan_bwd_plain(*args, dy)
    _assert_close(got, [torch.from_numpy(np.array(g)) for g in want], TOL[torch.float32])


@pytest.mark.parametrize("shape, chunk", [((2048, 64, 64), 16), ((45, 8, 12), 32),
                                          ((5, 16, 8), 8), ((1, 8, 8), 1),
                                          ((2048, 128, 128), 8), ((2048, 128, 64), 16)])
def test_chunk_follows_the_shapes(shape, chunk):
    """Two tiles an SM where that keeps 16 tokens a tile, else one."""
    assert gla.bwd_chunk(*shape) == chunk
    one = gla.bwd_smem_bytes(chunk, *shape[1:]) + gla.SMEM_PER_BLOCK_RESERVED
    assert one <= gla.MAX_SMEM_BYTES
    assert (2 * one <= gla.SMEM_PER_SM) == (shape[1:] not in ((128, 128), (128, 64)))


def test_shapes_are_checked():
    args, dy = _inputs(CASES[0])
    with pytest.raises(ValueError, match="gla_scan_bwd"):
        gla.gla_scan_bwd(*args, dy[:, :-1])


# -- on the card ------------------------------------------------------------------------------

CELL = (2, 2048, 40, 64, 64)  # rwkv6-3b-8l.train-2x2048: B, S, H, dk = dv


@pytest.fixture
def card():
    """The card, decided inside the test (never at import or collection):
    a ``card`` test skips with a reason where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _card_inputs(card, case, dtype=torch.float32, seed=0):
    args, dy = _inputs(case, seed=seed, dtype=dtype, decay=-2.0, spread=1.0)
    return [a.to(card) for a in args], dy.to(card)


@pytest.mark.card
def test_card_kernels_give_the_plain_and_oracle_gradients_at_the_cells_shape(card):
    args, dy = _card_inputs(card, CELL)
    got = gla.gla_scan_bwd(*args, dy)
    torch.cuda.synchronize()
    assert gla.gla_scan_bwd.last_chunk == 16
    _assert_close(got, gla.gla_scan_bwd_plain(*args, dy), 2e-5, "plain")
    oracle = list(_oracle_grads(args, dy, chunk=64))
    assert float(args[3].min()) < 1e-5  # decays near 0: the oracle's w dw is held
    _assert_close([*got[:3], got[3] * args[3], got[4]], [*oracle[:3], oracle[3] * args[3],
                                                         oracle[4]], 2e-5, "oracle")


@pytest.mark.card
@pytest.mark.parametrize("case", CASES + [(1, 100, 3, 128, 128), (2, 70, 2, 64, 40)],
                         ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_card_kernels_give_the_plain_gradients(card, case, dtype):
    args, dy = _card_inputs(card, case, dtype, seed=6)
    got = gla.gla_scan_bwd(*args, dy)
    assert [g.dtype for g in got] == [dtype] * 5
    _assert_close(got, gla.gla_scan_bwd_plain(*args, dy), 2e-5 if dtype == torch.float32
                  else TOL[dtype], str(case))


@pytest.mark.card
def test_card_two_backward_calls_bit_for_bit(card):
    args, dy = _card_inputs(card, CELL, seed=7)
    first = gla.gla_scan_bwd(*args, dy)
    second = gla.gla_scan_bwd(*args, dy)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.card
def test_card_graphed_train_step_launches_the_gradient_kernels(card):
    """rwkv6-3b at 8 layers, f32, 2 x 2048 tokens, compiled: a replay
    counts 8 launches of K5 forward and 8 of its gradient, and the device
    runs ``gla_kernel`` 8 times (the forward's) and each gradient kernel 8
    times: the backward recomputes nothing through K5."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_cli
    from repro_torch.models import build_model
    from repro_torch.models.params import split_params
    from repro_torch.optim import optimizer as O
    from repro_torch.train import train_step as TS

    cfg = dataclasses.replace(get_config("rwkv6-3b"), num_layers=8)
    model = build_model(cfg)
    gen = torch.Generator(device=card)
    gen.manual_seed(0)
    params, _ = split_params(model.init(gen))
    opt_cfg = O.OptimizerConfig(learning_rate=1e-3, warmup_steps=20, total_steps=100)
    state = O.adamw_init(params, opt_cfg)
    step = TS.make_graphed_train_step(model, opt_cfg, train_cli.runtime(True, "none"))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 2049)).astype(np.int32)).to(card)
    batch = {"tokens": tokens[:, :-1].contiguous(), "targets": tokens[:, 1:].contiguous()}
    for _ in range(2):  # eager, capture
        step(params, state, batch)
    fwd, bwd = gla.gla_scan.launches, gla.gla_scan_bwd.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        step(params, state, batch)
        torch.cuda.synchronize()
    assert (gla.gla_scan.launches - fwd, gla.gla_scan_bwd.launches - bwd) == (8, 8)
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    count = lambda part: sum(part in n for n in names)  # noqa: E731
    assert (count("gla_kernel"), count("gla_bwd_states"), count("gla_bwd_chunks"),
            count("gla_bwd_du")) == (8, 8, 8, 8), sorted(set(n for n in names if "gla" in n))
    step.release()
