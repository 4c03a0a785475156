"""RWKV-6 served: the prefill's scan writes the cache's state, with its decay
kept in float32.

On the CPU:

(a) ``ops.gla_scan(..., state=)`` under ``ref``, ``chunked`` and ``cuda``
    (CPU tensors: ``gla_scan_plain``) gives the float64 recurrence's ``y``
    and final state: a sequence a multiple of the chunk and not, B, H > 1.
    Tolerance 2e-6 of each output's largest magnitude: every path sums in
    f32, ~1e-7 relative a step, over at most 45 steps.
(b) A bf16 prefill of the time mix over 256 tokens, decays in
    [0.99, 0.9999], leaves a state within 1e-4 of the largest state value
    of the float64 recurrence over the same r, k, v (bf16, exact in f64)
    and the exact decay of its bias.  f32 sums of 256 terms land within
    ~3e-6; a decay rounded to bf16 (0.9975 becomes 0.9961, 0.9999 becomes
    1.0) misses by ~0.18.
(c) The served path, ``make_prefill_step`` then ``make_decode_step``, on
    left-padded prompts, against the plain reference's full forward
    (``portbench/reference/rwkv6.py``) at every served position, the
    reference handed the served tokens, as a share of the largest
    |logit|.  f32: 1e-4 (the CPU oracles and the reference sum in other
    orders: ~1e-6); bf16: 0.1 (two layers of bf16 products and activations
    against f32 ones, ~2^-8 relative each: ~0.025).

On the card (``card``; skipped here): ``gla_scan_state`` (the
``gla_state_kernel``) against ``gla_scan_plain(..., final_state=True)``
for f32 and bf16 operands beside an f32 decay, S a multiple of the
staging depth and not; two calls bit for bit; ``gla_scan`` on the same
inputs gives the same ``y``; and the compiled served prefill of rwkv6-3b
at 4 layers launches one ``gla_state_kernel`` a layer a wave, counts it in
``gla_scan_state.launches`` and calls no chunked oracle.

    python -m pytest -q tests/test_torch_rwkv_served.py -m card   # on the card
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import gla_scan as gla
from repro_torch.kernels import ops, ref

CASES = [
    # B, S, H, dk, dv, chunk
    (2, 32, 3, 8, 12, 16),  # S a multiple of the chunk
    (2, 45, 2, 16, 8, 16),  # not a multiple
]


def _inputs(case, seed=0, dtype=torch.float32, decay=-1.0, spread=0.5):
    """r, k, v in ``dtype``; w = exp(-exp(N(decay, spread))) and u in f32."""
    B, S, H, dk, dv = case[:5]
    rng = np.random.default_rng(seed)
    n = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    r, k, v = n(B, S, H, dk).to(dtype), n(B, S, H, dk).to(dtype), n(B, S, H, dv).to(dtype)
    w = torch.exp(-torch.exp(n(B, S, H, dk) * spread + decay))
    return r, k, v, w, n(H, dk)


def _f64_scan(r, k, v, w, u):
    """``(y, final state)`` of the recurrence step by step in float64."""
    r, k, v, w, u = (t.double() for t in (r, k, v, w, u))
    B, S, H, dk = r.shape
    st = torch.zeros((B, H, dk, v.shape[-1]), dtype=torch.float64, device=r.device)
    ys = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append((r[:, t, :, :, None] * (st + u[:, :, None] * kv)).sum(dim=2))
        st = w[:, t, :, :, None] * st + kv
    return torch.stack(ys, dim=1), st


def _share(got, want) -> float:
    """The largest distance over the largest magnitude of ``want``."""
    want = want.double()
    return float((got.double() - want).abs().max() / want.abs().max())


# -- (a) the dispatch with a final state ------------------------------------------------------


@pytest.mark.parametrize("impl", ["ref", "chunked", "cuda"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_gla_scan_writes_the_recurrences_final_state(impl, case):
    args = _inputs(case, seed=1)
    B, S, H, dk, dv, chunk = case
    state = torch.full((B, H, dk, dv), float("nan"))
    y = ops.gla_scan(*args, impl=impl, chunk=chunk, state=state)
    want_y, want_s = _f64_scan(*args)
    assert y.dtype == torch.float32 and state.dtype == torch.float32
    assert _share(y, want_y) <= 2e-6
    assert _share(state, want_s) <= 2e-6
    # without a state the same call gives the same y
    assert torch.equal(ops.gla_scan(*args, impl=impl, chunk=chunk), y)


def test_plain_final_state_is_the_recurrences():
    args = _inputs((2, 21, 3, 8, 8), seed=2, dtype=torch.bfloat16)
    y, st = gla.gla_scan_plain(*args, final_state=True)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    assert torch.equal(y, gla.gla_scan_plain(*args))
    assert _share(st, _f64_scan(*args)[1]) <= 2e-6


@pytest.mark.parametrize("B,H,sms,asked,want", [
    (64, 40, 132, 128, 16),  # rwkv6-3b.serve-chat's prefill: 5 waves at 16, 39 at 128
    (2, 40, 132, 128, 64),   # one wave at 64, two at 128
    (1, 40, 132, 128, 128),  # one wave at the request
    (64, 40, 132, 8, 8),     # never deeper than the request
])
def test_state_chunk_takes_the_fewest_waves(B, H, sms, asked, want):
    assert gla.state_chunk(B, H, 64, 64, sms, asked) == want


def test_the_state_buffer_is_checked():
    args = _inputs((1, 5, 2, 8, 8), seed=3)
    with pytest.raises(ValueError, match="state"):
        gla.gla_scan_state(*args, torch.zeros(1, 2, 8, 8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="state"):
        gla.gla_scan_state(*args, torch.zeros(1, 2, 8, 4))


# -- (b) the decay stays f32 through a bf16 prefill -------------------------------------------


def _time_mix(seed=0):
    """One time mix of width 64 in heads of 16, its decay bias drawn so that
    the decays lie in [0.99, 0.9999] (w = exp(-exp(bias)); the decay LoRA's
    second matrix zero, so the bias is the whole exponent)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models.params import split_params

    cfg = get_config("rwkv6-3b").reduced()
    cfg = dataclasses.replace(cfg, d_model=64, rwkv=dataclasses.replace(cfg.rwkv, head_size=16))
    p, _ = split_params(L.init_rwkv_tmix(torch.Generator().manual_seed(seed), cfg))
    lo, hi = np.log(-np.log(0.9999)), np.log(-np.log(0.99))
    bias = torch.from_numpy(np.random.default_rng(seed).uniform(lo, hi, cfg.d_model))
    p["w_bias"] = bias.float().to(torch.bfloat16).float()  # what a bf16 step reads
    p["w_lora2"] = torch.zeros_like(p["w_lora2"])
    return cfg, p


@pytest.mark.parametrize("impl", ["ref", "chunked", "cuda"])
def test_bf16_prefill_keeps_the_decay(impl, monkeypatch):
    from repro_torch.models import layers as L
    from repro_torch.models.runtime import Runtime

    cfg, p = _time_mix()
    p = {k: (v.to(torch.bfloat16) if isinstance(v, torch.Tensor) else
             {kk: vv.to(torch.bfloat16) for kk, vv in v.items()}) for k, v in p.items()}
    B, S, H, hs = 2, 256, cfg.d_model // cfg.rwkv.head_size, cfg.rwkv.head_size
    seen = {}
    scan = ops.gla_scan

    def keep(r, k, v, w, u, **kw):
        seen.update(r=r, k=k, v=v, u=u)
        return scan(r, k, v, w, u, **kw)

    monkeypatch.setattr(ops, "gla_scan", keep)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((B, S, cfg.d_model))
                         .astype(np.float32)).to(torch.bfloat16)
    cache = L.init_rwkv_cache(cfg, B)
    cache = {k: v.value if hasattr(v, "value") else v for k, v in cache.items()}
    rt = Runtime(compute_dtype="bf16", scan_impl=impl, scan_chunk=32)
    L.rwkv_tmix_apply(p, x, cfg=cfg, rt=rt, mode="prefill", cache=cache)
    assert seen["r"].dtype == torch.bfloat16 and cache["S"].dtype == torch.float32
    decay = torch.exp(-torch.exp(p["w_bias"].double())).reshape(H, hs)
    w64 = decay.expand(B, S, H, hs)
    want = _f64_scan(seen["r"], seen["k"], seen["v"], w64, seen["u"])[1]
    assert float(decay.min()) >= 0.99 - 1e-4 and float(decay.max()) <= 0.9999 + 1e-6
    assert _share(cache["S"], want) <= 1e-4


# -- (c) the served path against the plain reference ------------------------------------------

TINY = {"name": "r", "family": "ssm", "num_layers": 2, "d_model": 64, "num_heads": 4,
        "num_kv_heads": 4, "d_ff": 128, "vocab_size": 256, "head_dim": 16,
        "rwkv": {"head_size": 16, "decay_lora": 8, "mix_lora": 8}}
PROMPTS, PAD, GEN = (5, 12, 9), 12, 5


@pytest.mark.parametrize("impl", ["chunked", "cuda"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_served_path_matches_the_reference(dtype, impl):
    from portbench import spec, weights
    from portbench.reference import rwkv6
    from repro_torch.models.model import build_model
    from repro_torch.models.params import split_params
    from repro_torch.models.runtime import Runtime
    from repro_torch.serve.serve_step import greedy_sample, make_decode_step, make_prefill_step

    model = build_model(spec.model_config({"port": TINY}))
    rt = Runtime(compute_dtype=dtype, attn_impl="ref", scan_impl=impl, scan_chunk=4)
    w = weights.make({"port": TINY}, 11, {"f32": torch.float32, "bf16": torch.bfloat16}[dtype],
                     "cpu")
    rng = np.random.default_rng(5)
    toks = torch.zeros((len(PROMPTS), PAD), dtype=torch.int64)  # left-padded with 0
    for i, n in enumerate(PROMPTS):
        toks[i, PAD - n:] = torch.from_numpy(rng.integers(1, TINY["vocab_size"], n))
    cache = split_params(model.init_cache(len(PROMPTS), PAD + GEN))[0]
    logits, cache = make_prefill_step(model, rt)(w, {"tokens": toks.int()}, cache)
    outs, seq = [logits[:, -1]], [greedy_sample(logits)]
    decode = make_decode_step(model, rt)
    for _ in range(GEN - 1):
        logits, cache = decode(w, seq[-1], cache)
        outs.append(logits[:, -1])
        seq.append(greedy_sample(logits))
    full = torch.cat([toks] + [s.long() for s in seq[:-1]], dim=1)
    want = rwkv6.logits(w, TINY, full, at=torch.arange(PAD - 1, PAD + GEN - 1))
    got = torch.stack(outs, 1).float()
    assert _share(got, want) <= (1e-4 if dtype == "f32" else 0.1)


def test_the_reference_keeps_no_keys_or_values():
    from portbench import weights
    from portbench.reference import rwkv6

    w = weights.make({"port": TINY}, 1, torch.float32, "cpu")
    with pytest.raises(ValueError, match="keep"):
        rwkv6.logits(w, TINY, torch.ones((1, 4), dtype=torch.int64), keep=lambda *a: None)


# -- (d) on the card --------------------------------------------------------------------------


@pytest.fixture
def card():
    """The card, decided inside the test (never at import or collection):
    a ``card`` test skips with a reason where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


CARD_CASES = [
    # B, S, H, dk, dv, chunk: S a multiple of the staging depth, and not
    (2, 256, 5, 64, 64, 64),
    (3, 301, 4, 64, 64, 64),
    (2, 77, 3, 32, 40, 16),
    (1, 50, 2, 128, 64, 32),
    (1, 33, 2, 20, 24, 16),  # bf16 rows of 40 bytes: staged by plain loads
]


@pytest.mark.card
@pytest.mark.parametrize("case", CARD_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_card_state_kernel_gives_the_plain_y_and_state(card, case, dtype):
    B, S, H, dk, dv, chunk = case
    args = [a.to(card) for a in _inputs(case, seed=8, dtype=dtype, decay=-3.0, spread=1.0)]
    assert args[3].dtype == torch.float32
    state = torch.full((B, H, dk, dv), float("nan"), device=card)
    before = gla.gla_scan_state.launches
    y = gla.gla_scan_state(*args, state, chunk=chunk)
    assert gla.gla_scan_state.launches == before + 1
    want_y, want_s = gla.gla_scan_plain(*args, final_state=True)
    assert y.dtype == dtype
    assert _share(y, want_y) <= (2e-5 if dtype == torch.float32 else 1e-2)
    assert _share(state, want_s) <= 2e-5
    again = torch.empty_like(state)
    assert torch.equal(gla.gla_scan_state(*args, again, chunk=chunk), y)
    assert torch.equal(again, state)
    # the launch without a state at the same staging depth (gla_scan:
    # gla_kernel for f32 operands, the state kernel storing nothing for bf16
    # ones) computes the same y
    assert gla.gla_scan_state.last_config["chunk"] <= chunk
    assert torch.equal(gla.gla_scan(*args, chunk=gla.gla_scan_state.last_config["chunk"]), y)


@pytest.mark.card
def test_card_compiled_prefill_writes_the_state_with_k5(card, monkeypatch):
    """rwkv6-3b at 4 layers and full width, bf16, 4 prompts left-padded to
    512: the compiled prefill's replay launches ``gla_state_kernel`` 4 times
    (and no ``gla_kernel``), counts 4 ``gla_scan_state`` launches, calls no
    chunked oracle, and leaves the state the oracle path leaves (eager,
    ``scan_impl="chunked"``, the same f32 decay) within 1e-3 of its largest
    value."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch
    from repro_torch.models import build_model
    from repro_torch.models.params import split_params
    from repro_torch.serve import serve_step as SS

    cfg = dataclasses.replace(get_config("rwkv6-3b"), num_layers=4)
    model = build_model(cfg)
    gen = torch.Generator(device=card)
    gen.manual_seed(0)
    params = split_params(model.init(gen, dtype=torch.bfloat16))[0]
    rng = np.random.default_rng(0)
    tokens = torch.zeros((4, 512), dtype=torch.int32)
    for i, n in enumerate((512, 300, 77, 401)):
        tokens[i, 512 - n:] = torch.from_numpy(rng.integers(1, cfg.vocab_size, n))
    batch = {"tokens": tokens.to(card)}

    oracle = launch.runtime(True, "bf16")
    oracle = dataclasses.replace(oracle, scan_impl="chunked")
    cache = split_params(model.init_cache(4, 520, device=card))[0]
    _, cache = SS.make_prefill_step(model, oracle)(params, batch, cache)
    want = cache["layers"]["pos0"]["mixer"]["S"].clone()

    def no_oracle(*a, **kw):
        raise AssertionError("the served prefill called the chunked oracle")

    monkeypatch.setattr(ref, "gla_scan_chunked_ref", no_oracle)
    step = SS.make_graphed_prefill_step(model, launch.runtime(True, "bf16"))
    cache = split_params(model.init_cache(4, 520, device=card))[0]
    for _ in range(2):  # eager, capture
        SS.reset_cache(cache)
        _, cache = step(params, batch, cache)
    before = gla.gla_scan_state.launches
    SS.reset_cache(cache)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, cache = step(params, batch, cache)
        torch.cuda.synchronize()
    assert gla.gla_scan_state.launches - before == 4
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert (sum("gla_state_kernel" in n for n in names), sum("gla_kernel" in n for n in names)) \
        == (4, 0), sorted(set(n for n in names if "gla" in n))
    assert _share(cache["layers"]["pos0"]["mixer"]["S"], want) <= 1e-3
    step.release()
