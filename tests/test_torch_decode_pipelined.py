"""K3's tensor-core path (``decode_kernel_mma``, ``decode_attention_bf16``).

On the CPU:

* which kernel takes a call (``route``) for every (query, cache) type pair,
  head width and group, and what the tensor-core path refuses;
* its ``feasible`` and clamp: the ring's stages, a request made for the
  other kernel clamped, never refused;
* its work partition (``mma_split_count``, ``split_rows`` and the warps'
  stages): every live row of every sequence in exactly one warp's stage of
  one split, for lengths 0, 1, ragged and ``Smax``; the partials under 2 %
  of the cache's bytes; at the decode_32k shape no SM streams more than
  1.05 times the mean rows;
* its arithmetic (``decode_attention_bf16_plain``: the splits, the stages,
  P as bf16 hi + lo) against ``decode_attention_plain`` in float64: P split
  in two keeps the result at f32 accuracy, P rounded once to bf16 does not.

On the card (``card``; skipped here): the kernel against
``decode_attention_plain`` at the decode_32k shape and at prefill_8k's
ragged lengths, within the bf16 tolerance of ``chip_smoke.py`` and
``PLAIN_ULPS`` bf16 ulps of the largest |value|, and against its emulation
within ``EMU_ULPS`` bf16 ulps of each output; nearer the emulation with P
as hi + lo than the one with P rounded once; lengths 0 and 1 and a ring
buffer; two calls bit for bit; a CUDA-graph capture and three replays with
the merge counters back to 0; 24 launches a replay of the compiled
qwen2-0.5b decode step.

    python -m pytest -q tests/test_torch_decode_pipelined.py -m card   # on the card

(The ``card`` marker is registered in ``pyproject.toml``.)
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as dec

H100_SMS = 132
BF16_TOL = 2e-2  # chip_smoke.py's bf16 tolerance for K3: |got - want| <= tol (1 + |want|)
PLAIN_ULPS = 8   # chip_smoke.py's ROOFLINE_ULPS: bf16 ulps of the plain output's largest |value|
# the kernel against its emulation: bf16 ulps of each output, an output taken
# at no less than EMU_FLOOR of the largest |value| (the two sum in f32 in
# different orders, which moves the smallest outputs by more than their ulp)
EMU_ULPS = 2
EMU_FLOOR = 2.0 ** -6


def _rand(seed, *shape, dtype=torch.float32, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(dtype).to(device)


# ---------------------------------------------------------------------------
# which kernel takes a call
# ---------------------------------------------------------------------------

PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
         (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("pair", PAIRS, ids=["f32", "bf16", "f32_q_bf16_cache"])
@pytest.mark.parametrize("dh", [16, 24, 48, 64, 128, 144])
@pytest.mark.parametrize("group", [1, 7, 8, 12, 16, 17])
def test_route(pair, dh, group):
    qdt, kdt = pair
    want = ("mma" if qdt == kdt == torch.bfloat16 and dh % 16 == 0 and dh <= 128
            and group <= 16 else "fma")
    assert dec.route(qdt, dh, group) == want
    K, B, Smax = 2, 1, 8
    q = _rand(0, B, group * K, dh, dtype=qdt)
    k, v = _rand(1, B, Smax, K, dh, dtype=kdt), _rand(2, B, Smax, K, dh, dtype=kdt)
    lengths = torch.tensor([5])
    if want == "mma":
        out = dec.decode_attention_bf16(q, k, v, lengths)
        assert out.dtype == torch.bfloat16
        assert torch.equal(out, dec.decode_attention(q, k, v, lengths))
    else:
        with pytest.raises(ValueError, match="decode_attention_bf16"):
            dec.decode_attention_bf16(q, k, v, lengths)
    # the f32 query never takes the tensor cores: no rounding of the query
    assert dec.route(torch.float32, dh, group) == dec.route(None, dh, group) == "fma"


# ---------------------------------------------------------------------------
# feasible and the clamp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dh,fits", [(16, [16, 32, 64]), (32, [16, 32, 64]), (48, [16, 32]),
                                     (64, [16, 32]), (128, [16])])
def test_feasible_stages(dh, fits):
    shapes = {"H": 14, "K": 2, "dh": dh}
    got = [b for b in (4, 8, 16, 24, 32, 64, 128) if dec.feasible({"block_kv": b}, shapes,
                                                                  torch.bfloat16)]
    assert got == fits
    for b in fits:
        assert dec.mma_smem_bytes(b, dh) <= dec.MAX_SMEM_BYTES
    # the f32 kernel's rule is unchanged by the dtype argument's default
    assert dec.feasible({"block_kv": 64}, shapes) and not dec.feasible({"block_kv": 128}, shapes)


@pytest.mark.parametrize("request_,dh,want", [
    (512, 64, 32),   # the runtime's default: the largest ring that fits
    (64, 64, 32),    # the f32 kernel's clamp of 512 (a TuningDB record made for it)
    (16, 64, 16),
    (4, 64, 16),     # below the smallest stage: raised to it
    (1, 64, 16),
    (512, 128, 16),
    (512, 32, 64),
    (24, 16, 16),
])
def test_clamp_takes_any_request(request_, dh, want):
    assert dec.effective_config(request_, 14, 2, dh, torch.bfloat16) == {"block_kv": want}
    assert dec.effective_config(request_, 14, 2, dh)["block_kv"] == \
        dec.effective_config(request_, 14, 2, dh, torch.float32)["block_kv"]


def test_cpu_bf16_call_records_the_tensor_core_tiles():
    q = _rand(0, 2, 14, 64, dtype=torch.bfloat16)
    k, v = (_rand(s, 2, 40, 2, 64, dtype=torch.bfloat16) for s in (1, 2))
    dec.decode_attention(q, k, v, torch.tensor([40, 3]))
    assert dec.decode_attention.last_config == {"block_kv": 32}
    assert dec.decode_attention.last_splits == 1
    dec.decode_attention_bf16(q, k, v, torch.tensor([40, 3]), block_kv=8)
    assert dec.decode_attention_bf16.last_config == {"block_kv": 16}


# ---------------------------------------------------------------------------
# the work partition
# ---------------------------------------------------------------------------

def _ragged(B, Smax, seed=0):
    return np.random.default_rng(seed).integers(0, Smax + 1, B).tolist()


PARTITIONS = {
    # B, K, Smax, G, dh, block_kv, lengths
    "decode_32k": (128, 2, 32768, 7, 64, 32,
                   np.random.default_rng(1).integers(31745, 31873, 128).tolist()),
    "decode_32k_stage16": (128, 2, 32768, 7, 64, 16, [32768] * 128),
    "prefill_8k": (8, 2, 8208, 7, 64, 32, [1024, 8192, 3000, 1500, 6000, 4096, 2048, 7777]),
    "lengths_0_1": (6, 2, 2048, 7, 64, 32, [0, 1, 2048, 0, 1, 2047]),
    "ragged_mqa": (5, 1, 3000, 16, 128, 16, _ragged(5, 3000)),
    "ragged_k4": (3, 4, 1500, 3, 32, 64, _ragged(3, 1500, 2)),
    "served": (8, 2, 576, 7, 64, 32, [575] * 8),
    "one_sequence": (1, 2, 32768, 7, 64, 32, [20000]),
}


def _stages(length, n, wph, bkv):
    """The kernel's walk: for each (split, warp) the rows of each of its
    stages (split s takes ``split_rows``' rows of it, the head's ``wph``
    warps its stages of ``bkv`` rows in turn)."""
    r = int(dec.split_rows(torch.tensor([length]), n)[0])
    out = {}
    for s in range(n):
        rb, re = min(s * r, length), min(s * r + r, length)
        for w in range(wph):
            out[(s, w)] = [list(range(r0, min(r0 + bkv, re)))
                           for r0 in range(rb + w * bkv, re, wph * bkv)]
    return out


@pytest.mark.parametrize("case", list(PARTITIONS), ids=list(PARTITIONS))
def test_every_live_row_in_exactly_one_stage(case):
    B, K, Smax, G, dh, bkv, lengths = PARTITIONS[case]
    n = dec.mma_split_count(B, K, Smax, G, dh, bkv, H100_SMS)
    wph = dec.MMA_WARPS // dec.mma_heads(K)
    blocks = B * (K // dec.mma_heads(K)) * n
    assert 1 <= n and (n == 1 or blocks <= H100_SMS * dec.mma_resident(bkv, dh))
    for length in lengths:
        stages = _stages(length, n, wph, bkv)
        rows = sorted(r for st in stages.values() for stage in st for r in stage)
        assert rows == list(range(length))
        assert all(1 <= len(stage) <= bkv for st in stages.values() for stage in st)
    # the partials: a slot of G * (dh + 2) floats a split of each sequence and KV head
    if n > 1:
        assert B * K * n * G * (dh + 2) * 4 <= dec.PARTIAL_SHARE * 2 * B * Smax * K * dh * 2


def _rows_per_sm(B, K, n, lengths, sms):
    """Live rows each SM streams, the blocks (a split of ``mma_heads(K)``
    heads each) dealt to the SMs in turn in the grid's order."""
    per_sm = [0] * sms
    block = 0
    for length in lengths:
        r = -(-length // n)
        for s in range(n):
            for _ in range(K // dec.mma_heads(K)):
                per_sm[block % sms] += dec.mma_heads(K) * max(0, min(s * r + r, length) - s * r)
                block += 1
    return per_sm


@pytest.mark.parametrize("case", ["decode_32k", "decode_32k_stage16"])
def test_decode_32k_fills_every_sm_evenly(case):
    B, K, Smax, G, dh, bkv, lengths = PARTITIONS[case]
    n = dec.mma_split_count(B, K, Smax, G, dh, bkv, H100_SMS)
    assert B * (K // dec.mma_heads(K)) * n <= H100_SMS * dec.mma_resident(bkv, dh)  # one wave
    per_sm = _rows_per_sm(B, K, n, lengths, H100_SMS)
    mean = sum(per_sm) / H100_SMS
    assert sum(per_sm) == K * sum(lengths)
    assert max(per_sm) <= 1.05 * mean
    # 32-row stages (the runtime's): a block an SM, a block a sequence, no
    # partials; 16-row stages: two blocks an SM, two a sequence
    assert n == (1 if bkv == 32 else 2)


@pytest.mark.parametrize("shape", [(8, 2, 576), (8, 2, 8208), (1, 2, 32768), (3, 1, 100),
                                   (128, 2, 32768), (64, 4, 4096), (2, 8, 16)], ids=str)
def test_split_count_keeps_the_partials_under_their_share(shape):
    """The splits read shapes only (the host never waits for ``lengths``):
    at least 1, no more than fill a wave or give every warp a stage, and the
    partials under ``PARTIAL_SHARE`` of the cache's bytes."""
    B, K, Smax = shape
    for dh, G, bkv in ((64, 7, 32), (64, 7, 16), (128, 16, 16), (32, 3, 64)):
        n = dec.mma_split_count(B, K, Smax, G, dh, bkv, H100_SMS)
        blocks = B * (K // dec.mma_heads(K))
        assert n >= 1
        assert n == 1 or blocks * n <= H100_SMS * dec.mma_resident(bkv, dh)
        assert n == 1 or n <= -(-Smax // (dec.MMA_WARPS // dec.mma_heads(K) * bkv))
        assert n == 1 or B * K * n * G * (dh + 2) * 4 <= dec.PARTIAL_SHARE * 4 * B * Smax * K * dh


# ---------------------------------------------------------------------------
# the arithmetic: P as bf16 hi + lo
# ---------------------------------------------------------------------------

def _bf16_valued(seed, *shape, scale=1.0):
    """float32 tensors holding bf16 values: the inputs the kernel reads."""
    return (_rand(seed, *shape) * scale).to(torch.bfloat16).float()


EMULATED = {
    # B, H, K, dh, Smax, lengths, block_kv: several splits a sequence, an
    # empty sequence, a length of 1, stages cut short at the ends
    "group7": (3, 14, 2, 64, 2048, [2048, 1, 1777], 32),
    "group16_dh128": (2, 16, 1, 128, 3000, [0, 2999], 16),
    "mha_dh32": (4, 4, 4, 32, 1024, [1024, 500, 17, 0], 64),
}


@pytest.mark.parametrize("case", list(EMULATED), ids=list(EMULATED))
def test_hi_lo_keeps_p_at_f32_accuracy(case, monkeypatch):
    B, H, K, dh, Smax, lengths, bkv = EMULATED[case]
    q = _bf16_valued(0, B, H, dh, scale=3.0)  # peaked scores: P spans decades
    k, v = _bf16_valued(1, B, Smax, K, dh), _bf16_valued(2, B, Smax, K, dh)
    tl = torch.tensor(lengths)
    splits = dec.mma_split_count(B, K, Smax, H // K, dh, bkv, H100_SMS)
    want = dec.decode_attention_plain(q.double(), k.double(), v.double(), tl)
    got = dec.decode_attention_bf16_plain(q, k, v, tl, block_kv=bkv, sms=H100_SMS)
    assert got.dtype == torch.float32
    err = (got.double() - want).abs().max().item()
    for b, n in enumerate(lengths):
        if n == 0:
            assert bool((got[b] == 0).all())
    # P rounded once to bf16, as the flash kernel rounds it: a different result
    monkeypatch.setattr(dec, "_hi_lo", lambda p: (p.to(torch.bfloat16).float(), 0.0 * p))
    once = dec.decode_attention_bf16_plain(q, k, v, tl, block_kv=bkv, sms=H100_SMS)
    err_once = (once.double() - want).abs().max().item()
    assert err <= 2e-6, (err, splits)
    assert err_once >= 20 * err, (err, err_once)
    assert splits > 1


def test_emulation_in_bf16_matches_the_plain_version():
    B, H, K, dh, Smax, lengths, bkv = EMULATED["group7"]
    q, k, v = (_rand(s, *shape, dtype=torch.bfloat16)
               for s, shape in ((3, (B, H, dh)), (4, (B, Smax, K, dh)), (5, (B, Smax, K, dh))))
    tl = torch.tensor(lengths)
    got = dec.decode_attention_bf16_plain(q, k, v, tl, block_kv=bkv)
    want = dec.decode_attention_plain(q, k, v, tl)
    assert got.dtype == want.dtype == torch.bfloat16
    g, w = got.float(), want.float()
    assert bool(((g - w).abs() <= BF16_TOL * (1 + w.abs())).all())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    """The card, decided inside the test (never at import or collection):
    a ``card`` test skips with a reason where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _card_inputs(card, B, H, K, dh, Smax, lengths, seed=0):
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=card).to(torch.bfloat16)

    return (rand(B, H, dh), rand(B, Smax, K, dh), rand(B, Smax, K, dh),
            torch.tensor(lengths, dtype=torch.int32, device=card))


def _within(got, want):
    g, w = got.float(), want.float()
    return bool(torch.isfinite(g).all()) and bool(((g - w).abs() <= BF16_TOL * (1 + w.abs())).all())


def _ulp(x):
    """One bf16 ulp at each |x|."""
    return torch.exp2(torch.floor(torch.log2(x.float().abs().clamp(min=1e-30))) - 7)


def _ulps_of_largest(got, want):
    """The largest |got - want| in bf16 ulps of the largest |want|."""
    w = want.float()
    return float((got.float() - w).abs().max() / _ulp(w.abs().max()))


def _ulps_of_each(got, emu):
    """The largest |got - emu| in bf16 ulps of each |emu|, an output taken at
    no less than EMU_FLOOR of the largest."""
    e = emu.float()
    at = torch.maximum(e.abs(), EMU_FLOOR * e.abs().max())
    return float(((got.float() - e).abs() / _ulp(at)).max())


def _emulate(q, k, v, tl, **kw):
    return dec.decode_attention_bf16_plain(
        q, k, v, tl, sms=torch.cuda.get_device_properties(q.device).multi_processor_count, **kw)


CARD_SHAPES = {
    "decode_32k": (128, 14, 2, 64, 32768,
                   np.random.default_rng(7).integers(31745, 31873, 128).tolist()),
    "prefill_8k": (8, 14, 2, 64, 8208, [1024, 8192, 3000, 1500, 6000, 4096, 2048, 7777]),
}


@pytest.mark.card
@pytest.mark.parametrize("case", list(CARD_SHAPES), ids=list(CARD_SHAPES))
def test_card_kernel_matches_the_plain_version(card, case):
    B, H, K, dh, Smax, lengths = CARD_SHAPES[case]
    q, k, v, tl = _card_inputs(card, B, H, K, dh, Smax, lengths)
    before = (dec.decode_attention.launches, dec.decode_attention_bf16.launches)
    got = dec.decode_attention(q, k, v, tl)
    assert (dec.decode_attention.launches, dec.decode_attention_bf16.launches) == \
        (before[0] + 1, before[1] + 1)
    want = torch.cat([dec.decode_attention_plain(q[i:i + 16], k[i:i + 16], v[i:i + 16],
                                                 tl[i:i + 16]) for i in range(0, B, 16)])
    assert _within(got, want)
    assert _ulps_of_largest(got, want) <= PLAIN_ULPS
    assert _ulps_of_each(got, _emulate(q, k, v, tl)) <= EMU_ULPS
    assert torch.equal(dec.decode_attention(q, k, v, tl), got)  # two calls bit for bit


@pytest.mark.card
@pytest.mark.parametrize("case", list(CARD_SHAPES), ids=list(CARD_SHAPES))
def test_card_kernel_keeps_p_as_hi_plus_lo(card, case, monkeypatch):
    """The kernel's outputs lie nearer the emulation with P as bf16 hi + lo
    (f32, before rounding) than the one with P rounded once to bf16: a
    kernel that left out the lo product would lie nearer the second.  (Over
    every output, in ulps of each: ~0.25 against ~0.8 where the kernel is
    the first, the other way round where it is the second.)"""
    B, H, K, dh, Smax, lengths = CARD_SHAPES[case]
    q, k, v, tl = _card_inputs(card, B, H, K, dh, Smax, lengths, seed=4)
    got = dec.decode_attention(q, k, v, tl).float()
    hi_lo = _emulate(q.float(), k, v, tl)
    monkeypatch.setattr(dec, "_hi_lo", lambda p: (p.to(torch.bfloat16).float(), 0.0 * p))
    once = _emulate(q.float(), k, v, tl)
    at = _ulp(torch.maximum(hi_lo.abs(), EMU_FLOOR * hi_lo.abs().max()))
    near, far = (float(((got - e).abs() / at).mean()) for e in (hi_lo, once))
    assert near <= 0.5 * far, (near, far)


@pytest.mark.card
@pytest.mark.parametrize("case", [
    # B, H, K, dh, Smax, lengths, block_kv
    (4, 14, 2, 64, 2048, [0, 1, 2048, 1], 32),
    (3, 16, 1, 128, 3000, [2999, 0, 1], 16),
    (2, 4, 4, 32, 700, [700, 333], 64),
    (6, 12, 2, 48, 1000, [1000, 999, 1, 0, 500, 17], 16),
    (8, 14, 2, 64, 576, [575] * 8, 32),  # the served shape: one split
], ids=str)
def test_card_lengths_and_the_emulation(card, case):
    B, H, K, dh, Smax, lengths, bkv = case
    q, k, v, tl = _card_inputs(card, B, H, K, dh, Smax, lengths, seed=1)
    got = dec.decode_attention_bf16(q, k, v, tl, block_kv=bkv)
    want = dec.decode_attention_plain(q, k, v, tl)
    assert _within(got, want)
    assert _ulps_of_largest(got, want) <= PLAIN_ULPS
    assert _ulps_of_each(got, _emulate(q, k, v, tl, block_kv=bkv)) <= EMU_ULPS
    for b, n in enumerate(lengths):
        if n == 0:
            assert bool((got[b] == 0).all())


@pytest.mark.card
def test_card_a_ring_buffer_is_served_as_it_lies(card):
    B, H, K, dh, Smax = 4, 14, 2, 64, 4096
    q, k, v, tl = _card_inputs(card, B, H, K, dh, Smax, [Smax] * B, seed=2)
    got = dec.decode_attention(q, k, v, tl)
    rolled = dec.decode_attention(q, k.roll(1234, dims=1), v.roll(1234, dims=1), tl)
    assert _within(rolled, got)


@pytest.mark.card
def test_card_graph_replays_leave_the_counters_at_zero(card):
    B, H, K, dh, Smax, lengths = CARD_SHAPES["prefill_8k"]
    q, k, v, tl = _card_inputs(card, B, H, K, dh, Smax, lengths, seed=3)
    want = dec.decode_attention(q, k, v, tl)  # eager: the counters exist before the capture
    assert dec.decode_attention.last_splits > 1
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            out = dec.decode_attention(q, k, v, tl)
    torch.cuda.current_stream().wait_stream(stream)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        assert int(dec._COUNTERS[torch.cuda.current_device()].abs().sum()) == 0


@pytest.mark.card
def test_card_compiled_qwen2_decode_launches_24_tensor_core_calls(card):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import build_model
    from repro_torch.models.params import split_params
    from repro_torch.serve import serve_step as SS

    cfg = get_config("qwen2-0.5b")
    model = build_model(cfg)
    rt = serve_cli.runtime(True, "bf16")
    gen = torch.Generator(device=card)
    gen.manual_seed(0)
    params, _ = split_params(model.init(gen, dtype=rt.dtype()))
    prefill = SS.make_graphed_prefill_step(model, rt)
    decode = SS.make_graphed_decode_step(model, rt)
    cache = split_params(model.init_cache(4, 256 + 8, device=card))[0]
    prompts = torch.randint(0, cfg.vocab_size, (4, 256), generator=gen, device=card,
                            dtype=torch.int64).to(torch.int32)
    logits, c = prefill(params, {"tokens": prompts}, SS.reset_cache(cache))
    tok = SS.greedy_sample(logits)
    for _ in range(2):  # eager, capture
        logits, c = decode(params, tok, c)
        tok = SS.greedy_sample(logits)
    before = (dec.decode_attention.launches, dec.decode_attention_bf16.launches)
    for _ in range(3):
        logits, c = decode(params, tok, c)
        tok = SS.greedy_sample(logits)
    torch.cuda.synchronize()
    assert (dec.decode_attention.launches - before[0],
            dec.decode_attention_bf16.launches - before[1]) == (72, 72)
    decode.release()
    prefill.release()
