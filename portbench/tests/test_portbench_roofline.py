"""The yardstick's arithmetic against counts made by hand at the cells'
shapes, and the window's statistics."""
import pytest

from portbench import roofline, spec, stats
from portbench.trace import reduce_events


def test_k3_at_decode_32k():
    # B=128 sessions, 14 query / 2 KV heads of 64, the first step attends
    # 31,745 positions: 4*128*14*64*31745 operations; K and V of 128 x 31,745
    # x 2 heads x 64 in bf16 read, q in and out written (2*128*14*64*2 B),
    # lengths 4*128 B
    flops, nbytes = roofline.k3_call(128, 14, 2, 64, 31745, "bf16")
    assert flops == 14_563_082_240
    assert nbytes == 2_080_899_584
    assert roofline.least_seconds(flops, nbytes, "bf16") == pytest.approx(2_080_899_584 / 3.35e12)


def test_k2_at_prefill_8k():
    # B=8, S=8192, causal: 8192*8193/2 = 33,558,528 pairs, 4*8*14*64 per pair;
    # q, o (14 heads) and k, v (2 heads) of 8 x 8192 x 64 bf16
    flops, nbytes = roofline.k2_call(8, 8192, 14, 2, 64, "bf16")
    assert flops == 962_190_114_816
    assert nbytes == 268_435_456
    assert roofline.least_seconds(flops, nbytes, "bf16") == pytest.approx(962_190_114_816 / 989e12)


def test_k5_at_train_2x2048():
    # B=2, S=2048, 40 heads of 64, f32: 5*64*64 + 3*64 + 2*64 = 20,800
    # operations a token and head; r, k, w (64 each), v in and y out (64
    # each) = 320 floats a token and head, and u (40 x 64)
    flops, nbytes = roofline.k5_call(2, 2048, 40, 64, 64, "f32")
    assert flops == 3_407_872_000
    assert nbytes == 209_725_440
    # bound by bytes: 0.0626 ms (the bound PERF.md's table of kernels gives)
    assert roofline.least_seconds(flops, nbytes, "f32") == pytest.approx(6.2605e-5, rel=1e-4)


def test_step_counts_of_qwen2_0_5b():
    port = spec.config("qwen2-0.5b")["port"]
    # 896 x (14 + 2*2) x 64 for q, k, v; 14 x 64 x 896 out; 3 x 896 x 4864 MLP
    assert roofline.layer_matmul_params(port) == 14_909_440
    flops, _ = roofline.prefill_step(port, "bf16", 8, 8192)
    matmuls = 2 * 8 * (8192 * 24 * 14_909_440 + 896 * 152_064)
    assert flops == matmuls + 24 * 962_190_114_816
    assert 69e12 < flops < 71e12


def test_rows_count_their_own_lengths_and_not_the_padding():
    # two prompts of 1,024 and 3,000 tokens packed to 8,192: the work is the
    # sum of each alone, as if each were its own batch of one
    port = spec.config("qwen2-0.5b")["port"]
    one = [roofline.k2_call(1, n, 14, 2, 64, "bf16") for n in (1024, 3000)]
    assert roofline.k2_call(2, (1024, 3000), 14, 2, 64, "bf16") == tuple(map(sum, zip(*one)))
    assert roofline.k3_call(2, 14, 2, 64, (1025, 3001), "bf16")[0] == 4 * 14 * 64 * 4026
    both, _ = roofline.prefill_step(port, "bf16", 2, (1024, 3000))
    alone = sum(roofline.prefill_step(port, "bf16", 1, n)[0] for n in (1024, 3000))
    assert both == alone
    assert both < roofline.prefill_step(port, "bf16", 2, 8192)[0] / 3
    with pytest.raises(ValueError):
        roofline.k2_call(3, (1, 2), 14, 2, 64, "bf16")


def test_padding_share():
    from types import SimpleNamespace

    read = spec.metric("pad_share.prefill").read
    assert read(SimpleNamespace(work={"prefill_tokens": (3000, 8000)})) == pytest.approx(62.5)
    assert read(SimpleNamespace(work={})) is None


def test_percentile_and_rate():
    assert stats.percentile(range(1, 101), 95) == pytest.approx(95.05)
    assert stats.percentile([3.0] * 7, 95) == 3.0
    assert stats.rate(100, 2.0) == 50.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_trace_reduction_busy_gaps_and_names():
    ms = 1_000_000
    dev = [(0, 2 * ms, "k_a"), (1 * ms, 3 * ms, "k_b"), (5 * ms, 6 * ms, "k_a"),
           (10 * ms, 11 * ms, "k_c")]
    host = [(2 * ms, 6 * ms, "decode"), (6 * ms, 12 * ms, "readback")]
    t = reduce_events(dev, host, 0.011)
    assert t.busy_s == pytest.approx(0.005)  # 0-3, 5-6, 10-11 ms
    assert t.idle_share == pytest.approx(1 - 5 / 11)
    assert t.kernel("k_a") == (pytest.approx(0.003), 2)
    assert t.idle_gaps == [["readback", pytest.approx(0.004)], ["decode", pytest.approx(0.002)]]
    assert t.device_ops[0][0] == "k_a"
