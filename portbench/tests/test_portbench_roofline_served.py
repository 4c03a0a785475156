"""K5 in the served prefill (``roofline_served.py``, ``k5_roofline.prefill``):
its operations and bytes counted by hand, the padding counted as no work,
and the reader on a stand-in trace, with and without the kernel."""
from types import SimpleNamespace

import pytest

from portbench import roofline, roofline_served, spec
from portbench.trace import reduce_events


def test_k5_state_call_counts_by_hand():
    # B=64 prompts of 1,024 tokens, 40 heads of 64, bf16: the operations of
    # k5_call; r, k, v in and y out (4 x 64 bf16 = 512 B a token and head),
    # w in f32 (256 B), u (40 x 64 f32) and the state (64 x 40 x 64 x 64 f32)
    flops, nbytes = roofline_served.k5_state_call(64, 1024, 40, 64, 64, "bf16")
    tokens = 64 * 1024
    assert flops == roofline.k5_call(64, 1024, 40, 64, 64, "bf16")[0] == tokens * 40 * 20_800
    assert nbytes == tokens * 40 * (512 + 256) + 40 * 64 * 4 + 64 * 40 * 64 * 64 * 4
    # its operations run at the f32 rate whatever the operands' type
    port = spec.config("rwkv6-3b")["port"]
    assert roofline_served.k5_state_seconds(port, "bf16", 64, 1024) == pytest.approx(
        max(flops / 67e12, nbytes / 3.35e12))


def test_the_padding_is_no_work():
    one = [roofline_served.k5_state_call(1, n, 40, 64, 64, "bf16") for n in (600, 2048)]
    both = roofline_served.k5_state_call(2, (600, 2048), 40, 64, 64, "bf16")
    # each call reads u once
    assert both == (one[0][0] + one[1][0], one[0][1] + one[1][1] - 40 * 64 * 4)
    assert both[1] < roofline_served.k5_state_call(2, 2048, 40, 64, 64, "bf16")[1]


def _run(dev, counted, waves=2, layers=3):
    conf = {"port": dict(spec.config("rwkv6-3b")["port"], num_layers=layers), "dtype": "bf16"}
    return SimpleNamespace(tracing=reduce_events(dev, [], 1.0), conf=conf, notes=[],
                           counters={"gla_scan_state": counted},
                           work={"prefill_steps": [(2, (600, 2048))] * waves})


def test_the_reader_on_a_stand_in_trace():
    read = spec.metric("k5_roofline.prefill").read
    ms = 1_000_000
    name = "void (anonymous namespace)::gla_state_kernel<__nv_bfloat16, 64, 8>(GlaParams)"
    dev = [(i * 10 * ms, i * 10 * ms + 2 * ms, name) for i in range(6)]  # 6 launches of 2 ms
    run = _run(dev, 6)
    least = 6 * roofline_served.k5_state_seconds(run.conf["port"], "bf16", 2, (600, 2048))
    assert read(run) == pytest.approx(100 * least / 0.012)
    assert not run.notes
    miscounted = _run(dev, 5)
    read(miscounted)
    assert miscounted.notes and "gla_state_kernel" in miscounted.notes[0]


def test_the_reader_reads_nothing_without_the_kernel():
    read = spec.metric("k5_roofline.prefill").read
    ms = 1_000_000
    # the training forward's kernel and a program without the state kernel
    dev = [(0, 2 * ms, "void (anonymous namespace)::gla_kernel<float, 64, 8>(GlaParams)")]
    assert read(_run(dev, None)) is None
    assert read(SimpleNamespace(tracing=None)) is None
