"""The measured convnet and NCF steps against the reference, on the CPU.

For the same seeded weights and batches, each step's gradient of every
weight equals the reference's at rtol 1e-5 in f32, with atol 1e-5 of the
leaf's largest magnitude for elements that cancel: a depthwise kernel's
gradient sums 8192 products per element, and f32 rounding in another
summation order (another thread count) leaves up to 1.1e-6 of the leaf's
largest magnitude there.  So does ``fn(*args)``,
the sum of one weight's gradient that the harness times.  The convnet's sum
is over its head's gradient, which is zero but for rounding (each row of
softmax minus one-hot sums to 0), so there ``fn(*args)`` is held to 1e-5 of
the summed magnitudes instead.

The reference's convnet cannot run as written: its depthwise kernels are
drawn (3, 3, C, 1) in HWIO under ``feature_group_count=C``, which JAX
refuses (``test_reference_convnet_raises`` shows it).  The comparison
therefore runs the reference's own step with that one call given the same
numbers as the (3, 3, 1, C) kernel a depthwise convolution takes, which is
what the port computes.
"""
import math

import jax
import numpy as np
import pytest
import torch

from benchmarks import workloads as ref
from repro_torch.benchmarks import workloads as port
from repro_torch.core import SearchSpace, Tuner, TunerConfig
from repro_torch.tuning.evaluator import WallClockEvaluator

CONV, NCF = 3, 4
RTOL = 1e-5
ATOL = 1e-5  # of a gradient leaf's largest magnitude (see the module docstring)

CONV_POINTS = [
    dict(batch=4, microbatches=1, remat="none", channels_last=0),
    dict(batch=4, microbatches=2, remat="full", channels_last=1),
    dict(batch=8, microbatches=4, remat="dots", channels_last=0),
    dict(batch=2, microbatches=4, remat="none", channels_last=1),  # 2 % 4: whole batch
    dict(batch=16, microbatches=2, remat="names", channels_last=1),
    dict(batch=2, microbatches=4, remat="full", channels_last=0),
]
NCF_POINTS = [
    dict(batch=64, microbatches=1, remat="none", embed_block=8),
    dict(batch=128, microbatches=2, remat="full", embed_block=16),
    dict(batch=512, microbatches=4, remat="dots", embed_block=64),
]


@pytest.fixture
def depthwise_fixed(monkeypatch):
    """The reference's convolution call with its depthwise kernels read as
    (3, 3, 1, C): the same numbers, in the layout grouped convolution takes."""
    conv = jax.lax.conv_general_dilated

    def fixed(lhs, rhs, *args, feature_group_count=1, **kw):
        if feature_group_count > 1 and rhs.shape[-1] == 1:
            rhs = rhs.reshape(rhs.shape[0], rhs.shape[1], 1, rhs.shape[2])
        return conv(lhs, rhs, *args, feature_group_count=feature_group_count, **kw)

    monkeypatch.setattr(jax.lax, "conv_general_dilated", fixed)


def test_reference_convnet_raises():
    fn, args, _ = ref.measured_make_step(ref.MEASURED_WORKLOADS[CONV])(CONV_POINTS[0])
    with pytest.raises(ValueError, match="feature_group_count"):
        fn(*args)


@pytest.fixture
def grads(monkeypatch):
    """Records the full gradient trees both steps compute inside ``fn``."""
    seen = {"ref": [], "port": []}
    real_grad, real_port = jax.grad, port._grads

    def ref_grad(f, *a, **kw):
        g = real_grad(f, *a, **kw)

        def rec(*args):
            out = g(*args)
            seen["ref"].append(jax.tree_util.tree_map(np.asarray, out))
            return out

        return rec

    def port_grads(loss, ws):
        out = real_port(loss, ws)
        seen["port"].append({k: v.detach().numpy() for k, v in out.items()})
        return out

    monkeypatch.setattr(jax, "grad", ref_grad)
    monkeypatch.setattr(port, "_grads", port_grads)
    return seen


def _both(i, points, seen):
    a = ref.measured_make_step(ref.MEASURED_WORKLOADS[i])
    b = port.measured_make_step(port.MEASURED_WORKLOADS[i], device="cpu")
    for p in points:  # one make_step each: the i-th point draws the i-th batch
        fa, args_a, work_a = a(p)
        fb, args_b, work_b = b(p)
        assert work_a == work_b == float(p["batch"])
        want, got = float(fa(*args_a)), float(fb(*args_b))
        g_ref, g_port = seen["ref"][-1], seen["port"][-1]
        assert sorted(g_ref) == sorted(g_port)
        for k in g_ref:
            # HWIO -> (O, I / groups, kH, kW), as the port lays the kernels out
            want_k = (g_ref[k].transpose(2, 3, 0, 1) if k.startswith("dw")
                      else g_ref[k].transpose(3, 2, 0, 1) if k.startswith("pw") else g_ref[k])
            np.testing.assert_allclose(g_port[k], want_k, rtol=RTOL,
                                       atol=ATOL * np.abs(want_k).max(), err_msg=f"{p} {k}")
        yield p, want, got, g_ref


def test_convnet_equals_reference(depthwise_fixed, grads):
    for p, want, got, g in _both(CONV, CONV_POINTS, grads):
        assert abs(got - want) <= RTOL * np.abs(g["head"]).sum(), p


@pytest.mark.parametrize("i", range(len(CONV_POINTS)))
def test_convnet_point_equals_reference_alone(depthwise_fixed, grads, i):
    for p, want, got, g in _both(CONV, [CONV_POINTS[i]], grads):
        assert abs(got - want) <= RTOL * np.abs(g["head"]).sum(), p


def test_convnet_channels_last_changes_layout_not_value(monkeypatch, grads):
    import torch.nn.functional as F

    formats = []
    conv = F.conv2d

    def spy(x, w, *a, **kw):
        if x.shape[1] == w.shape[0] == 16:  # the first layer: the step's input
            formats.append(x.stride(1) == 1)  # channels innermost (NHWC in memory)
        return conv(x, w, *a, **kw)

    monkeypatch.setattr(F, "conv2d", spy)
    p = dict(batch=4, microbatches=2, remat="full", channels_last=0)
    for cl in (0, 1):
        formats.clear()
        fn, args, _ = port.measured_make_step(port.MEASURED_WORKLOADS[CONV], device="cpu")(
            dict(p, channels_last=cl))
        fn(*args)
        assert formats and all(f == bool(cl) for f in formats)
    g0, g1 = grads["port"]
    for k in g0:
        np.testing.assert_allclose(g1[k], g0[k], rtol=RTOL, atol=ATOL * np.abs(g0[k]).max())


def test_ncf_equals_reference(grads):
    for p, want, got, _ in _both(NCF, NCF_POINTS, grads):
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=str(p))


def test_measured_steps_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for w in port.MEASURED_WORKLOADS:
        with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
            port.measured_make_step(w)


def test_measured_evaluator_reports_the_attention_tile():
    ev = port.MeasuredEvaluator(port.MEASURED_WORKLOADS[0], device="cpu", iters=1)
    v, meta = ev(dict(batch=2, microbatches=1, remat="none", block_q=24))
    assert np.isfinite(v) and v > 0
    assert "peak_bytes" not in meta  # a device metric: the card only
    ncf = port.MeasuredEvaluator(port.MEASURED_WORKLOADS[NCF], device="cpu", iters=1)
    _, meta = ncf(NCF_POINTS[0])
    assert "attn_config" not in meta


def test_tuner_end_to_end_on_system(tmp_path):
    """The paper pipeline on the port: tune a measured objective, resume it."""
    w = port.MEASURED_WORKLOADS[NCF]
    space = SearchSpace.from_dicts(w["space"])
    obj = WallClockEvaluator(port.measured_make_step(w, device="cpu"), warmup=1, iters=1)
    ck = tmp_path / "tune.json"
    t = Tuner(obj, space, TunerConfig(algorithm="bo", budget=6, seed=0,
                                      verbose=False, checkpoint_path=str(ck)))
    h1 = t.run()
    assert len(h1) == 6 and np.isfinite(h1.best().value)
    t2 = Tuner(obj, space, TunerConfig(algorithm="bo", budget=8, seed=0,
                                       verbose=False, checkpoint_path=str(ck)))
    h2 = t2.run()
    assert len(h2) == 8
    assert h2.points()[:6] == h1.points()


def test_measured_evaluator_scores_out_of_memory_minus_inf(monkeypatch):
    ev = port.MeasuredEvaluator(port.MEASURED_WORKLOADS[NCF], device="cpu", iters=1)

    def oom(point, fidelity=None):
        raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")

    monkeypatch.setattr(ev, "_wall", oom)
    v, meta = ev(NCF_POINTS[0])
    assert v == -math.inf and meta["oom"] is True and "out of memory" in meta["error"]
