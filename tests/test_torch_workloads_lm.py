"""The three language-model workloads' measured steps against the reference.

``dense_lm`` (qwen2), ``moe_lm`` (qwen3-MoE) and ``rwkv`` (RWKV-6), reduced,
S=64: the reference's own seeded weights go through ``params_from_numpy``
into the port, and the loss of one AdamW train step (``fn(*args)``) equals
the reference's at rtol 1e-5 (f32, other summation orders) at two points
each.  One ``make_step`` each serves both points, so the second point draws the
reference's second batch; the second points set the workload's own knob
(``block_q``, ``capacity_factor``, ``scan_chunk``) with remat and
microbatches.
"""
import jax
import numpy as np
import pytest

from benchmarks import workloads as ref
from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models.params import split_params as ref_split_params
from repro_torch.benchmarks import workloads as port
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.runtime import Runtime

RTOL = 1e-5
POINTS = {
    "dense_lm": [dict(batch=2, microbatches=1, remat="none", block_q=32),
                 dict(batch=4, microbatches=2, remat="full", block_q=16)],
    "moe_lm": [dict(batch=2, microbatches=1, remat="dots", block_q=64, capacity_factor=1.0),
               dict(batch=4, microbatches=2, remat="none", block_q=8, capacity_factor=1.5)],
    "rwkv": [dict(batch=2, microbatches=1, remat="names", scan_chunk=16),
             dict(batch=4, microbatches=4, remat="full", scan_chunk=8)],
}


def _ref_params(arch):
    """The weights the reference's ``_lm_make_step`` draws (``PRNGKey(0)``), as numpy."""
    model = ref_build_model(ref_get_config(arch).reduced())
    values, _ = ref_split_params(model.init(jax.random.PRNGKey(0)))
    return jax.tree_util.tree_map(np.asarray, values)


@pytest.mark.parametrize("i", range(3), ids=list(POINTS))
def test_lm_losses_equal_reference(i):
    w = port.MEASURED_WORKLOADS[i]
    params = params_from_numpy(_ref_params(w["arch"]), device="cpu")
    a = ref.measured_make_step(ref.MEASURED_WORKLOADS[i])
    b = port.measured_make_step(w, device="cpu", params=params)
    for p in POINTS[w["name"]]:
        fa, args_a, work_a = a(p)
        fb, args_b, work_b = b(p)
        assert work_a == work_b == float(p["batch"] * 64)
        want, got = float(fa(*args_a)), float(fb(*args_b))
        assert np.isfinite(got)
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=str(p))
        # the step is functional: measuring it again gives the same loss
        assert float(fb(*args_b)) == got


def test_runtime_override_reaches_the_step():
    """``runtime=`` replaces the base the point's knobs go on: the oracle
    (``attn_impl="ref"``) and the chunked oracle agree on the same batch."""
    w = port.MEASURED_WORKLOADS[0]
    params = port.lm_params(port.lm_config(w), device="cpu")
    p = POINTS["dense_lm"][0]
    losses = []
    for rt in (None, Runtime(compute_dtype="f32", attn_impl="ref")):
        fn, args, _ = port.measured_make_step(w, device="cpu", params=params, runtime=rt)(p)
        losses.append(float(fn(*args)))
    np.testing.assert_allclose(losses[1], losses[0], rtol=RTOL)


def test_lm_config_cuts_depth_only():
    w = port.MEASURED_WORKLOADS[1]
    full = port.lm_config(w, reduced=False)
    cut = port.lm_config(w, reduced=False, num_layers=2)
    assert (full.num_layers, cut.num_layers) == (48, 2)
    assert (cut.d_model, cut.moe.num_experts, cut.vocab_size) == (
        full.d_model, full.moe.num_experts, full.vocab_size)
    assert port.lm_config(w).name.endswith("-reduced")


def test_indivisible_microbatches_fail_in_both():
    """A batch that does not split into the microbatches is a failed run in
    both packages (the tuner scores it -inf)."""
    p = dict(batch=2, microbatches=4, remat="none", block_q=8)
    fn, args, _ = ref.measured_make_step(ref.MEASURED_WORKLOADS[0])(p)
    with pytest.raises(AssertionError):
        fn(*args)
    fn, args, _ = port.measured_make_step(port.MEASURED_WORKLOADS[0], device="cpu")(p)
    with pytest.raises(ValueError, match="does not split into 4 microbatches"):
        fn(*args)
