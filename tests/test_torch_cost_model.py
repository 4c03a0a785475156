"""The port's roofline cost model against the reference's.

Exact comparisons (``==``): both sides run the same float arithmetic on the
same config numbers.  At a pod of 256 chips (one pod, and two) the five
analytic functions equal the reference's for every arch x shape at several
backend configs; at one card the port takes dp = tp = 1 from the mesh,
where the reference reads them at a 256-chip pod whatever the mesh (its
fault, not copied: ``tuning/cost_model.py``).
"""
import dataclasses
import math

import pytest

import repro.configs as ref_configs
import repro.tuning.cost_model as R
import repro.tuning.parameters as RP
import repro_torch.tuning.cost_model as T
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.tuning.parameters import BASELINE, BackendConfig

#: points that move every term the functions read: the mesh split, the
#: sharding style, the attention tile, the optimizer state and the MoE
#: capacity
POINTS = {
    "baseline": {},
    "dp1_tp": dict(log2_dp=0, sharding_style="tp", block_q=256),
    "dp256_bf16": dict(log2_dp=8, opt_state_dtype="bf16", capacity_factor=2.0),
    "dp8_bq1024": dict(log2_dp=3, block_q=1024, capacity_factor=1.25),
}
CELLS = [(a, s) for a in list_archs() for s in SHAPES]


def _pair(arch, shape_name, point):
    return ((get_config(arch), SHAPES[shape_name], BASELINE.replace(**point)),
            (ref_configs.get_config(arch), ref_configs.SHAPES[shape_name],
             RP.BASELINE.replace(**point)))


@pytest.mark.parametrize("point", sorted(POINTS))
@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_analytic_functions_equal_the_reference_at_a_256_chip_pod(arch, shape_name, point):
    (cfg, shape, bc), (rcfg, rshape, rbc) = _pair(arch, shape_name, POINTS[point])
    for chips in (256, 512):  # one pod, and the reference's two pods
        assert T.kernel_traffic_bytes(cfg, shape, bc, chips) == \
            R.kernel_traffic_bytes(rcfg, rshape, rbc, chips)
        assert T.analytic_hbm_traffic(cfg, shape, bc, chips) == \
            R.analytic_hbm_traffic(rcfg, rshape, rbc, chips)
    n = cfg.param_counts()["active"]
    assert T.model_flops(cfg, shape, n) == R.model_flops(rcfg, rshape, n)
    assert T.tokens_per_step(shape) == R.tokens_per_step(rshape)
    by_kind = {"all-reduce": 3 * len(arch), "all-gather": 7, "all-to-all": 11,
               "collective-permute": 5, "reduce-scatter": shape.seq_len}
    assert T.weighted_collective_bytes(by_kind) == R.weighted_collective_bytes(by_kind)


class _OneChip(RP.BackendConfig):
    """The reference's config with its mesh split read at one card."""

    def dp(self, chips_per_pod=256):
        return 1

    def tp(self, chips_per_pod=256):
        return 1


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_one_card_takes_dp_tp_from_the_mesh_not_from_a_256_chip_pod(arch, shape_name):
    (cfg, shape, bc), (rcfg, rshape, _) = _pair(arch, shape_name, {})
    one = _OneChip()
    assert T.kernel_traffic_bytes(cfg, shape, bc, 1) == \
        R.kernel_traffic_bytes(rcfg, rshape, one, 1)
    assert T.analytic_hbm_traffic(cfg, shape, bc, 1) == \
        R.analytic_hbm_traffic(rcfg, rshape, one, 1)


def test_the_reference_fault_on_one_card():
    """qwen2-0.5b at decode_32k on one card: the reference reckons the KV
    stream at a 16 x 16 split (0.202 GB); the card streams all 51.6 GB."""
    (cfg, shape, bc), (rcfg, rshape, rbc) = _pair("qwen2-0.5b", "decode_32k", {})
    port = T.kernel_traffic_bytes(cfg, shape, bc, 1)
    ref = R.kernel_traffic_bytes(rcfg, rshape, rbc, 1)
    kv = 24 * 2 * 128 * 32768 * 2 * 64 * 2  # layers x K,V x B x S x heads x dh x bf16
    q_out = 24 * 2 * 128 * 14 * 64 * 2
    assert port == kv + q_out
    assert ref < port / 200
    assert round(ref / 1e9, 3) == 0.202 and round(port / 1e9, 1) == 51.6


V5E = T.Hardware("TPU v5e", peak_flops=R.PEAK_FLOPS_BF16, hbm_bw=R.HBM_BW,
                 link_bw=R.ICI_BW, hbm_bytes=R.HBM_BYTES)

ROOFLINES = {  # one compute-, one memory- and one collective-bound step
    "compute": dict(flops_per_device=3.1e15, bytes_per_device=2.2e11, collective_bytes=4e9,
                    tokens_per_step=1048576, chips=256, model_flops=2.9e17,
                    memory_per_device=1.2e10, collective_detail="all-gather:48x/9.0MB",
                    bytes_hlo_raw=9.9e12, bytes_kernel_credit=3.3e10),
    "memory": dict(flops_per_device=1e12, bytes_per_device=5.5e10, collective_bytes=1e6,
                   tokens_per_step=128, chips=1, model_flops=1.3e11,
                   memory_per_device=6e10, bytes_hlo_raw=5.6e11,
                   bytes_kernel_credit=5.15e10),
    "collective": dict(flops_per_device=1e9, bytes_per_device=1e6, collective_bytes=5e9,
                       tokens_per_step=32, chips=512, memory_per_device=None),
}


@pytest.mark.parametrize("case", sorted(ROOFLINES))
def test_roofline_row_equals_the_reference_given_its_constants(case):
    kw = ROOFLINES[case]
    ours, ref = T.Roofline(**kw, hw=V5E).row(), R.Roofline(**kw).row()
    assert ours == ref
    assert ours["bottleneck"] == case


def test_roofline_defaults_to_the_h100_data_sheet():
    assert (T.PEAK_FLOPS_BF16, T.HBM_BW, T.NVLINK_BW, T.HBM_BYTES) == \
        (989e12, 3.35e12, 450e9, 80e9)
    rf = T.Roofline(flops_per_device=989e12, bytes_per_device=3.35e12 / 2,
                    collective_bytes=0.0, tokens_per_step=1000.0, chips=1,
                    model_flops=989e12 / 2, memory_per_device=81e9)
    row = rf.row()
    assert row["compute_s"] == 1.0 and row["memory_s"] == 0.5
    assert row["bottleneck"] == "compute" and row["mfu"] == 0.5
    assert row["fits_hbm"] is False
    assert math.isclose(row["throughput_tok_s"], 1000.0)
    assert dataclasses.replace(rf, hw=V5E).row()["compute_s"] == 989e12 / 197e12


def test_chips_per_pod_is_explicit_for_a_smaller_pod():
    cfg, shape = get_config("qwen2-0.5b"), SHAPES["train_4k"]
    bc = BackendConfig(log2_dp=2)
    # 2 pods of 16 chips: 4-way data parallel a pod, 4-way tensor parallel
    ours = T.kernel_traffic_bytes(cfg, shape, bc, 32, chips_per_pod=16)
    rcfg, rshape = ref_configs.get_config("qwen2-0.5b"), ref_configs.SHAPES["train_4k"]

    class _Pod16(RP.BackendConfig):
        def dp(self, chips_per_pod=256):
            return 4

        def tp(self, chips_per_pod=256):
            return 4

    assert ours == R.kernel_traffic_bytes(rcfg, rshape, _Pod16(log2_dp=2), 512)
