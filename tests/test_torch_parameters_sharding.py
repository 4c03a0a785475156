"""The port's backend-parameter space, sharding rules, mesh, input specs and
optimizer-state axes against the reference's.  Every comparison is exact.

The sharding rules are pure mapping logic: both packages resolve every
parameter of every arch on the production meshes (16x16 and 2x16x16, given
as plain objects with ``.shape`` and ``.axis_names``, as
``tests/test_sharding_and_hlo.py`` gives the reference a ``FakeMesh``),
the reference's ``PartitionSpec`` read as a tuple.
"""
import dataclasses
import functools

import jax
import pytest
import torch

import repro.configs as ref_configs
import repro.distributed.sharding as RS
import repro.tuning.parameters as RP
import repro_torch.distributed.sharding as TS
import repro_torch.tuning.parameters as TP
from repro.models.model import build_model as ref_build_model
from repro.models.params import split_params as ref_split_params
from repro.optim.optimizer import OptimizerConfig as RefOptConfig
from repro.optim.optimizer import optimizer_state_axes as ref_opt_axes
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.launch.dryrun import MetaGenerator
from repro_torch.launch.mesh import make_mesh, make_production_mesh, single_device_mesh
from repro_torch.models.model import build_model
from repro_torch.models.params import split_params, tree_leaves
from repro_torch.optim.optimizer import OptimizerConfig, adamw_init, optimizer_state_axes

ARCHS = list_archs()
KINDS = ("train", "serve")


# -- parameters ------------------------------------------------------------------


def test_backend_config_fields_and_defaults_are_the_reference():
    assert dataclasses.asdict(TP.BASELINE) == dataclasses.asdict(RP.BASELINE)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_backend_space_at_a_256_chip_pod_is_the_reference(arch, kind):
    ours = TP.backend_space(get_config(arch), kind=kind, chips_per_pod=256)
    assert ours == RP.backend_space(ref_configs.get_config(arch), kind=kind)
    assert ours == TP.backend_space(get_config(arch), kind=kind)  # 256 is the default


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_one_card_space_leaves_out_the_mesh_dims(arch, kind):
    ours = TP.backend_space(get_config(arch), kind=kind, chips_per_pod=1)
    ref = RP.backend_space(ref_configs.get_config(arch), kind=kind)
    assert ours == [d for d in ref if d["name"] not in ("log2_dp", "sharding_style")]
    # what the dropped dims would set: dp = tp = 1 at every value
    for log2_dp in range(9):
        bc = TP.BASELINE.replace(log2_dp=log2_dp)
        assert (bc.dp(1), bc.tp(1)) == (1, 1)


@pytest.mark.parametrize("cpp", [1, 2, 16, 256])
@pytest.mark.parametrize("log2_dp", [0, 1, 4, 8, 9])
def test_dp_and_tp_match_the_reference(cpp, log2_dp):
    ours, ref = TP.BASELINE.replace(log2_dp=log2_dp), RP.BASELINE.replace(log2_dp=log2_dp)
    assert (ours.dp(cpp), ours.tp(cpp)) == (ref.dp(cpp), ref.tp(cpp))


@pytest.mark.parametrize("point", [{"blok_q": 256}, {"block_q": 256, "threads": 4},
                                   {"zzz": 1, "aaa": 2}])
def test_config_from_point_raises_the_reference_error(point):
    with pytest.raises(ValueError) as ours:
        TP.config_from_point(point)
    with pytest.raises(ValueError) as ref:
        RP.config_from_point(point)
    assert str(ours.value) == str(ref.value)


def test_config_from_point_and_allow_extra():
    point = {"block_q": 256, "remat": "dots", "threads": 4}
    ours = TP.config_from_point(point, allow_extra=("threads",))
    ref = RP.config_from_point(point, allow_extra=("threads",))
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    with pytest.raises(ValueError) as e1:
        TP.BackendConfig(remat="everything")
    with pytest.raises(ValueError) as e2:
        RP.BackendConfig(remat="everything")
    assert str(e1.value) == str(e2.value)


def test_runtime_carries_every_knob():
    bc = TP.BASELINE.replace(block_q=256, block_kv=384, scan_chunk=64, remat="dots",
                             capacity_factor=1.5, attn_prune=True, moe_impl="ep_local")
    rt, ref = bc.runtime(), RP.BASELINE.replace(
        block_q=256, block_kv=384, scan_chunk=64, remat="dots", capacity_factor=1.5,
        attn_prune=True, moe_impl="ep_local").runtime()
    for f in ("attn_impl", "scan_impl", "block_q", "block_kv", "scan_chunk", "remat",
              "compute_dtype", "moe_capacity_factor", "moe_impl", "unroll_layers",
              "attn_prune"):
        assert getattr(rt, f) == getattr(ref, f), f


# -- sharding rules ---------------------------------------------------------------


class _Mesh:
    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = axes


MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _rules(mod, mesh_name, style):
    return mod.ShardingRules(_Mesh(*MESHES[mesh_name]), style)


@functools.lru_cache(maxsize=None)
def _ref_tree(arch):
    box = {}

    def values():
        v, axes = ref_split_params(ref_build_model(ref_configs.get_config(arch)).init(
            jax.random.PRNGKey(0)))
        box["axes"] = axes
        return v

    return jax.eval_shape(values), box["axes"]


@functools.lru_cache(maxsize=None)
def _port_tree(arch):
    return split_params(build_model(get_config(arch)).init(MetaGenerator()))


def _flat(tree, prefix=()):
    """path -> leaf of nested dicts (both packages' trees are dicts)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("style", ["tp", "fsdp_tp"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_the_reference(arch, mesh, style):
    values, axes = _port_tree(arch)
    rvalues, raxes = _ref_tree(arch)
    ours = _flat(_rules(TS, mesh, style).tree_specs(axes, values))
    ref = _flat(_rules(RS, mesh, style).tree_specs(raxes, rvalues))
    assert ours == {k: tuple(p) for k, p in ref.items()}
    assert {k: tuple(v.shape) for k, v in _flat(values).items()} == \
        {k: tuple(v.shape) for k, v in _flat(rvalues).items()}


@pytest.mark.parametrize("case", [
    (("embed", "heads", None), (896, 14, 64)), (("embed", "ff"), (896, 4864)),
    (("ff", "ff"), (4864, 4864)), (("batch", "cache_seq", "kv_heads", "head"), (128, 32768, 2, 64)),
    (("layers", "embed", "experts", "ff"), (48, 2048, 128, 768)), ((None, None), (3, 5)),
])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_spec_for_matches_the_reference(case, mesh):
    axes, shape = case
    for style in ("tp", "fsdp_tp"):
        for overrides in (None, {"cache_seq": None}):
            ours = TS.ShardingRules(_Mesh(*MESHES[mesh]), style, overrides).spec_for(axes, shape)
            ref = RS.ShardingRules.__new__(RS.ShardingRules)
            ref.mesh, ref.style = _Mesh(*MESHES[mesh]), style
            ref.rules = RS.make_rules(style, "pod" in ref.mesh.axis_names)
            ref.rules.update(overrides or {})
            assert ours == tuple(ref.spec_for(axes, shape))
            assert TS.ShardingRules(_Mesh(*MESHES[mesh]), style, overrides).spec_for(axes) \
                == tuple(ref.spec_for(axes))


def test_unknown_style_raises_as_the_reference():
    with pytest.raises(ValueError, match="unknown sharding style"):
        TS.make_rules("zero", multi_pod=False)


def test_shard_hint_is_the_identity_on_one_card():
    x = torch.ones(4, 8)
    assert TS.shard_hint(x, ("batch", "embed")) is x  # outside active_rules
    with TS.active_rules(TS.ShardingRules(single_device_mesh())):
        assert TS.shard_hint(x, ("batch", "embed")) is x
    # a larger mesh places (test_torch_sharding_placement.py); rules that
    # describe one without its DeviceMesh cannot
    with TS.active_rules(TS.ShardingRules(_Mesh(*MESHES["16x16"]))):
        with pytest.raises(ValueError, match="DeviceMesh"):
            TS.shard_hint(x, ("batch", "embed"))
    with TS.active_rules(None):
        assert TS.shard_hint(x, ("batch",)) is x


def test_meshes():
    m = single_device_mesh()
    assert m.shape == {"data": 1, "model": 1} and m.axis_names == ("data", "model")
    assert make_mesh((2, 2), ("data", "model"), devices=list("abcd")).shape == \
        {"data": 2, "model": 2}
    with pytest.raises(ValueError, match="need 256 devices, have 1"):
        make_mesh((16, 16), ("data", "model"), devices=["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="need 512 devices"):
            make_production_mesh(multi_pod=True)


# -- input specs, optimizer-state axes ------------------------------------------


@pytest.mark.parametrize("shape_name", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_the_reference(arch, shape_name):
    ours = build_model(get_config(arch)).input_specs(SHAPES[shape_name])
    ref = ref_build_model(ref_configs.get_config(arch)).input_specs(
        ref_configs.SHAPES[shape_name])
    assert sorted(ours) == sorted(ref)
    for k, spec in ours.items():
        assert spec.shape == tuple(ref[k].struct.shape)
        assert str(spec.dtype).replace("torch.", "") == str(ref[k].struct.dtype)
        assert spec.logical_axes == ref[k].logical_axes
        assert spec.make("meta").shape == spec.shape


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "jamba-v0.1-52b", "rwkv6-3b"])
def test_optimizer_state_axes_match_the_reference(arch, factored):
    values, axes = _port_tree(arch)
    rvalues, raxes = _ref_tree(arch)
    ours = optimizer_state_axes(axes, OptimizerConfig(factored=factored), values)
    ref = ref_opt_axes(raxes, RefOptConfig(factored=factored), rvalues)
    assert _flat(ours) == _flat(ref)
    # the axes tree has the state's structure (the dry run resolves it)
    state = adamw_init(values, OptimizerConfig(factored=factored))
    specs = TS.ShardingRules(_Mesh(*MESHES["16x16"])).tree_specs(ours, state)
    assert len(tree_leaves(specs)) == len(tree_leaves(state))
