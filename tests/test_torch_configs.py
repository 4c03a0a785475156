"""The port's configs and Runtime against the reference package's, field
for field."""
import dataclasses

import pytest
import torch

import repro.configs as ref_configs
import repro_torch.configs as port_configs
from repro.models.runtime import CPU_TEST as REF_CPU_TEST
from repro.models.runtime import REMAT_MODES as REF_REMAT_MODES
from repro.models.runtime import Runtime as RefRuntime
from repro_torch.models.runtime import CPU_TEST, REMAT_MODES, Runtime

ARCHS = ref_configs.list_archs()


def test_same_arch_list():
    assert port_configs.list_archs() == ARCHS and len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch):
    a, b = port_configs.get_config(arch), ref_configs.get_config(arch)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert type(a).__module__.startswith("repro_torch.")
    assert a.padded_vocab == b.padded_vocab
    assert a.layer_plan() == b.layer_plan() and a.layer_period() == b.layer_period()
    assert a.param_counts() == b.param_counts()


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_config_equals_reference(arch):
    a = port_configs.get_config(arch).reduced()
    b = ref_configs.get_config(arch).reduced()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_shapes_and_cells_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in port_configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}
    assert port_configs.all_cells() == ref_configs.all_cells()
    with pytest.raises(KeyError):
        port_configs.get_config("no-such-arch")


def test_runtime_defaults_equal_reference():
    assert dataclasses.asdict(Runtime()) == dataclasses.asdict(RefRuntime())
    assert dataclasses.asdict(CPU_TEST) == dataclasses.asdict(REF_CPU_TEST)
    assert REMAT_MODES == REF_REMAT_MODES
    assert Runtime().dtype() is torch.bfloat16
    assert Runtime(compute_dtype="f32").dtype() is torch.float32
    hash(Runtime())  # frozen + hashable


def test_runtime_validates_remat_and_attn_impl():
    for mode in REMAT_MODES:
        assert Runtime(remat=mode).remat == mode
    with pytest.raises(ValueError, match="remat"):
        Runtime(remat="some")
    for impl in ("ref", "chunked", "cuda"):
        assert Runtime(attn_impl=impl).attn_impl == impl
    with pytest.raises(ValueError, match="cuda"):
        Runtime(attn_impl="pallas")
    with pytest.raises(ValueError):
        Runtime(attn_impl="triton")
