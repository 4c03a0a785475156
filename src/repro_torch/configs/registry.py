"""Architecture registry: ``--arch <id>`` resolution."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ModelConfig, SHAPES, ShapeConfig, applicable

_ARCH_MODULES = {
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
    "grok-1-314b": "repro_torch.configs.grok_1_314b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "whisper-base": "repro_torch.configs.whisper_base",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
}


def list_archs() -> List[str]:
    return sorted(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    return importlib.import_module(_ARCH_MODULES[name]).CONFIG


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def all_cells() -> List[dict]:
    """The full 40-cell (arch x shape) matrix with applicability flags."""
    cells = []
    for arch in list_archs():
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            ok, reason = applicable(cfg, shape)
            cells.append(
                {"arch": arch, "shape": sname, "runnable": ok, "skip_reason": reason}
            )
    return cells


__all__ = ["list_archs", "get_config", "get_shape", "all_cells", "SHAPES"]
