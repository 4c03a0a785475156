from repro_torch.configs.base import (
    MLAConfig,
    MambaConfig,
    ModelConfig,
    MoEConfig,
    RWKVConfig,
    SHAPES,
    ShapeConfig,
    applicable,
)
from repro_torch.configs.registry import all_cells, get_config, get_shape, list_archs

__all__ = [
    "MLAConfig",
    "MambaConfig",
    "ModelConfig",
    "MoEConfig",
    "RWKVConfig",
    "SHAPES",
    "ShapeConfig",
    "applicable",
    "all_cells",
    "get_config",
    "get_shape",
    "list_archs",
]
