from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    PeftConfig,
    ShapeConfig,
    TrainConfig,
    cell_is_runnable,
)
from repro_torch.configs.registry import (
    ARCH_IDS,
    PAPER_ARCH_IDS,
    all_cells,
    get_config,
    reduced,
)

__all__ = [
    "ARCH_IDS",
    "PAPER_ARCH_IDS",
    "SHAPES",
    "ModelConfig",
    "PeftConfig",
    "ShapeConfig",
    "TrainConfig",
    "all_cells",
    "cell_is_runnable",
    "get_config",
    "reduced",
]
