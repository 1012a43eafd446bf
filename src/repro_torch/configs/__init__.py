"""Architecture registry. ``repro_torch.configs.get("<arch>")`` / ``"<arch>:smoke"``."""
from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES,
    SUBQUADRATIC,
    ModelConfig,
    TrainConfig,
    cells,
    get,
    shape_of,
)

__all__ = [
    "ARCH_IDS",
    "ModelConfig",
    "SHAPES",
    "SUBQUADRATIC",
    "TrainConfig",
    "cells",
    "get",
    "shape_of",
]
