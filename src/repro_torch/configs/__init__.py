"""Model configurations (copies of ``repro.configs`` for the ported archs)
and the shape matrix."""

from repro_torch.configs.base import (
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    LONG_CONTEXT_ARCHS,
    PREFILL_32K,
    TRAIN_4K,
    ModelConfig,
    ShapeConfig,
    shapes_for_arch,
)

__all__ = [
    "ALL_SHAPES",
    "DECODE_32K",
    "LONG_500K",
    "LONG_CONTEXT_ARCHS",
    "PREFILL_32K",
    "TRAIN_4K",
    "ModelConfig",
    "ShapeConfig",
    "shapes_for_arch",
]
