"""Model configurations (copies of ``repro.configs`` for the ported archs)."""

from repro_torch.configs.base import ModelConfig

__all__ = ["ModelConfig"]
