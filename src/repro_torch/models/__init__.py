"""Models of the port (the dense family over the paged cache)."""

from repro_torch.models.model import LMModel

__all__ = ["LMModel"]
