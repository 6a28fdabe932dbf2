"""Energon core: quantization, MP-MRF selection, attention dispatch."""

from repro_torch.core.energon_attention import (
    EnergonConfig,
    decode_live_budget,
    energon_attention,
    energon_decode_attention,
    energon_paged_decode_attention,
    energon_paged_prefill_attention,
)
from repro_torch.core.filtering import FilterResult, MPMRFConfig

__all__ = [
    "EnergonConfig",
    "FilterResult",
    "MPMRFConfig",
    "decode_live_budget",
    "energon_attention",
    "energon_decode_attention",
    "energon_paged_decode_attention",
    "energon_paged_prefill_attention",
]
