"""The fused paged kernels' serving configurations, shared by the dense
configs' ``serve()`` / ``serve_smoke()``.

The shipped ``mpmrf_block`` impl engages neither fused path. Fused
prefill further needs key_block == decode_key_block (one page per key
tile) and a query block dividing the folded chunk rows G·C: a query
block of 128 divides G·128 for every G.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.core.energon_attention import EnergonConfig

SERVE_ENERGON = EnergonConfig(
    impl="pallas", pruning_ratio=4.0, key_block=64, decode_key_block=64,
    query_block=128,
)
#: smoke widths: key/page blocks of 16, a query block of 16 and planes
#: resident at any length
SERVE_SMOKE_ENERGON = EnergonConfig(
    impl="pallas", pruning_ratio=4.0, key_block=16, decode_key_block=16,
    query_block=16, filter_cache_min_len=0,
)


def on_fused_path(cfg: ModelConfig, smoke: bool = False) -> ModelConfig:
    """``cfg`` with the fused paged kernels' Energon config."""
    return dataclasses.replace(
        cfg, energon=SERVE_SMOKE_ENERGON if smoke else SERVE_ENERGON)
