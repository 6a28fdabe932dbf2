"""xlstm-1.3b [ssm]: 48L d_model=2048 4H d_ff=0 vocab=50304 —
sLSTM + mLSTM blocks, 7:1 mLSTM:sLSTM grouping (xLSTM[7:1]).
Attention-free: Energon MP-MRF does not apply.
[arXiv:2405.04517; unverified]"""

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.core.energon_attention import EnergonConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    head_dim=512,
    vocab_size=50304,
    xlstm_group=(7, 1),
    norm="rmsnorm",
    energon=EnergonConfig(impl="dense"),   # no attention layers
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, vocab_size=256, xlstm_group=(3, 1),
        dtype="float32", remat="none",
    )


def serve() -> ModelConfig:
    """The shipped config: no attention, so no kernel to engage."""
    return CONFIG


def serve_smoke() -> ModelConfig:
    return smoke()
