"""phi3-mini-3.8b [dense]: 32L d_model=3072 32H (GQA kv=32) d_ff=8192
vocab=32064 — RoPE SwiGLU MHA. [arXiv:2404.14219; unverified]"""

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.serving import on_fused_path
from repro_torch.core.energon_attention import EnergonConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=10_000.0,
    activation="swiglu",
    norm="rmsnorm",
    energon=EnergonConfig(impl="mpmrf_block", pruning_ratio=4.0),
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=256, dtype="float32",
        remat="none",
        energon=EnergonConfig(impl="mpmrf_row", min_prune_layer=1),
    )


def serve() -> ModelConfig:
    """Full-width config on the fused paged serving path (MHA: G = 1;
    head dim 96, which the kernels run on their d-128 instantiation)."""
    return on_fused_path(CONFIG)


def serve_smoke() -> ModelConfig:
    """Smoke widths (head dim 16) on the fused paged path."""
    return on_fused_path(smoke(), smoke=True)
