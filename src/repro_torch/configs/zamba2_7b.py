"""zamba2-7b [hybrid]: 81L d_model=3584 32H (kv=32) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention block
applied every 6 layers (13 sites + 3 tail Mamba layers).
[arXiv:2411.15242; unverified]"""

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.serving import on_fused_path
from repro_torch.core.energon_attention import EnergonConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    hybrid_attn_every=6,
    activation="swiglu",
    norm="rmsnorm",
    energon=EnergonConfig(impl="mpmrf_block", pruning_ratio=4.0),
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=7, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, ssm_state=16, ssm_head_dim=16,
        hybrid_attn_every=3, vocab_size=256, dtype="float32",
        remat="none",
        energon=EnergonConfig(impl="mpmrf_row", min_prune_layer=1),
    )


def serve() -> ModelConfig:
    """Full-width config with the fused kernels' Energon config. The
    hybrid serves from the contiguous cache (no chunked prefill): its
    shared block decodes through B5/B6 (head dim 112 on the d-128
    kernels, G = 1) wherever the planes are resident (``max_len`` ≥
    1024), and scores through B9/B10."""
    return on_fused_path(CONFIG)


def serve_smoke() -> ModelConfig:
    """Smoke widths on the fused path (planes resident at any length)."""
    return on_fused_path(smoke(), smoke=True)
