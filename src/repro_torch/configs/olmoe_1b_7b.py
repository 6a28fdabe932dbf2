"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (GQA kv=16) d_ff=1024
vocab=50304, MoE 64 experts top-8. [arXiv:2409.02060; hf]"""

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.serving import on_fused_path
from repro_torch.core.energon_attention import EnergonConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,                 # per-expert hidden dim
    vocab_size=50304,
    num_experts=64,
    experts_per_token=8,
    use_qk_norm=True,
    activation="swiglu",
    norm="rmsnorm",
    energon=EnergonConfig(impl="mpmrf_block", pruning_ratio=4.0),
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=32, vocab_size=256, num_experts=8,
        experts_per_token=2, dtype="float32", remat="none",
        energon=EnergonConfig(impl="mpmrf_row", min_prune_layer=1),
    )


def serve() -> ModelConfig:
    """Full-width config on the fused paged serving path (MHA: G = 1)."""
    return on_fused_path(CONFIG)


def serve_smoke() -> ModelConfig:
    """Smoke widths on the fused paged path."""
    return on_fused_path(smoke(), smoke=True)
