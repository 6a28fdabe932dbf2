"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]"""

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.serving import on_fused_path
from repro_torch.core.energon_attention import EnergonConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,                 # per-expert hidden dim
    vocab_size=151936,
    num_experts=128,
    experts_per_token=8,
    use_qk_norm=True,
    rope_theta=1_000_000.0,
    activation="swiglu",
    norm="rmsnorm",
    energon=EnergonConfig(impl="mpmrf_block", pruning_ratio=4.0),
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=64, num_heads=8, num_kv_heads=2,
        head_dim=16, d_ff=48, vocab_size=256, num_experts=8,
        experts_per_token=2, dtype="float32", remat="none",
        energon=EnergonConfig(impl="mpmrf_row", min_prune_layer=1),
    )


def serve() -> ModelConfig:
    """Full-width config on the fused paged serving path (G = 16). Its
    ≈ 235 B parameters do not fit one card."""
    return on_fused_path(CONFIG)


def serve_smoke() -> ModelConfig:
    """Smoke widths on the fused paged path (G = 4)."""
    return on_fused_path(smoke(), smoke=True)
