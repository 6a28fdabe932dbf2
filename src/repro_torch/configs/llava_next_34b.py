"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling frontend (a stub: ``embeddings`` inputs are
precomputed patch embeddings, ``repro_torch.models.multimodal``).
Backbone ≈ Yi-34B decoder. [hf:llava-hf/llava-v1.6-mistral-7b-hf;
unverified]"""

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.serving import on_fused_path
from repro_torch.core.energon_attention import EnergonConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5_000_000.0,
    activation="swiglu",
    norm="rmsnorm",
    frontend="vision",
    energon=EnergonConfig(impl="mpmrf_block", pruning_ratio=4.0),
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=112, num_heads=7, num_kv_heads=1,
        head_dim=16, d_ff=224, vocab_size=256, dtype="float32",
        remat="none",
        energon=EnergonConfig(impl="mpmrf_row", min_prune_layer=1),
    )


def serve() -> ModelConfig:
    """Full-width config on the fused paged serving path (G = 7: 896
    folded rows a chunk of 128). Its ≈ 34 B parameters (≈ 69 GB in
    bf16) leave a card of 80 GB no room to serve at full depth."""
    return on_fused_path(CONFIG)


def serve_smoke() -> ModelConfig:
    """Smoke widths on the fused paged path (G = 7)."""
    return on_fused_path(smoke(), smoke=True)
