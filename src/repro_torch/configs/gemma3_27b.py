"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144 — 5:1 local:global sliding windows, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.serving import on_fused_path
from repro_torch.core.energon_attention import EnergonConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    use_qk_norm=True,
    rope_theta=1_000_000.0,
    activation="geglu",
    norm="rmsnorm",
    sliding_window=1024,
    global_every=6,          # 5 local : 1 global
    tie_embeddings=True,
    energon=EnergonConfig(impl="mpmrf_block", pruning_ratio=4.0),
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=6, d_model=96, num_heads=6, num_kv_heads=3,
        head_dim=16, d_ff=192, vocab_size=256, sliding_window=16,
        dtype="float32", remat="none",
        energon=EnergonConfig(impl="mpmrf_row", min_prune_layer=1),
    )


def serve() -> ModelConfig:
    """Full-width config on the fused paged serving path (G = 2: 256
    folded rows a chunk of 128). The windowed layers take the XLA
    paths: the fused kernels take no window."""
    return on_fused_path(CONFIG)


def serve_smoke() -> ModelConfig:
    """Smoke widths on the fused paged path."""
    return on_fused_path(smoke(), smoke=True)
