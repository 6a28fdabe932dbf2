"""qwen3-14b [dense]: 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936 — qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]"""

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.core.energon_attention import EnergonConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    use_qk_norm=True,
    rope_theta=1_000_000.0,
    activation="swiglu",
    norm="rmsnorm",
    energon=EnergonConfig(impl="mpmrf_block", pruning_ratio=4.0),
)

# The fused paged kernels' serving configuration. The shipped
# ``mpmrf_block`` impl engages neither fused path; fused prefill further
# needs key_block == decode_key_block (one page per key tile) and a
# query block dividing the folded chunk rows G·C (G = 5).
SERVE_ENERGON = EnergonConfig(
    impl="pallas", pruning_ratio=4.0, key_block=64, decode_key_block=64,
    query_block=128,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=128, num_heads=8, num_kv_heads=2,
        head_dim=16, d_ff=256, vocab_size=256, dtype="float32",
        remat="none",
        energon=EnergonConfig(impl="mpmrf_row", min_prune_layer=1),
    )


def serve() -> ModelConfig:
    """Full-width config on the fused paged serving path."""
    return dataclasses.replace(CONFIG, energon=SERVE_ENERGON)


def serve_smoke() -> ModelConfig:
    """Smoke widths on the fused paged path: key/page blocks of 16, a
    query block of 16 and planes resident at any length."""
    return dataclasses.replace(
        smoke(),
        energon=EnergonConfig(
            impl="pallas", pruning_ratio=4.0, key_block=16,
            decode_key_block=16, query_block=16, filter_cache_min_len=0,
        ),
    )
