"""Model configuration schema and the shape matrix (a copy of
``repro.configs.base``).

One frozen dataclass describes an architecture; ``configs/<arch>.py``
instantiates it with the published hyperparameters, plus a ``smoke()``
reduction used by CPU tests. :class:`ShapeConfig` is one input-shape
cell of the (arch × shape) matrix that ``launch/dryrun.py`` lowers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.energon_attention import EnergonConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 ⇒ d_model // num_heads
    norm: str = "rmsnorm"
    activation: str = "swiglu"
    rope_theta: float = 10000.0
    use_qk_norm: bool = False
    # gemma-style local:global pattern — every `global_every`-th layer is
    # global, the rest use `sliding_window`; 0 ⇒ all layers global.
    sliding_window: int = 0
    global_every: int = 0
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    moe_quantized_gather: bool = False
    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    xlstm_group: Tuple[int, int] = (0, 0)
    hybrid_attn_every: int = 0
    # modality
    frontend: Optional[str] = None
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: str = "full"
    energon: EnergonConfig = dataclasses.field(default_factory=EnergonConfig)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError("num_heads must be divisible by num_kv_heads")

    @property
    def uses_embeddings_input(self) -> bool:
        return self.family in ("vlm", "audio")

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell of the benchmark matrix."""

    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)

# long_500k is only runnable for sub-quadratic archs (see DESIGN.md §5).
LONG_CONTEXT_ARCHS = ("xlstm-1.3b", "zamba2-7b", "gemma3-27b")


def shapes_for_arch(arch_name: str):
    shapes = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if arch_name in LONG_CONTEXT_ARCHS:
        shapes.append(LONG_500K)
    return tuple(shapes)
