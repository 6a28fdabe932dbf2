"""Model configuration schema (a copy of ``repro.configs.base``).

One frozen dataclass describes an architecture; ``configs/<arch>.py``
instantiates it with the published hyperparameters, plus a ``smoke()``
reduction used by CPU tests.
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
