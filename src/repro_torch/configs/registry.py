"""Architecture registry: ``--arch <id>`` resolution for the launchers.

Every arch of the reference is registered. ``get_config`` returns the
shipped config; ``get_serve_config`` the serving one, with the fused
Energon kernels engaged (xlstm-1.3b, attention-free, serves its shipped
config).
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs import (
    gemma3_27b, llava_next_34b, musicgen_medium, olmoe_1b_7b,
    phi3_mini_3_8b, qwen3_14b, qwen3_moe_235b_a22b, starcoder2_7b,
    xlstm_1_3b, zamba2_7b,
)
from repro_torch.configs.base import ModelConfig

_MODULES = {
    "qwen3-14b": qwen3_14b,
    "starcoder2-7b": starcoder2_7b,
    "gemma3-27b": gemma3_27b,
    "phi3-mini-3.8b": phi3_mini_3_8b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b,
    "llava-next-34b": llava_next_34b,
    "musicgen-medium": musicgen_medium,
    "zamba2-7b": zamba2_7b,
    "xlstm-1.3b": xlstm_1_3b,
}

ARCH_NAMES = tuple(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return _MODULES[name]


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke()


def get_serve_config(name: str, smoke: bool = False) -> ModelConfig:
    mod = _module(name)
    return mod.serve_smoke() if smoke else mod.serve()


def all_configs() -> Dict[str, ModelConfig]:
    return {name: mod.CONFIG for name, mod in _MODULES.items()}
