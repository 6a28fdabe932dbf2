"""Architecture registry: ``--arch <id>`` resolution for the launchers.

Only the archs this port serves are registered. ``get_config`` returns
the shipped config; ``get_serve_config`` the one with the fused paged
Energon kernels engaged (the path the port implements).
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs import qwen3_14b
from repro_torch.configs.base import ModelConfig

_MODULES = {
    "qwen3-14b": qwen3_14b,
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
