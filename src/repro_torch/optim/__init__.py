"""Optimizer of the port: AdamW, schedules and accumulation (port of
``repro.optim``)."""

from repro_torch.optim.adamw import (
    AdamWConfig,
    AdamWState,
    accumulate_gradients,
    clip_by_global_norm,
    global_norm,
    init,
    update,
    warmup_cosine,
)

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "accumulate_gradients",
    "clip_by_global_norm",
    "global_norm",
    "init",
    "update",
    "warmup_cosine",
]
