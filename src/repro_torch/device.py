"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another. Asking for CUDA on a host without a GPU raises — the
    port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU"
        )
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued device work (a no-op on the CPU), so a host clock
    read afterwards measures device time, not enqueue time."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
