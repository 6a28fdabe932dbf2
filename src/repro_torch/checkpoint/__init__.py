"""Checkpoints of the port: atomic, async, the reference's layout (port
of ``repro.checkpoint``)."""

from repro_torch.checkpoint.checkpointer import (
    AsyncCheckpointer,
    list_checkpoints,
    restore_latest,
    retain,
    save_checkpoint,
    step_dir,
)

__all__ = [
    "AsyncCheckpointer",
    "list_checkpoints",
    "restore_latest",
    "retain",
    "save_checkpoint",
    "step_dir",
]
