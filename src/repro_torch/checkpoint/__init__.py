"""Atomic, checksummed, async checkpoints (port of ``repro/checkpoint``)."""
from repro_torch.checkpoint.checkpointer import (
    CheckpointCorruptError,
    Checkpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = [
    "CheckpointCorruptError",
    "Checkpointer",
    "latest_step",
    "restore_checkpoint",
    "save_checkpoint",
]
