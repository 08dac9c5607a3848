"""Checkpointing for the port (``repro/checkpoint``): train states and
trees of tensors in ``repro``'s layout on disk. (``index_io`` follows with
ROADMAP Queue 1 item 7.)"""

from repro_torch.checkpoint.checkpoint import (
    all_steps,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "all_steps"]
