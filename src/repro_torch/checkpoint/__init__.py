"""Checkpointing for the port (``repro/checkpoint``): train states and trees
of tensors in ``repro``'s layout on disk, and index persistence
(``index_io``: a ``HybridIndex`` or ``SegmentPool`` saved by either package
loads into the other)."""

from repro_torch.checkpoint.checkpoint import (
    all_steps,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.checkpoint.index_io import (
    load_index,
    load_ingest,
    load_pool,
    save_index,
    save_pool,
)

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "all_steps",
    "save_index",
    "load_index",
    "load_ingest",
    "save_pool",
    "load_pool",
]
