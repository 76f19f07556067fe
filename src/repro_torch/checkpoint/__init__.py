"""Checkpoint save/restore for zoo parameters and live engine state (the
reference's npz + JSON manifest format, readable by either package)."""
from repro_torch.checkpoint.ckpt import (CheckpointError, restore_checkpoint,
                                         save_checkpoint)

__all__ = ["save_checkpoint", "restore_checkpoint", "CheckpointError"]
