"""Checkpoints (PyTorch port): atomic, integrity-checked tree snapshots."""
from repro_torch.checkpoint.manager import (CheckpointCorruptError,
                                            CheckpointManager, latest_step,
                                            load_arrays, restore, save, steps)

__all__ = ["CheckpointCorruptError", "CheckpointManager", "latest_step",
           "load_arrays", "restore", "save", "steps"]
