"""Optimizer (PyTorch port of ``repro.optim``): AdamW with float32 or
blockwise-int8 moments, and int8 gradient compression with error
feedback."""
from repro_torch.optim.adamw import (OptConfig, apply_updates, global_norm,
                                     init_opt_state, schedule)
from repro_torch.optim.compress import quantize_with_feedback

__all__ = ["OptConfig", "apply_updates", "global_norm", "init_opt_state",
           "schedule", "quantize_with_feedback"]
