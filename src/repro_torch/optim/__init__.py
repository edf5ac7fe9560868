"""Optimizer (PyTorch port of ``repro.optim``): AdamW with float32 or
blockwise-int8 moments, int8 gradient compression with error feedback,
and the compressed all-reduce over a mesh axis."""
from repro_torch.optim.adamw import (OptConfig, apply_updates, global_norm,
                                     init_opt_state, schedule)
from repro_torch.optim.compress import psum_compressed, quantize_with_feedback

__all__ = ["OptConfig", "apply_updates", "global_norm", "init_opt_state",
           "schedule", "psum_compressed", "quantize_with_feedback"]
