"""Gradient compression: QSGD-style int8 with error feedback.

PyTorch port of ``repro.optim.compress``'s one-device part.  The
quantize -> dequantize pair models the numerics of a compressed
data-parallel all-reduce end to end, with the quantization residual
carried forward (error feedback) so the training trajectory stays
unbiased.  The explicit collective, ``psum_compressed``, comes with the
multi-process slice (ROADMAP Queue 1 item 2d).
"""
from __future__ import annotations

import torch

from repro_torch.checkpoint.manager import _unflatten
from repro_torch.optim.adamw import _dequant, _quant, walk


def feedback(g: torch.Tensor, e: torch.Tensor, bits: int = 8
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One leaf (or leading slice): int8-quantize ``g + e``; returns
    (dequantized, new residual)."""
    if bits != 8:
        raise ValueError(f"int8 only, not {bits} bits")
    g = g.to(torch.float32) + e
    q, s = _quant(g)
    deq = _dequant(q, s, g.shape)
    return deq, g - deq


def quantize_with_feedback(grads, err, bits: int = 8):
    """int8-quantize grads + residual; returns (dequantized, new_residual),
    trees shaped like ``grads``."""
    deq, res = zip(*(feedback(g, e, bits) for g, e in walk(grads, err)))
    return _unflatten(grads, iter(deq)), _unflatten(grads, iter(res))
