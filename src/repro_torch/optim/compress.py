"""Gradient compression: QSGD-style int8 with error feedback, and the
compressed all-reduce over a mesh axis.

PyTorch port of ``repro.optim.compress``.  The quantize -> dequantize
pair models the numerics of a compressed data-parallel all-reduce end to
end, with the quantization residual carried forward (error feedback) so
the training trajectory stays unbiased.  ``psum_compressed`` is the
explicit collective, over the regions of one mesh axis on one device.
"""
from __future__ import annotations

import torch

from repro_torch.checkpoint.manager import _unflatten
from repro_torch.launch.mesh import ShardMesh
from repro_torch.optim.adamw import (SLICE_ELEMS, _dequant, _quant,
                                     tree_map, walk)


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


def _psum_one(g: torch.Tensor) -> torch.Tensor:
    """The reference's per-shard arithmetic over the stacked regions
    ``g[r]``: int8 ``_quant`` per 256-element block, the shared scale the
    max over regions (its ``pmax``), requantize against it, an exact
    int32 sum over regions, dequantize.  Every region gets the sum."""
    n = g.shape[0]
    q, s = _quant(g.to(torch.float32))
    s_max = s.amax(dim=0)
    # requantize against the shared scale, then exact int32 sum
    deq = q.to(torch.float32) * s                    # blocked layout
    q2 = torch.round(deq / torch.clamp_min(s_max, 1e-20)).to(torch.int32)
    total = q2.sum(dim=0, dtype=torch.int32)
    x = total.to(torch.float32) * s_max
    *lead, nb, qb = x.shape
    x = x.reshape(*lead, nb * qb)[..., :g.shape[-1]].reshape(g.shape[1:])
    return x.expand(n, *x.shape)


def psum_compressed(tree, axis_name: str, mesh: ShardMesh):
    """Explicit compressed all-reduce over ``axis_name``: int8 quantize ->
    sum -> dequantize.

    Convention: every leaf stacks the regions of ``axis_name`` on its
    first dimension, ``leaf[r]`` being region ``r``'s value (the block
    the reference's ``shard_map`` hands shard ``r``), so that dimension
    has ``mesh.shape[axis_name]`` entries.  The result is a tree of
    float32 leaves of the same shapes in which every region holds the
    reduced value.  Scales are reduced with a max (conservative) so the
    int32 accumulation cannot overflow the shared exponent; values are
    summed exactly in int32.  A leaf is reduced a slice of its rows (the
    dimensions between the first and the last, flattened) at a time:
    blocks lie along the last dimension, so the arithmetic is the same.
    """
    n = mesh.shape[axis_name]

    def one(g: torch.Tensor) -> torch.Tensor:
        if g.dim() < 2 or g.shape[0] != n:
            raise ValueError(f"a leaf of shape {tuple(g.shape)} does not "
                             f"stack the {n} regions of {axis_name!r}")
        rows = g.reshape(n, -1, g.shape[-1])
        out = torch.empty(rows.shape, dtype=torch.float32, device=g.device)
        step = max(1, SLICE_ELEMS // (n * g.shape[-1]))
        for i in range(0, rows.shape[1], step):
            out[:, i:i + step] = _psum_one(rows[:, i:i + step])
        return out.view(g.shape)

    return tree_map(one, tree)
