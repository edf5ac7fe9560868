"""Probe-stream deduplication: the RLU "coalescing window", generalized.

PyTorch port of ``repro.core.dedup``.  JSPIM's RLU carries an 8-entry
optimization buffer that filters duplicate probe keys within a sliding
window, so a repeated fact key costs one row activation instead of N.
``coalesce`` generalizes it: a fixed-capacity ``unique`` (sort + boundary
scan) coalesces every duplicate of a probe block, and an inverse index (the
duplication-list analogue) rebuilds the full stream after the lookup.
``windowed_coalesce_mask`` is the faithful windowed model, and the plain
version of the ``coalesce_window_mask`` kernel.

The unique capacity is fixed and overflow is reported, mirroring the fixed
geometry of the PIM hash table.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Coalesced(NamedTuple):
    unique: torch.Tensor    # (capacity,) int32 unique keys, ``pad`` padded
    inverse: torch.Tensor   # (m,) int32 index into ``unique`` per probe
    n_unique: torch.Tensor  # () int32
    overflow: torch.Tensor  # () bool: capacity was insufficient


def coalesce(keys: torch.Tensor, capacity: int, pad: int = -1) -> Coalesced:
    """Fixed-capacity ``unique`` + inverse indices over a 1-D key stream."""
    keys = keys.to(torch.int32)
    m = keys.shape[0]
    dev = keys.device
    sk, order = torch.sort(keys, stable=True)
    is_first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          sk[1:] != sk[:-1]])
    # the reference's cumsum is int32; torch's is int64
    uid = torch.cumsum(is_first, 0).to(torch.int32) - 1
    n_unique = is_first.sum().to(torch.int32)
    # the reference's scatter with mode="drop": every element that is not a
    # group head within capacity lands in one trailing slot, sliced off
    slot = torch.where(is_first & (uid < capacity), uid, capacity).long()
    unique = torch.full((capacity + 1,), pad, dtype=torch.int32, device=dev)
    unique[slot] = sk
    # ``order`` is a permutation: a plain scatter, no collisions
    inverse = torch.empty(m, dtype=torch.int32, device=dev)
    inverse[order] = uid.clamp(max=capacity - 1)
    return Coalesced(unique[:capacity], inverse, n_unique,
                     n_unique > capacity)


def scatter_back(unique_results: torch.Tensor,
                 inverse: torch.Tensor) -> torch.Tensor:
    """Rebuild per-probe results from per-unique results (any trailing
    dims)."""
    return unique_results[inverse.long()]


def windowed_coalesce_mask(keys: torch.Tensor,
                           window: int = 8) -> torch.Tensor:
    """Faithful RLU window model: True where a probe is filtered because an
    identical key already appeared within the previous ``window - 1``
    probes (the paper's 8-entry optimization buffer).

    A position before the stream's start holds nothing and never matches.
    The reference's two versions pre-pad with a sentinel instead (the
    oracle with -1, the Pallas kernel with -0x7FFFFFFE), so they disagree
    with each other on streams that open with one of those keys, and the
    oracle raises on a stream shorter than ``window - 1``; on every other
    stream all three agree.
    """
    keys = keys.to(torch.int32)
    m = keys.shape[0]
    hit = torch.zeros(m, dtype=torch.bool, device=keys.device)
    for d in range(1, min(window, m)):
        hit[d:] |= keys[d:] == keys[:-d]
    return hit


def duplication_factor(keys: torch.Tensor) -> torch.Tensor:
    """Stream length / distinct keys, the skew statistic the paper exploits
    (a float32 scalar, as the reference's)."""
    sk = torch.sort(keys.to(torch.int32)).values
    n_unique = 1 + (sk[1:] != sk[:-1]).sum()
    return keys.shape[0] / n_unique.to(torch.float32)
