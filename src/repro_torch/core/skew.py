"""Skew generation and measurement (paper §4.1: Zipf 0 / 0.5 / 1.5 / 2).

PyTorch port of ``repro.core.skew`` (its numpy part, copied so the port
stands alone).  ``measure_skew`` summarizes a probe stream into a hashable
``SkewStats``, the planner input (``core/planner.py``): duplication factor,
hottest-key share, and the probe share the top-h hottest keys capture for a
fixed grid of h (how much a replicated hot table of size h would cover).

``measure_skew`` and ``top_keys`` take a numpy array or a tensor.  A
tensor is reduced to its ``(values, counts)`` pair on its own device
(``torch.bincount`` over its value range where that is no wider than the
tensor, else ``torch.unique``; at most the code space crosses to the
host), and the host finishes with the reference's numpy lines, so the
result is the same either way.  A host ``np.unique`` of a 60M-row FK
column takes seconds; a ``torch.unique`` of a 200M-row one holds sorted
copies of it, which the binned count never does (a re-measure runs inside
a fact append, beside the queries' own device memory).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# hot-table candidate sizes (entries) the planner may replicate; the
# top-share curve is measured exactly at these points
TOP_SHARE_GRID = (64, 256, 1024, 4096, 16384, 32768)

# a tensor whose keys span at most its length, and at most this many
# values, is counted in bins (8 bytes a value: 128 MiB at most), a chunk
# of this many keys at a time
BIN_MAX_SPAN = 1 << 24
BIN_CHUNK = 1 << 24


def zipf_weights(n: int, s: float) -> np.ndarray:
    """Normalized Zipf(s) pmf over ranks 1..n (s=0 -> uniform)."""
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** (-float(s))
    return w / w.sum()


def zipf_sample(n_keys: int, size: int, s: float, seed: int = 0,
                shuffle_ranks: bool = True) -> np.ndarray:
    """Sample ``size`` keys in [0, n_keys) with Zipf(s) popularity (the
    reference's numpy draws).  ``shuffle_ranks`` decouples popularity rank
    from key value (the hot key is not necessarily key 0)."""
    rng = np.random.default_rng(seed)
    w = zipf_weights(n_keys, s)
    keys = rng.choice(n_keys, size=size, p=w).astype(np.int32)
    if shuffle_ranks:
        perm = rng.permutation(n_keys).astype(np.int32)
        keys = perm[keys]
    return keys


@dataclasses.dataclass(frozen=True)
class SkewStats:
    """Hashable fact-side skew summary (host metadata on ``BuildStats``).

    ``top_share[i]`` is the fraction of the probe stream covered by the
    ``TOP_SHARE_GRID[i]`` hottest keys (1.0 once the grid point exceeds
    ``distinct``).
    """

    n: int
    distinct: int
    dup_factor: float
    max_share: float
    top_share: tuple[float, ...] = ()

    def coverage(self, h: int) -> float:
        """Probe share covered by the top-``h`` keys (grid step below)."""
        if h >= self.distinct:
            return 1.0
        share = 0.0
        for k, s in zip(TOP_SHARE_GRID, self.top_share):
            if k <= h:
                share = s
        return share


def _unique_counts(keys) -> tuple[np.ndarray, np.ndarray]:
    """Sorted distinct values and their counts, as host arrays."""
    if torch.is_tensor(keys):
        counted = _binned_counts(keys.reshape(-1))
        if counted is not None:
            return counted
        vals, counts = torch.unique(keys, sorted=True, return_counts=True)
        return vals.cpu().numpy(), counts.cpu().numpy()
    return np.unique(np.asarray(keys), return_counts=True)


def _binned_counts(keys: torch.Tensor):
    """``_unique_counts`` of an int32 or int64 tensor whose values span at
    most its length (and ``BIN_MAX_SPAN``): one bin a value, filled by
    ``torch.bincount`` ``BIN_CHUNK`` keys at a time, so that beside the
    bins it holds one chunk, where ``torch.unique`` holds sorted copies of
    the whole column.  None where the range is wider."""
    n = keys.numel()
    if n == 0 or keys.dtype not in (torch.int32, torch.int64):
        return None
    lo, hi = (int(v) for v in torch.aminmax(keys))
    span = hi - lo + 1
    if span > min(n, BIN_MAX_SPAN):
        return None
    bins = torch.zeros(span, dtype=torch.int64, device=keys.device)
    for s in range(0, n, BIN_CHUNK):
        bins += torch.bincount(keys[s:s + BIN_CHUNK] - lo, minlength=span)
    vals = torch.nonzero(bins).squeeze(1)
    counts = bins[vals]
    return (vals + lo).to(keys.dtype).cpu().numpy(), counts.cpu().numpy()


def measure_skew(keys) -> SkewStats:
    """Exact skew summary of a concrete probe stream."""
    n = int(keys.numel() if torch.is_tensor(keys) else np.asarray(keys).size)
    if n == 0:
        return SkewStats(n=0, distinct=0, dup_factor=1.0, max_share=0.0,
                         top_share=(0.0,) * len(TOP_SHARE_GRID))
    _, counts = _unique_counts(keys)
    counts = np.sort(counts)[::-1]
    cum = np.cumsum(counts, dtype=np.float64)
    top = tuple(float(cum[min(h, counts.size) - 1] / n)
                for h in TOP_SHARE_GRID)
    return SkewStats(n=n, distinct=int(counts.size),
                     dup_factor=float(n / counts.size),
                     max_share=float(counts[0] / n), top_share=top)


def top_keys(keys, h: int) -> np.ndarray:
    """The ``h`` hottest key values, hottest first (frequency descending,
    key value ascending as tiebreak); fewer than ``h`` distinct keys
    returns them all.  A host int32 array."""
    vals, counts = _unique_counts(keys)
    order = np.lexsort((vals, -counts))
    return vals[order[:h]].astype(np.int32)


def skew_stats(keys) -> dict:
    """Duplication factor, hottest-key share, distinct count (dict form)."""
    s = measure_skew(keys)
    return {"n": s.n, "distinct": s.distinct, "dup_factor": s.dup_factor,
            "max_share": s.max_share}
