"""Materialized SSB views: one maintained ``(total, groups)`` per QuerySpec.

PyTorch port's copy of ``repro.ivm.views`` (host numpy).  A
:class:`QueryView` holds the Z-set state of one SSB query and absorbs
weighted row batches prepared by the maintenance layer (mask, int64
measure, dense composite group key).  ``result()`` serves the shape the
engine's queries return, the no-group convention included
(``total, [total]``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.ivm.zset import ZSetAggregate, wrap_i32


class _Cols:
    """Dict-of-columns stand-in accepted by the query-spec lambdas."""

    __slots__ = ("_cols",)

    def __init__(self, cols):
        self._cols = cols

    def __getitem__(self, name):
        return self._cols[name]


class QueryView:
    """Maintained state for one SSB query (one materialized view)."""

    __slots__ = ("spec", "total", "count", "zset")

    def __init__(self, spec):
        self.spec = spec
        self.total = 0   # unbounded python int; served mod 2**32
        self.count = 0   # Z-set weight of the view's record multiset
        size = 1
        for _, _, card in spec.group_by:
            size *= card
        self.zset = ZSetAggregate(size) if spec.group_by else None

    def apply(self, mask: np.ndarray, measure: np.ndarray,
              gk: np.ndarray | None, w: int) -> None:
        """Absorb a weighted row batch (weight ``w`` = +-1).  ``measure``
        is int64 (cast after the int32 per-element ops), ``gk`` the dense
        int64 composite group key, or None for a no-group view."""
        sel = measure[mask]
        self.total += w * int(sel.sum())
        self.count += w * int(np.count_nonzero(mask))
        if self.zset is not None:
            self.zset.apply(gk[mask], sel, w)

    def result(self) -> tuple[int, np.ndarray]:
        """The served answer, bit-identical to full re-execution."""
        t = wrap_i32(self.total)
        if self.zset is None:
            return t, np.asarray([t], np.int32)
        return t, self.zset.read()
