"""Z-set group aggregates: weighted multiset state for maintained views.

PyTorch port's copy of ``repro.ivm.zset`` (host numpy, no torch).  A Z-set
is a collection of records with integer weights: an appended fact row is
a record of weight ``+1``, a retracted contribution (a dimension delete
or re-point withdrawing a join match) the same record with weight ``-1``.
The SSB tail after the join is linear (filter, mask and segment sum
commute with adding inputs), so a maintained aggregate only ever adds
weighted contributions; it never re-reads rows it already absorbed.

Arithmetic follows the engine's wraparound: per-element measure ops in
int32 (wrapping), accumulation in int64, and the served answer the int64
sum cast to int32.  An int64 wrap (mod 2**64) keeps the served value (mod
2**32), so maintenance and recompute agree bit for bit at any length.
"""
from __future__ import annotations

import numpy as np


def wrap_i32(x: int) -> int:
    """Reduce an unbounded python-int accumulator to int32 two's
    complement: the value a ``.astype(np.int32)`` cast would serve."""
    x &= 0xFFFFFFFF
    return x - 0x100000000 if x >= 0x80000000 else x


class ZSetAggregate:
    """Per-group weighted sums for one GROUP BY shape.

    ``sums[g]`` accumulates ``weight * measure`` per dense composite group
    key, ``weights[g]`` the record multiplicity, the Z-set weight of group
    ``g``.  A group whose weight returns to zero has had all its
    contributions retracted and serves exactly 0 again.
    """

    __slots__ = ("sums", "weights")

    def __init__(self, size: int):
        self.sums = np.zeros(size, np.int64)
        self.weights = np.zeros(size, np.int64)

    def apply(self, gk: np.ndarray, measure: np.ndarray, w: int) -> None:
        """Absorb records with group keys ``gk``, int64 ``measure`` values
        and uniform weight ``w`` (+-1)."""
        np.add.at(self.sums, gk, np.int64(w) * measure)
        np.add.at(self.weights, gk, np.int64(w))

    def read(self) -> np.ndarray:
        """The served group vector: int32 wraparound of the sums."""
        return self.sums.astype(np.int32)

    def weights_i32(self) -> np.ndarray:
        """Group multiplicities as the int32 weights of the Z-set."""
        return self.weights.astype(np.int32)
