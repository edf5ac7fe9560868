"""Paged KV-cache with a JSPIM page table.

PyTorch port of ``repro.serve.paged_kv``.  The page table maps (sequence,
logical_page) -> physical page — a select-where(=) query.  It is kept as a
JSPIM hash table (unique keys by construction: one physical page per
logical page, Fibonacci-hashed, 128-lane buckets), so page resolution is a
single O(1) associative probe regardless of pool occupancy or sequence-
length skew across the batch.  Allocation/free are the paper's
entry/index update commands.  The probe is the port's plain ``core.probe``:
the reference's is its XLA path, not a Pallas kernel.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import build_table, probe, suggest_num_buckets
from repro_torch.core.hash_table import HASH_FIBONACCI, JSPIMTable
from repro_torch.engine.table import resolve_device


def _key(seq_id, page_idx, max_pages: int):
    return seq_id * max_pages + page_idx


@dataclasses.dataclass
class PageTable:
    """Host-managed allocator + device-resident JSPIM lookup table, on the
    card unless ``device`` names another."""

    n_physical: int
    max_pages_per_seq: int
    bucket_width: int = 128
    device: torch.device | str | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._free = list(range(self.n_physical))[::-1]
        self._map: dict[int, int] = {}   # logical key -> physical page
        self._dirty = True
        self._table: JSPIMTable | None = None

    # -- update commands (§3.2.3) -----------------------------------------
    def alloc(self, seq_id: int, page_idx: int) -> int:
        if not self._free:
            raise RuntimeError("page pool exhausted")
        phys = self._free.pop()
        self._map[_key(seq_id, page_idx, self.max_pages_per_seq)] = phys
        self._dirty = True
        return phys

    def free_seq(self, seq_id: int):
        base = seq_id * self.max_pages_per_seq
        for k in [k for k in self._map
                  if base <= k < base + self.max_pages_per_seq]:
            self._free.append(self._map.pop(k))
        self._dirty = True

    # -- select-where(=) lookups -------------------------------------------
    def table(self) -> JSPIMTable:
        """The JSPIM table, rebuilt only after an allocation or a free."""
        if self._dirty:
            keys = np.fromiter(self._map.keys(), np.int32,
                               count=len(self._map))
            vals = np.fromiter(self._map.values(), np.int32,
                               count=len(self._map))
            if keys.size == 0:
                keys = np.array([0], np.int32)
                vals = np.array([0], np.int32)
            nb = suggest_num_buckets(max(len(self._map), 1),
                                     self.bucket_width)
            self._table = build_table(
                torch.from_numpy(keys).to(self.device),
                torch.from_numpy(vals).to(self.device), num_buckets=nb,
                bucket_width=self.bucket_width, hash_mode=HASH_FIBONACCI)
            self._dirty = False
        return self._table

    def lookup(self, seq_ids, page_idxs) -> tuple[torch.Tensor, torch.Tensor]:
        """Batch page resolution: one associative probe.  Returns (found,
        physical page); an unallocated or freed page misses."""
        seq_ids = torch.as_tensor(seq_ids, device=self.device)
        page_idxs = torch.as_tensor(page_idxs, device=self.device)
        keys = _key(seq_ids.to(torch.int32), page_idxs.to(torch.int32),
                    self.max_pages_per_seq)
        pr = probe(self.table(), keys)
        return pr.found, pr.payload
