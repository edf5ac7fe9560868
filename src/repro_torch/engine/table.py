"""Column-store tables (§3.2.1: "JSPIM adopts a column-store approach").

PyTorch port of ``repro.engine.table`` without the fact-side capacity
tail: a relation is a dict of equal-length int32 column tensors on one
device, and ``append`` grows it by whole rows (dimension ingest).  The
capacity tail (``append_tail``, ``pad_batch``) waits for the fact-append
slice.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another.  Raises ``RuntimeError`` when the card is asked for (or
    implied) and there is none: the port never falls back to the CPU on
    its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass
class Table:
    """An integer column-store relation."""

    columns: Mapping[str, torch.Tensor]  # name -> (n_rows,) int32

    def __post_init__(self):
        lens = {k: v.shape[0] for k, v in self.columns.items()}
        if len(set(lens.values())) != 1:
            raise ValueError(f"ragged columns: {lens}")

    @property
    def n_rows(self) -> int:
        return next(iter(self.columns.values())).shape[0]

    @property
    def device(self) -> torch.device:
        return next(iter(self.columns.values())).device

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def names(self):
        return list(self.columns.keys())

    @staticmethod
    def from_numpy(cols: Mapping[str, np.ndarray], device) -> "Table":
        # "W": torch refuses read-only arrays (those are copied once)
        return Table({k: torch.as_tensor(np.require(v, np.int32, "W"),
                                         device=device)
                      for k, v in cols.items()})

    def append(self, cols: Mapping[str, torch.Tensor | np.ndarray]
               ) -> "Table":
        """A new Table with ``cols`` rows appended; ``cols`` must cover
        exactly this table's columns, with equal lengths."""
        if set(cols) != set(self.columns):
            raise ValueError(f"column mismatch: {sorted(cols)} vs "
                             f"{sorted(self.columns)}")
        dev = self.device
        new = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                  else v, device=dev).to(torch.int32)
               for k, v in cols.items()}
        lens = {k: v.shape[0] for k, v in new.items()}
        if len(set(lens.values())) != 1:
            raise ValueError(f"ragged append: {lens}")
        return Table({k: torch.cat([v, new[k]])
                      for k, v in self.columns.items()})

    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size()
                   for v in self.columns.values())
