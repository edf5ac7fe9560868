"""Column-store tables (§3.2.1: "JSPIM adopts a column-store approach").

PyTorch port of ``repro.engine.table``.  A relation is a dict of
equal-length int32 column tensors on one device.  Two growth paths:

* ``append`` -- exact-shape concatenation (dimension ingest).
* ``append_tail`` -- the fact-side streaming path: rows land in a
  pow2-bucketed tail.  Physical capacity is a multiple of the padded batch
  (``tail_bucket``) with a proportional reserve, so steady-state appends
  write one window and allocate nothing.  Capacity padding rows carry
  per-column fill values (FK columns: ``EMPTY_KEY``, which no probe
  matches), so they fall out of every query through the join mask.
  ``valid_rows`` is the logical row count; ``n_rows`` reports it.

torch tensors are mutable, so ``append_tail`` writes in place only into
buffers that an earlier ``append_tail`` allocated (``tail_owned``); a
table built from outside buffers is copied first, so tables shared by
several engines never see each other's appends.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

# Smallest padded tail batch: appends below it share one window size.
TAIL_MIN_BUCKET = 256
# Capacity growth reserve: at least this many padded batches of headroom...
TAIL_GROWTH_BATCHES = 4
# ...and at least this fraction of the current physical size, so growth
# (a copy of every column) is amortized-rare, as in dynamic-array doubling
# at a gentler 1.25x.
TAIL_RESERVE_FRAC = 0.25


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


def tail_bucket(n: int, min_bucket: int = TAIL_MIN_BUCKET) -> int:
    """Pow2 padded shape for an ``n``-row tail batch (>= ``min_bucket``)."""
    return max(min_bucket, 1 << max(0, int(n) - 1).bit_length())


def round_up(n: int, quantum: int) -> int:
    """Smallest multiple of ``quantum`` >= ``n`` (capacity quantization)."""
    return -(-int(n) // int(quantum)) * int(quantum)


def pad_batch(values, n_pad: int, fill: int, device) -> torch.Tensor:
    """One append-batch column padded to ``n_pad`` rows with ``fill``:
    padded in numpy, then one host-to-device copy."""
    a = (values.cpu().numpy() if torch.is_tensor(values)
         else np.asarray(values)).astype(np.int32, copy=False)
    if n_pad < a.shape[0]:
        raise ValueError(f"pad_batch: batch of {a.shape[0]} exceeds bucket "
                         f"{n_pad}")
    out = np.full((n_pad,), fill, np.int32)
    out[:a.shape[0]] = a
    return torch.from_numpy(out).to(device)


@dataclasses.dataclass
class Table:
    """An integer column-store relation (optionally capacity-padded)."""

    columns: Mapping[str, torch.Tensor]  # name -> (n_physical,) int32
    # logical row count when the columns carry capacity padding (the fact
    # tail); None means every physical row is live
    valid_rows: int | None = None
    # True when ``columns`` were allocated by ``append_tail`` itself: no
    # table built before the append chain can hold them, so the next tail
    # write goes in place.  Columns taken from such a table keep their
    # logical rows, but their padding rows take the next append's rows;
    # ``trimmed()`` or ``clone()`` them to keep a copy.
    tail_owned: bool = False

    def __post_init__(self):
        lens = {k: v.shape[0] for k, v in self.columns.items()}
        if len(set(lens.values())) != 1:
            raise ValueError(f"ragged columns: {lens}")
        if self.valid_rows is not None and not \
                0 <= self.valid_rows <= next(iter(lens.values())):
            raise ValueError(f"valid_rows {self.valid_rows} exceeds "
                             f"capacity {lens}")

    @property
    def n_rows(self) -> int:
        """Logical rows (excludes capacity padding)."""
        if self.valid_rows is not None:
            return self.valid_rows
        return self.n_physical

    @property
    def n_physical(self) -> int:
        """Physical column length (capacity, padding rows included)."""
        return next(iter(self.columns.values())).shape[0]

    @property
    def device(self) -> torch.device:
        return next(iter(self.columns.values())).device

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def names(self):
        return list(self.columns.keys())

    @staticmethod
    def from_numpy(cols: Mapping[str, np.ndarray], device,
                   valid_rows: int | None = None) -> "Table":
        # "W": torch refuses read-only arrays (those are copied once)
        return Table({k: torch.as_tensor(np.require(v, np.int32, "W"),
                                         device=device)
                      for k, v in cols.items()}, valid_rows=valid_rows)

    def append(self, cols: Mapping[str, torch.Tensor | np.ndarray]
               ) -> "Table":
        """A new Table with ``cols`` rows appended; ``cols`` must cover
        exactly this table's columns, with equal lengths."""
        if self.n_rows != self.n_physical:
            raise ValueError("append on a capacity-padded table: use "
                             "append_tail")
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

    def append_tail(self, cols: Mapping[str, torch.Tensor | np.ndarray],
                    pad_values: Mapping[str, int] | None = None, *,
                    min_bucket: int = TAIL_MIN_BUCKET,
                    bucket: int | None = None) -> "Table":
        """Streaming fact append into the pow2-bucketed tail.

        ``cols`` must cover exactly this table's columns with equal
        lengths.  The batch is padded to ``tail_bucket`` rows per column
        (``pad_values[name]``, default 0; join-key columns pad with
        ``EMPTY_KEY``) and written at the current logical end.  Capacity
        grows, with a reserve of ``max(TAIL_GROWTH_BATCHES * bucket,
        TAIL_RESERVE_FRAC * n_physical)`` rounded to a multiple of the
        bucket, only when the padded window no longer fits.  ``bucket``
        lets a caller that sizes companion arrays to the same window (the
        engine's probe-cache splice) supply the padded size.

        The window is written in place when this table's buffers are its
        own (``tail_owned``) or freshly grown; otherwise into copies.
        """
        if set(cols) != set(self.columns):
            raise ValueError(f"column mismatch: {sorted(cols)} vs "
                             f"{sorted(self.columns)}")
        pad_values = pad_values or {}
        lens = {k: len(v) for k, v in cols.items()}
        if len(set(lens.values())) != 1:
            raise ValueError(f"ragged append: {lens}")
        b = next(iter(lens.values()))
        n0 = self.n_rows
        bp = tail_bucket(b, min_bucket) if bucket is None else int(bucket)
        if bp < b:
            raise ValueError(f"tail bucket {bp} smaller than batch {b}")
        dev = self.device
        out = dict(self.columns)
        if n0 + bp > self.n_physical:  # grow capacity (rare; one copy)
            reserve = max(TAIL_GROWTH_BATCHES * bp,
                          int(self.n_physical * TAIL_RESERVE_FRAC))
            cap = round_up(n0 + bp + reserve, bp)
            grown = {}
            for k, v in out.items():
                g = torch.full((cap,), int(pad_values.get(k, 0)),
                               dtype=torch.int32, device=dev)
                g[:v.shape[0]] = v
                grown[k] = g
            out = grown
        elif not self.tail_owned:
            # buffers from outside the append chain may be shared (another
            # engine, a caller): never write into them
            out = {k: v.clone() for k, v in out.items()}
        for k, v in cols.items():
            out[k].narrow(0, n0, bp).copy_(
                pad_batch(v, bp, int(pad_values.get(k, 0)), dev))
        return Table(out, valid_rows=n0 + b, tail_owned=True)

    def pinned_view(self) -> "Table":
        """A read-only alias of this table for an epoch snapshot: the same
        column tensors (no copy) without ``tail_owned``, so an
        ``append_tail`` on the view writes copies, never the columns the
        snapshot's readers gather from.  The engine's pins
        (``SSBEngine._fact_pinned``) protect the columns from the live
        table's appends; this view protects them from the view's holder."""
        return Table(dict(self.columns), valid_rows=self.valid_rows,
                     tail_owned=False)

    def trimmed(self) -> "Table":
        """An exact-shape table without capacity padding (oracle rebuilds);
        its columns are copies, so later appends never reach them."""
        n = self.n_rows
        return Table({k: v[:n].clone() for k, v in self.columns.items()})

    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size()
                   for v in self.columns.values())
