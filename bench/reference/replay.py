"""The logical SSB state at any epoch, and each query's answer there.

Plain PyTorch, independent of the system under test.  ``Replay`` starts
from the generated tables and applies the writer's own log of mutations,
in order, up to an epoch: fact appends add rows; a dimension append adds
rows and maps their new keys to them; an upsert maps existing keys to the
given rows; a delete unmaps keys.  Each dimension's state is one dense
key -> row map, so a fact row joins the row its foreign key maps to, or
nothing.

``answer`` evaluates one query at the replay's current state.  The exact
form sums in int64 and wraps the sums to int32, as the system states its
answers; ``acc="float32"`` accumulates in float32 instead: the control,
which must fail the comparison.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bench.reference.ssb import DIM_PK, FACT_FK, Template

# rows gathered per step: bounds the int64 index temporaries
CHUNK = 1 << 25


@dataclasses.dataclass
class LogEntry:
    """One mutation the writer applied: ``op`` is ``fact_append``,
    ``dim_append``, ``dim_upsert`` or ``dim_delete``; ``arrays`` holds its
    host columns (``keys``/``rows`` for an upsert, ``keys`` for a delete);
    ``epoch`` is the system's epoch once the call had returned."""

    op: str
    dim: str | None
    arrays: dict
    epoch: int


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32 (two's complement)."""
    return (torch.remainder(x + 2 ** 31, 2 ** 32) - 2 ** 31).to(torch.int32)


def _gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[idx]`` in chunks; ``idx`` may be int32."""
    out = torch.empty(idx.shape, dtype=src.dtype, device=src.device)
    for lo in range(0, idx.shape[0], CHUNK):
        out[lo:lo + CHUNK] = src[idx[lo:lo + CHUNK].long()]
    return out


class Replay:
    """The generated tables plus a prefix of the writer's log."""

    def __init__(self, fact: dict, dims: dict, log: list[LogEntry], *,
                 epoch: int = 0):
        self.fact = dict(fact)
        self.dims = {d: dict(cols) for d, cols in dims.items()}
        dev = next(iter(self.fact.values())).device
        self.keymap = {
            d: torch.arange(cols[DIM_PK[d]].shape[0], dtype=torch.int32,
                            device=dev)
            for d, cols in self.dims.items()}
        for d, cols in self.dims.items():
            if not torch.equal(cols[DIM_PK[d]], self.keymap[d]):
                raise ValueError(f"{d}: generated keys must be 0..n-1")
        self.log = log
        self.applied = 0
        self.epoch = epoch
        self._rows: dict[str, torch.Tensor] = {}

    @property
    def device(self) -> torch.device:
        return next(iter(self.fact.values())).device

    @property
    def n_fact(self) -> int:
        return next(iter(self.fact.values())).shape[0]

    def advance_to(self, epoch: int) -> None:
        """Apply every logged mutation published at or before ``epoch``."""
        if epoch < self.epoch:
            raise ValueError(f"replay is at epoch {self.epoch}, cannot go "
                             f"back to {epoch}")
        while self.applied < len(self.log) and \
                self.log[self.applied].epoch <= epoch:
            self._apply(self.log[self.applied])
            self.applied += 1
        self.epoch = epoch

    def _as(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    def _apply(self, e: LogEntry) -> None:
        if e.op == "fact_append":
            for k in self.fact:
                self.fact[k] = torch.cat([self.fact[k], self._as(e.arrays[k])])
            self._rows.clear()
            return
        km = self.keymap[e.dim]
        if e.op == "dim_append":
            cols = self.dims[e.dim]
            n0 = cols[DIM_PK[e.dim]].shape[0]
            for k in cols:
                cols[k] = torch.cat([cols[k], self._as(e.arrays[k])])
            keys = self._as(e.arrays[DIM_PK[e.dim]]).long()
            need = int(keys.max()) + 1 if keys.numel() else 0
            if need > km.shape[0]:
                km = torch.cat([km, km.new_full((need - km.shape[0],), -1)])
            km[keys] = torch.arange(n0, n0 + keys.shape[0], dtype=torch.int32,
                                    device=self.device)
        elif e.op == "dim_upsert":
            km[self._as(e.arrays["keys"]).long()] = self._as(e.arrays["rows"])
        elif e.op == "dim_delete":
            km[self._as(e.arrays["keys"]).long()] = -1
        else:
            raise ValueError(f"unknown log op {e.op!r}")
        self.keymap[e.dim] = km
        self._rows.pop(e.dim, None)

    def rows(self, dim: str) -> torch.Tensor:
        """The dimension row each fact row joins (-1: none), int32."""
        r = self._rows.get(dim)
        if r is None:
            km = self.keymap[dim]
            fk = self.fact[FACT_FK[dim]]
            ok = (fk >= 0) & (fk < km.shape[0])
            r = torch.where(ok, _gather(km, fk.clamp(0, km.shape[0] - 1)),
                            -1)
            self._rows[dim] = r
        return r

    def answer(self, tmpl: Template, p, *, acc: str = "int64"
               ) -> tuple[int, np.ndarray]:
        """``(total, groups)`` of ``tmpl`` at ``p`` on the current state,
        int32 as the system answers."""
        p = tuple(int(x) for x in p)
        mask = torch.ones(self.n_fact, dtype=torch.bool, device=self.device)
        for dim in tmpl.joined_dims:
            r = self.rows(dim)
            mask &= r >= 0
            if dim in tmpl.dim_filters:
                dmask = tmpl.dim_filters[dim](self.dims[dim], p)
                mask &= _gather(dmask, r.clamp(min=0))
        if tmpl.fact_filter is not None:
            mask &= tmpl.fact_filter(self.fact, p)
        sel = mask.nonzero().squeeze(1)
        picked = {k: v[sel] for k, v in self.fact.items()}
        measure = tmpl.measure({k: v.long() for k, v in picked.items()})
        key = torch.zeros(sel.shape[0], dtype=torch.int64, device=self.device)
        for dim, col, card in tmpl.group_by:
            vals = self.dims[dim][col][self.rows(dim)[sel].long()].long()
            key = key * card + torch.remainder(vals, card)
        if acc == "int64":
            total = measure.sum()
            groups = torch.zeros(tmpl.group_size, dtype=torch.int64,
                                 device=self.device).index_add_(0, key,
                                                                measure)
        elif acc == "float32":
            m32 = measure.to(torch.float32)
            total = m32.sum().round().long()
            groups = torch.zeros(tmpl.group_size, dtype=torch.float32,
                                 device=self.device).index_add_(
                0, key, m32).round().long()
        else:
            raise ValueError(f"unknown accumulation {acc!r}")
        total32 = int(wrap_int32(total.reshape(1))[0])
        if not tmpl.group_by:
            return total32, np.asarray([total32], np.int32)
        return total32, wrap_int32(groups).cpu().numpy()
