"""Host numpy oracle for the serving tier's never-wrong gate.

PyTorch port of ``repro.serving.oracle``.  A harness mirrors every engine
mutation into a :class:`LogicalModel` and freezes one copy per published
epoch.  A completed response is correct iff it equals the frozen model
*at the epoch the response reports*: staleness is allowed (and reported
as ``epoch_lag``), wrongness is not.

Evaluation reuses the query-spec lambdas the engine runs, with
:class:`NumpyTable` standing in for ``Table`` and python ints for the
parameters, and the engine's int32 wraparound (measures summed in int64,
cast to int32).  The model shares no code with the engine: a dict of
numpy columns per table, a key -> row map per dimension, ``np.add.at``
grouping.  The join looks every fact key up in that map with one numpy
gather (or a binary search, when the keys are too sparse to index) rather
than the JAX package's per-row python loop, so that the model stays
usable at the scale the card serves; its answers are the same.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.engine.queries import DIM_PK, FACT_FK, SSB_QUERIES, QuerySpec
from repro_torch.serving.params import PARAM_QUERIES


class NumpyTable:
    """Numpy stand-in for ``Table`` accepted by the query-spec lambdas."""

    def __init__(self, cols):
        self._cols = cols

    def __getitem__(self, name):
        return self._cols[name]


def _host(table) -> dict[str, np.ndarray]:
    """The logical rows of a port ``Table`` as host numpy copies: its
    first ``n_rows`` rows.  A sharded engine's fact table is not such a
    prefix (``engine/shard.py``): model it from a table of its
    ``logical_fact_columns()``."""
    n = table.n_rows
    return {k: (v[:n].cpu().numpy() if torch.is_tensor(v)
                else np.asarray(v)[:n]).copy()
            for k, v in table.columns.items()}


class LogicalModel:
    """The logical relational state a serving epoch is supposed to hold."""

    def __init__(self, tables):
        self.fact = _host(tables["lineorder"])
        self.dims = {d: _host(tables[d]) for d in DIM_PK}
        self.deleted = {d: set() for d in DIM_PK}
        self.repointed = {d: {} for d in DIM_PK}
        self._rows = {}

    def freeze(self) -> "LogicalModel":
        out = LogicalModel.__new__(LogicalModel)
        out.fact = {k: v.copy() for k, v in self.fact.items()}
        out.dims = {d: {k: v.copy() for k, v in c.items()}
                    for d, c in self.dims.items()}
        out.deleted = {d: set(s) for d, s in self.deleted.items()}
        out.repointed = {d: dict(m) for d, m in self.repointed.items()}
        out._rows = {}
        return out

    # -- mutation mirrors (a harness applies these in lockstep) ------------
    def append_fact(self, cols) -> None:
        for k, v in cols.items():
            self.fact[k] = np.concatenate([self.fact[k], v])
        self._rows.clear()

    def append_dim(self, dim: str, cols) -> None:
        for k, v in cols.items():
            self.dims[dim][k] = np.concatenate([self.dims[dim][k], v])
        self._rows.clear()

    def delete_keys(self, dim: str, keys) -> None:
        self.deleted[dim].update(int(k) for k in keys)
        self._rows.clear()

    def repoint(self, dim: str, key: int, row: int) -> None:
        self.repointed[dim][int(key)] = int(row)
        self._rows.clear()

    # -- evaluation --------------------------------------------------------
    def key_map(self, dim: str) -> dict:
        mp = {int(k): i for i, k in enumerate(self.dims[dim][DIM_PK[dim]])}
        for k in self.deleted[dim]:
            mp.pop(k, None)
        mp.update(self.repointed[dim])
        return mp

    def fact_rows(self, dim: str) -> np.ndarray:
        """The dimension row each fact row joins (-1: none), int64."""
        r = self._rows.get(dim)
        if r is not None:
            return r
        mp = self.key_map(dim)
        fk = self.fact[FACT_FK[dim]].astype(np.int64)
        keys = np.fromiter(mp.keys(), np.int64, len(mp))
        rows = np.fromiter(mp.values(), np.int64, len(mp))
        if keys.size == 0:
            r = np.full(fk.shape, -1, np.int64)
        elif keys.max() - keys.min() <= 16 * keys.size + (1 << 16):
            lo = int(keys.min())
            dense = np.full(int(keys.max()) - lo + 1, -1, np.int64)
            dense[keys - lo] = rows
            ok = (fk >= lo) & (fk - lo < dense.size)
            r = np.where(ok, dense[np.where(ok, fk - lo, 0)], -1)
        else:
            order = np.argsort(keys)
            keys, rows = keys[order], rows[order]
            pos = np.minimum(np.searchsorted(keys, fk), keys.size - 1)
            r = np.where(keys[pos] == fk, rows[pos], -1)
        self._rows[dim] = r
        return r

    def eval_spec(self, spec: QuerySpec) -> tuple[int, np.ndarray]:
        n = self.fact["orderkey"].shape[0]
        mask = np.ones(n, bool)
        rows = {}
        for dim in spec.joined_dims():
            r = self.fact_rows(dim)
            rows[dim] = r
            mask &= r >= 0
            if dim in spec.dim_filters:
                dmask = np.asarray(
                    spec.dim_filters[dim](NumpyTable(self.dims[dim])))
                mask &= dmask[np.clip(r, 0, dmask.shape[0] - 1)]
        if spec.fact_filter is not None:
            mask &= np.asarray(spec.fact_filter(NumpyTable(self.fact)))
        measure = np.asarray(
            spec.measure(NumpyTable(self.fact))).astype(np.int64)
        total = np.int64(measure[mask].sum()).astype(np.int32)
        if not spec.group_by:
            return int(total), np.asarray([total], np.int32)
        gk = np.zeros(int(mask.sum()), np.int64)
        size = 1
        for dim, col, card in spec.group_by:
            c = self.dims[dim][col]
            v = c[np.clip(rows[dim][mask], 0, c.shape[0] - 1)] % card
            gk = gk * card + v
            size *= card
        groups = np.zeros(size, np.int64)
        np.add.at(groups, gk, measure[mask])
        return int(total), groups.astype(np.int32)

    def query(self, name: str) -> tuple[int, np.ndarray]:
        """One canonical (constant-predicate) SSB query."""
        return self.eval_spec(SSB_QUERIES[name])

    def param_query(self, name: str, p) -> tuple[int, np.ndarray]:
        """One parameterized query at ``p``: the serving path's oracle."""
        return self.eval_spec(
            PARAM_QUERIES[name].bind(tuple(int(x) for x in p)))
