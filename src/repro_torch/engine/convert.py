"""State carried across from host arrays: tables and prebuilt indexes.

``dim_index_from_numpy`` rebuilds a ``DimIndex`` from the arrays of an
index built elsewhere (for instance by the JAX package), so that
``SSBEngine(tables, indexes=...)`` answers queries on the very same hash
dataset.  ``build_stats_from`` carries its ``BuildStats`` over, the
fact-side skew included, so the planner sees what the other engine saw.
Only numpy arrays and plain Python values cross this boundary.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.delta import DeltaTable
from repro_torch.core.dictionary import Dictionary
from repro_torch.core.hash_table import JSPIMTable
from repro_torch.core.skew import SkewStats
from repro_torch.engine.join import BuildStats, DimIndex
from repro_torch.engine.table import Table

_TABLE_ARRAYS = ("keys", "values", "dup_offsets", "dup_indices",
                 "group_count", "n_unique", "n_build", "overflow")


def tables_from_numpy(cols_by_table: Mapping[str, Mapping[str, np.ndarray]],
                      device, valid_rows: Mapping[str, int | None] | None
                      = None) -> dict[str, Table]:
    """``{table: {column: array}}`` -> port tables on ``device``.
    ``valid_rows[table]`` carries a capacity-padded table's logical row
    count (the JAX package's ``Table.valid_rows``) across; the padding
    rows come with the arrays, so ``n_physical`` is the same."""
    valid_rows = valid_rows or {}
    return {name: Table.from_numpy(cols, device, valid_rows.get(name))
            for name, cols in cols_by_table.items()}


def build_stats_from(stats) -> BuildStats | None:
    """A port ``BuildStats`` from any object with its fields (for instance
    the JAX package's ``BuildStats``), read field by field; ``fact_skew``
    likewise becomes a port ``SkewStats``.  ``None`` stays ``None``."""
    if stats is None:
        return None
    sk = stats.fact_skew
    fact_skew = None if sk is None else SkewStats(
        n=int(sk.n), distinct=int(sk.distinct),
        dup_factor=float(sk.dup_factor), max_share=float(sk.max_share),
        top_share=tuple(float(x) for x in sk.top_share))
    return BuildStats(
        num_buckets=int(stats.num_buckets),
        bucket_width=int(stats.bucket_width), n_unique=int(stats.n_unique),
        n_build=int(stats.n_build), overflow=int(stats.overflow),
        grow_retries=int(stats.grow_retries), load=float(stats.load),
        fact_skew=fact_skew)


def dim_index_from_numpy(arrays: Mapping[str, Mapping], stats: BuildStats
                         | None, device) -> DimIndex:
    """A ``DimIndex`` on ``device`` from host arrays.

    ``arrays["dictionary"]`` holds ``keys``, ``n`` and ``codes`` (``None``
    for a rank-coded dictionary); ``arrays["table"]`` holds ``keys``,
    ``values``, ``dup_offsets``, ``dup_indices``, ``group_count``,
    ``n_unique``, ``n_build``, ``overflow`` and ``hash_mode``; the
    optional ``arrays["delta"]`` (absent or ``None`` when the index has no
    delta) holds a delta buffer's ``keys``, ``words``, ``fill``,
    ``n_ops``, ``overflow`` (bool) and ``hash_mode``.
    """
    def t(a):
        return torch.as_tensor(np.array(a, np.int32), device=device)

    d, tb = arrays["dictionary"], arrays["table"]
    dictionary = Dictionary(
        keys=t(d["keys"]), n=t(d["n"]),
        codes=None if d.get("codes") is None else t(d["codes"]))
    table = JSPIMTable(**{k: t(tb[k]) for k in _TABLE_ARRAYS},
                       hash_mode=str(tb["hash_mode"]))
    dl = arrays.get("delta")
    delta = None if dl is None else DeltaTable(
        keys=t(dl["keys"]), words=t(dl["words"]), fill=t(dl["fill"]),
        n_ops=t(dl["n_ops"]),
        overflow=torch.as_tensor(np.array(dl["overflow"], bool),
                                 device=device),
        hash_mode=str(dl["hash_mode"]))
    return DimIndex(dictionary=dictionary, table=table, stats=stats,
                    delta=delta)
