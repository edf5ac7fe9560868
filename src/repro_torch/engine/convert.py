"""State carried across from host arrays: tables and prebuilt indexes.

``dim_index_from_numpy`` rebuilds a ``DimIndex`` from the arrays of an
index built elsewhere (for instance by the JAX package), so that
``SSBEngine(tables, indexes=...)`` answers queries on the very same hash
dataset.  Only numpy arrays cross this boundary.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.delta import DeltaTable
from repro_torch.core.dictionary import Dictionary
from repro_torch.core.hash_table import JSPIMTable
from repro_torch.engine.join import BuildStats, DimIndex
from repro_torch.engine.table import Table

_TABLE_ARRAYS = ("keys", "values", "dup_offsets", "dup_indices",
                 "group_count", "n_unique", "n_build", "overflow")


def tables_from_numpy(cols_by_table: Mapping[str, Mapping[str, np.ndarray]],
                      device) -> dict[str, Table]:
    """``{table: {column: array}}`` -> port tables on ``device``."""
    return {name: Table.from_numpy(cols, device)
            for name, cols in cols_by_table.items()}


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
