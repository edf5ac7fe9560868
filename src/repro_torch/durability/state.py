"""Engine-state (de)serialization for epoch checkpoints (DESIGN.md §10).

PyTorch port of ``repro.durability.state``; both packages write and read
the same leaves.  A checkpoint captures one published epoch's **logical**
state, exactly what a fresh process needs to answer the 13 queries
bit-identically and keep ingesting:

* every table's columns, the fact table trimmed to its logical rows
  (capacity padding is an execution artifact, not data: the restored
  engine grows its own tail);
* every dimension index verbatim: dictionary (keys / n / codes), hash
  table planes, and the delta buffer if one is live.  The raw index state
  must be saved: ``ingest`` deletes and upserts change only the index, so
  it is *not* derivable from the dimension table;
* the epoch counters, plus the static geometry (hash modes, build stats)
  as JSON metadata.

Not captured: probe caches, plans, hot tables and ``BuildStats.fact_skew``,
all derived state the restored engine computes again (skew is measured
again over the restored FK columns, on the engine's device).  Plans may
therefore differ from the dead process's, which is safe: every probe
schedule gives the same probes, so the recovered epoch's answers cannot
depend on the choice.

The leaves stay tensors on the engine's device here; the checkpoint
writer (``checkpoint/manager.py``) copies each to the host once.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.skew import measure_skew
from repro_torch.engine.convert import dim_index_from_numpy, tables_from_numpy
from repro_torch.engine.join import BuildStats
from repro_torch.engine.table import resolve_device

STATE_VERSION = 1

_TBL_FIELDS = ("keys", "values", "dup_offsets", "dup_indices",
               "group_count", "n_unique", "n_build", "overflow")
_DELTA_FIELDS = ("keys", "words", "fill", "n_ops", "overflow")
_STATS_FIELDS = ("num_buckets", "bucket_width", "n_unique", "n_build",
                 "overflow", "grow_retries", "load")


def _index_leaves(idx) -> dict:
    """One ``DimIndex``'s array leaves under their checkpoint names (the
    reference's pytree leaves: ``codes`` only when present, the delta's
    only when live)."""
    leaf = {"dict_keys": idx.dictionary.keys, "dict_n": idx.dictionary.n}
    if idx.dictionary.codes is not None:
        leaf["dict_codes"] = idx.dictionary.codes
    for f in _TBL_FIELDS:
        leaf[f"tbl_{f}"] = getattr(idx.table, f)
    if idx.delta is not None:
        for f in _DELTA_FIELDS:
            leaf[f"dl_{f}"] = getattr(idx.delta, f)
    return leaf


def engine_state(src) -> tuple[dict, dict]:
    """(array_tree, meta) of an engine's or epoch snapshot's logical state.

    ``src`` is an ``SSBEngine`` or a live ``EpochSnapshot``: both expose
    ``tables`` / ``indexes`` / ``epoch`` / ``fact_epoch`` / ``mode``.  The
    tree's leaves are views of ``src``'s tensors (the fact columns sliced
    to the logical rows), not copies.
    """
    tree: dict = {"tables": {}, "indexes": {}}
    for name, t in src.tables.items():
        n = t.n_rows
        tree["tables"][name] = {k: t[k][:n] for k in t.names()}
    meta: dict = {"version": STATE_VERSION, "mode": src.mode,
                  "epoch": int(src.epoch),
                  "fact_epoch": int(src.fact_epoch), "dims": {}}
    for dim, idx in src.indexes.items():
        dm: dict = {"hash_mode": idx.table.hash_mode,
                    "has_delta": idx.delta is not None}
        if idx.delta is not None:
            dm["delta_hash_mode"] = idx.delta.hash_mode
        if idx.stats is not None:
            dm["stats"] = {f: getattr(idx.stats, f) for f in _STATS_FIELDS}
        tree["indexes"][dim] = _index_leaves(idx)
        meta["dims"][dim] = dm
    return tree, meta


def state_nbytes(src) -> int:
    """Cheap size estimate of a checkpoint of ``src`` (trigger input): 4
    bytes an element of every column's logical rows and of every index
    leaf, the delta's bool overflow included, as the reference counts."""
    total = sum(t.n_rows * len(t.names()) * 4 for t in src.tables.values())
    for idx in src.indexes.values():
        total += sum(int(a.numel()) * 4
                     for a in _index_leaves(idx).values())
    return total


def _leaves(arrays: dict[str, np.ndarray], prefix: str
            ) -> dict[str, np.ndarray]:
    """Sub-tree of a dotted-path leaf dict under one ``prefix.``"""
    p = prefix + "."
    return {k[len(p):]: v for k, v in arrays.items() if k.startswith(p)}


def build_engine_from_state(arrays: dict[str, np.ndarray], meta: dict, *,
                            device=None, policy=None,
                            probe_impl: str | None = None,
                            schedule: str | None = None):
    """Rebuild a queryable ``SSBEngine`` on ``device`` (the card unless
    the caller names another) from a loaded checkpoint.

    ``arrays`` is ``checkpoint.load_arrays``'s dotted-path leaf dict and
    ``meta`` the manifest ``extra``.  Indexes are rebuilt verbatim (no
    index build: recovery resumes the exact logical index state, deltas
    included); the fact-side skew is measured again on the device and the
    probe plans derived again, both schedule-invariant.
    """
    from repro_torch.engine.queries import FACT_FK, SSBEngine

    if meta.get("version") != STATE_VERSION:
        raise ValueError(f"unsupported engine-state version "
                         f"{meta.get('version')!r}")
    device = resolve_device(device)
    table_names = sorted({k.split(".")[1] for k in arrays
                          if k.startswith("tables.")})
    tables = tables_from_numpy(
        {name: _leaves(arrays, f"tables.{name}") for name in table_names},
        device)
    indexes = {}
    for dim, dm in meta["dims"].items():
        leaf = _leaves(arrays, f"indexes.{dim}")
        stats = None
        if "stats" in dm:
            stats = BuildStats(**dm["stats"], fact_skew=measure_skew(
                tables["lineorder"][FACT_FK[dim]]))
        indexes[dim] = dim_index_from_numpy({
            "dictionary": {"keys": leaf["dict_keys"], "n": leaf["dict_n"],
                           "codes": leaf.get("dict_codes")},
            "table": {**{f: leaf[f"tbl_{f}"] for f in _TBL_FIELDS},
                      "hash_mode": dm["hash_mode"]},
            "delta": ({**{f: leaf[f"dl_{f}"] for f in _DELTA_FIELDS},
                       "hash_mode": dm["delta_hash_mode"]}
                      if dm["has_delta"] else None)}, stats, device)
    eng = SSBEngine(tables, mode=meta["mode"], probe_impl=probe_impl,
                    schedule=schedule, policy=policy, device=device,
                    indexes=indexes if meta["mode"] == "jspim" else None)
    eng._epoch = int(meta["epoch"])
    eng._fact_epoch = int(meta["fact_epoch"])
    return eng
