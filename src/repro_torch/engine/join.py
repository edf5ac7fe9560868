"""JSPIM join integration for the column-store engine.

PyTorch port of the static part of ``repro.engine.join``.  A ``DimIndex``
is the paper's persistent auxiliary structure: dictionary + hash table +
duplication list, built once per (dimension table, key column).  Probes run
through the hand-written CUDA kernels (``impl="cuda"``; their plain
versions on CPU tensors) or the plain gather math (``impl="torch"``).

Bucket geometry: ``build_dim_index`` targets a load factor and doubles the
bucket count until the build drops nothing.  The default bucket width is 8
on every device: on the card one bucket's keys are one 32-byte sector, and
the CPU tests build the same geometry as the JAX package on the CPU.  (The
JAX package picks 128 on a TPU, one VMEM lane row.)

The delta overlay, ingest and compaction wait for the mutation slice; the
fact-skew statistics wait for the planner slice.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.dictionary import Dictionary, build_dictionary, encode
from repro_torch.core.hash_table import (JSPIMTable, build_table,
                                         suggest_num_buckets)
from repro_torch.core.lookup import ProbeResult, probe
from repro_torch.kernels.ops import (probe_table, probe_table_filtered,
                                     slot_predicate)

DEFAULT_BUCKET_WIDTH = 8


@dataclasses.dataclass(frozen=True)
class BuildStats:
    """Final geometry of a built index (host-side metadata)."""

    num_buckets: int
    bucket_width: int
    n_unique: int
    n_build: int
    overflow: int        # residual dropped entries (0 unless growth capped)
    grow_retries: int    # times num_buckets was doubled to absorb overflow
    load: float          # requested target load factor

    @property
    def achieved_load(self) -> float:
        return self.n_unique / (self.num_buckets * self.bucket_width)


@dataclasses.dataclass(frozen=True)
class DimIndex:
    dictionary: Dictionary
    table: JSPIMTable
    stats: BuildStats | None = None
    # streaming-ingest side table: always None until the mutation slice
    delta: None = None


def build_dim_index(dim_keys: torch.Tensor, *, bucket_width: int | None = None,
                    load: float = 0.5, max_grow_retries: int = 8) -> DimIndex:
    """Encode the build column, then build the unique-key hash table whose
    values are dimension-row indices.  Lossless: on bucket overflow the
    bucket count doubles (up to ``max_grow_retries`` times)."""
    bucket_width = bucket_width or DEFAULT_BUCKET_WIDTH
    n = int(dim_keys.shape[0])
    dev = dim_keys.device
    d = build_dictionary(dim_keys, capacity=max(1, n))
    codes = encode(d, dim_keys)
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    nb = suggest_num_buckets(n, bucket_width, load)
    retries = 0
    while True:
        tbl = build_table(codes, rows, num_buckets=nb,
                          bucket_width=bucket_width)
        if int(tbl.overflow) == 0 or retries >= max_grow_retries:
            break
        nb *= 2
        retries += 1
    stats = BuildStats(num_buckets=nb, bucket_width=bucket_width,
                       n_unique=int(tbl.n_unique), n_build=n,
                       overflow=int(tbl.overflow), grow_retries=retries,
                       load=load)
    return DimIndex(dictionary=d, table=tbl, stats=stats)


def effective_index(index: DimIndex) -> DimIndex:
    """The index probes run against.  The JAX package strips an empty delta
    here; the port's indexes carry none, and a live one cannot arrive
    before the mutation slice."""
    if index.delta is not None:
        raise NotImplementedError("delta overlays arrive with the mutation "
                                  "slice (ROADMAP Queue 1 item 6)")
    return index


def lookup(index: DimIndex, fact_keys: torch.Tensor, *,
           impl: str = "cuda") -> ProbeResult:
    """Probe fact keys (gathered schedule); for PK dimensions the payload
    is the dimension-row index."""
    index = effective_index(index)
    codes = encode(index.dictionary, fact_keys)
    if impl == "cuda":
        return probe_table(index.table, codes)
    if impl == "torch":
        return probe(index.table, codes)
    raise ValueError(f"unknown impl {impl!r}")


def lookup_filtered(index: DimIndex, fact_keys: torch.Tensor,
                    dim_mask: torch.Tensor, *,
                    impl: str = "cuda") -> ProbeResult:
    """Fused probe + dimension-predicate filter (§4.1.5 filter-on-the-fly).

    ``dim_mask`` is a boolean per dimension row.  On ``impl="cuda"`` the
    predicate is pre-evaluated per hash-table slot and applied inside the
    ``probe_filter_rows`` kernel; on ``"torch"`` it filters the plain
    probe's rows afterwards.  Duplication-group slots pass through (PK
    dimensions have none).
    """
    index = effective_index(index)
    codes = encode(index.dictionary, fact_keys)
    if impl == "cuda":
        pred = slot_predicate(index.table, dim_mask)
        return probe_table_filtered(index.table, codes, pred)
    if impl != "torch":
        raise ValueError(f"unknown impl {impl!r}")
    pr = probe(index.table, codes)
    n = dim_mask.shape[0]
    row_ok = dim_mask[pr.payload.clamp(0, n - 1).long()] \
        & (pr.payload >= 0) & (pr.payload < n)
    keep = torch.where(pr.is_dup, True, row_ok)
    return ProbeResult(pr.found & keep, pr.payload, pr.is_dup)
