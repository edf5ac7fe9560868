"""JSPIM join integration for the column-store engine.

PyTorch port of ``repro.engine.join`` without the sharded probe.  A
``DimIndex`` is the paper's persistent auxiliary structure: dictionary +
hash table + duplication list, built once per (dimension table, key
column) and maintained across queries (§3.2.3):
``ingest_index`` buffers ops in a delta side-table, probes overlay it, and
``compact_index`` folds it back.  Probes run through the hand-written CUDA
kernels (``impl="cuda"``; their plain versions on CPU tensors) or the
plain gather math (``impl="torch"``).

Bucket geometry: ``build_dim_index`` targets a load factor and doubles the
bucket count until the build drops nothing.  The default bucket width is 8
on every device: on the card one bucket's keys are one 32-byte sector, and
the CPU tests build the same geometry as the JAX package on the CPU.  (The
JAX package picks 128 on a TPU, one VMEM lane row.)

``BuildStats.fact_skew`` records the skew of the fact-side FK column an
index is probed with (``build_dim_index(fact_keys=)``), the input of the
probe-schedule planner.  ``lookup`` runs every schedule: gathered,
stream, deduped and hot/cold (``plan=`` and ``hot_codes=``).
``tail_lookup`` and ``extend_cached_probe`` probe only an appended fact
tail, under the same plan, and splice it into a cached probe.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.delta import (TOMBSTONE, DeltaTable, apply_batch,
                                    delta_entries, delta_is_empty,
                                    empty_delta, merge_entries,
                                    suggest_delta_buckets)
from repro_torch.core.dictionary import (NO_CODE, Dictionary,
                                         build_dictionary, encode, encode_np,
                                         extend_dictionary)
from repro_torch.core.hash_table import (JSPIMTable, build_table,
                                         suggest_num_buckets, table_entries)
from repro_torch.core.lookup import (JoinResult, ProbeResult,
                                     build_hot_table, join, overlay_delta,
                                     probe, probe_deduped, probe_hot_cold,
                                     splice_probe)
from repro_torch.core.planner import SchedulePlan
from repro_torch.core.skew import SkewStats, measure_skew
from repro_torch.kernels.ops import (delta_slot_words, probe_table,
                                     probe_table_filtered,
                                     probe_table_filtered_delta,
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
    # fact-side skew of the FK column this index is probed with (planner
    # input, §3.3 / §4.1); None if unknown
    fact_skew: SkewStats | None = None

    @property
    def achieved_load(self) -> float:
        return self.n_unique / (self.num_buckets * self.bucket_width)


@dataclasses.dataclass(frozen=True)
class DimIndex:
    dictionary: Dictionary
    table: JSPIMTable
    stats: BuildStats | None = None
    # streaming-ingest side table (raw-key space; None until the first
    # ingest): probes overlay it after the main table, compact_index folds
    # it back
    delta: DeltaTable | None = None


def build_dim_index(dim_keys: torch.Tensor, *, bucket_width: int | None = None,
                    load: float = 0.5, max_grow_retries: int = 8,
                    fact_keys=None) -> DimIndex:
    """Encode the build column, then build the unique-key hash table whose
    values are dimension-row indices.  Lossless: on bucket overflow the
    bucket count doubles (up to ``max_grow_retries`` times).

    ``fact_keys`` (optional; a tensor, measured on its own device, or a
    numpy array) is the fact-side FK column this index will be probed
    with; its ``measure_skew`` summary lands on ``BuildStats.fact_skew``.
    """
    bucket_width = bucket_width or DEFAULT_BUCKET_WIDTH
    n = int(dim_keys.shape[0])
    fact_skew = measure_skew(fact_keys) if fact_keys is not None else None
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
                       load=load, fact_skew=fact_skew)
    return DimIndex(dictionary=d, table=tbl, stats=stats)


# ---------------------------------------------------------------------------
# Streaming ingest: delta-buffer maintenance and compaction
# ---------------------------------------------------------------------------


def _as_i32(x, device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(x, np.int32), device=device)


def ingest_index(index: DimIndex, keys, payloads=None, *,
                 op: str = "upsert") -> DimIndex:
    """Absorb a batch of ops into ``index``'s delta without rebuilding.

    ``keys`` are raw dimension keys (new keys have no dictionary code
    until compaction).  ``op``: "insert" / "upsert" (``payloads`` are the
    new dimension-row indices; at the delta level both overwrite) or
    "delete" (tombstones; ``payloads`` ignored).  Lossless: a delta bucket
    overflow doubles the delta geometry and re-applies.
    """
    dev = index.table.keys.device
    keys = _as_i32(keys, dev)
    if op in ("insert", "upsert"):
        if payloads is None:
            raise ValueError(f"op={op!r} needs payloads (dim-row indices)")
        words = _as_i32(payloads, dev) << 1
    elif op == "delete":
        words = torch.full(keys.shape, TOMBSTONE, dtype=torch.int32,
                           device=dev)
    else:
        raise ValueError(f"unknown ingest op {op!r}")

    delta = index.delta
    if delta is None:
        n_build = (index.stats.n_build if index.stats is not None
                   else int(index.table.num_buckets))
        delta = empty_delta(
            suggest_delta_buckets(n_build, index.table.bucket_width),
            index.table.bucket_width, device=dev)
    new = apply_batch(delta, keys, words)
    retries = 0
    while bool(new.overflow):  # grow + re-apply: ingest never drops ops
        if retries >= 16:  # adversarial keys: fail loudly, do not spin
            raise RuntimeError(
                f"delta bucket overflow persists after {retries} geometry "
                f"doublings ({delta.num_buckets} buckets)")
        retries += 1
        ok, ow, live = delta_entries(delta)
        grown = apply_batch(empty_delta(delta.num_buckets * 2,
                                        delta.bucket_width, delta.hash_mode,
                                        device=dev), ok[live], ow[live])
        delta, new = grown, apply_batch(grown, keys, words)
    return dataclasses.replace(index, delta=new)


def compact_index(index: DimIndex, *, max_grow_retries: int = 8,
                  donate: bool = False) -> DimIndex:
    """Fold the delta back into the main table.

    New raw keys take fresh dictionary codes through a positional merge
    (``extend_dictionary``: existing codes stay valid, so the table's
    bucket layout survives), then ``merge_entries`` applies deletes,
    updates and inserts bucket-locally.  Only when a main bucket runs out
    of empty slots does it rebuild, with doubled geometry, from the
    merged table's live entries plus the inserts that did not fit.

    ``donate=False`` (the default) is the **swap** flavor: the result has
    fresh planes and ``index`` stays unchanged, so every holder of
    ``index`` (an epoch snapshot, another engine, a caller) reads what it
    read.  ``donate=True`` is the **in-place** flavor: the merge writes the
    touched bucket rows into ``index``'s own key and value tensors, O(delta)
    instead of a copy of the planes, and ``index`` must not be read
    afterwards (the engine takes it only when no live snapshot pins the
    planes).  Both flavors give the same table, the grow fallback
    included: it rebuilds from the merged table, never from ``index``.
    """
    if index.delta is None:
        return index
    dk, dw, live = (x.cpu().numpy() for x in delta_entries(index.delta))
    if not live.any():
        return dataclasses.replace(index, delta=None)
    # the merge below is O(live entries), not O(delta capacity)
    dk, dw = dk[live], dw[live]
    is_tomb = dw == TOMBSTONE
    codes0 = encode_np(index.dictionary, dk)
    fresh = (codes0 == NO_CODE) & ~is_tomb
    d2, _ = extend_dictionary(index.dictionary, np.sort(dk[fresh]))
    codes = encode_np(d2, dk)

    table, grow_retries = index.table, 0
    dev = table.keys.device
    merged, needs_grow = merge_entries(
        table, _as_i32(codes, dev), _as_i32(dw, dev),
        torch.ones(dk.shape, dtype=torch.bool, device=dev), inplace=donate)
    if bool(needs_grow):
        # rebuild from the merged table's live multiset (in the in-place
        # flavor ``table`` is the merged table): the merge applied every
        # delete and update and every insert that fit, so what is missing
        # is exactly the live non-tombstone codes absent from it
        ek, ev, valid = (x.cpu().numpy() for x in table_entries(merged))
        ek, ev = ek[valid], ev[valid]
        unplaced = ~is_tomb & (codes >= 0) & ~np.isin(codes, ek)
        all_codes = np.concatenate([ek, codes[unplaced]])
        all_vals = np.concatenate([ev, dw[unplaced] >> 1])
        nb = table.num_buckets
        while True:
            nb *= 2
            grow_retries += 1
            merged = build_table(_as_i32(all_codes, dev),
                                 _as_i32(all_vals, dev), num_buckets=nb,
                                 bucket_width=table.bucket_width,
                                 hash_mode=table.hash_mode)
            if int(merged.overflow) == 0 or grow_retries >= max_grow_retries:
                break
        if int(merged.overflow) > 0:  # compaction never drops entries
            raise RuntimeError(
                f"rebuild still overflows after {grow_retries} doublings "
                f"({nb} buckets x {table.bucket_width})")

    stats = index.stats
    if stats is not None:
        stats = dataclasses.replace(
            stats, num_buckets=merged.num_buckets,
            n_unique=int(merged.n_unique), n_build=int(merged.n_build),
            overflow=int(merged.overflow),
            grow_retries=stats.grow_retries + grow_retries)
    return DimIndex(dictionary=d2, table=merged, stats=stats, delta=None)


def effective_index(index: DimIndex) -> DimIndex:
    """The index probes run against: an all-empty delta is stripped, so
    that probes keep their no-delta path."""
    if index.delta is not None and delta_is_empty(index.delta):
        return dataclasses.replace(index, delta=None)
    return index


def probe_fn_for(impl: str):
    """The probe every schedule runs on ``impl``: ``probe_rows`` (through
    ``probe_table``) on "cuda", the plain gather on "torch"."""
    if impl not in ("cuda", "torch"):
        raise ValueError(f"unknown impl {impl!r}")
    return probe_table if impl == "cuda" else probe


def lookup(index: DimIndex, fact_keys: torch.Tensor, *,
           impl: str = "cuda", schedule: str | None = None,
           plan: SchedulePlan | None = None,
           hot_codes: torch.Tensor | None = None) -> ProbeResult:
    """Probe fact keys; for PK dimensions the payload is the dimension-row
    index.

    ``schedule`` ("gathered" | "stream" | "deduped" | "hot_cold") names the
    probe schedule; ``plan`` (a planner decision) supplies it when
    ``schedule`` is None, and the hot/cold geometry; with neither the
    schedule is "gathered".  ``hot_cold`` needs a ``plan`` and
    ``hot_codes`` (hottest-first dictionary codes, or the full code range
    for a ``full_map`` plan).  Every probe a schedule makes runs through
    ``probe_rows`` on ``impl="cuda"`` and the plain gather on ``"torch"``;
    ``"stream"`` runs ``bucket_probe_stream`` whatever ``impl`` is (as the
    JAX package's stream schedule always runs its Pallas kernel).  A live
    delta is overlaid after any schedule, probed with the raw fact keys:
    keys ingested since the last compaction have no dictionary code yet.
    """
    probe_fn = probe_fn_for(impl)
    if schedule is None:
        schedule = plan.schedule if plan is not None else "gathered"
    index = effective_index(index)
    codes = encode(index.dictionary, fact_keys)
    if schedule == "hot_cold":
        if plan is None or hot_codes is None:
            raise ValueError("hot_cold needs a plan and hot_codes")
        hot = build_hot_table(index.table, hot_codes, plan.hot_slots,
                              probe_fn=probe_fn)
        pr = probe_hot_cold(index.table, codes, hot,
                            cold_capacity=plan.cold_capacity,
                            dedup_cold=plan.dedup_cold, probe_fn=probe_fn)
    elif schedule == "stream":
        pr = probe_table(index.table, codes, schedule="stream")
    elif schedule == "deduped":
        pr = probe_deduped(index.table, codes, probe_fn=probe_fn)
    elif schedule == "gathered":
        pr = probe_fn(index.table, codes)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    if index.delta is not None:
        pr = overlay_delta(pr, index.delta, fact_keys)
    return pr


def lookup_filtered(index: DimIndex, fact_keys: torch.Tensor,
                    dim_mask: torch.Tensor, *,
                    impl: str = "cuda") -> ProbeResult:
    """Fused probe + dimension-predicate filter (§4.1.5 filter-on-the-fly).

    ``dim_mask`` is a boolean per dimension row.  On ``impl="cuda"`` the
    predicate is pre-evaluated per hash-table slot and applied inside the
    ``probe_filter_rows`` kernel, or, with a live delta, inside
    ``probe_filter_rows_delta``, which also overlays the predicate-folded
    delta words.  On ``"torch"`` it is the plain probe, the delta overlay,
    then the row filter.  Duplication-group slots pass through (PK
    dimensions have none).
    """
    index = effective_index(index)
    codes = encode(index.dictionary, fact_keys)
    if impl == "cuda":
        pred = slot_predicate(index.table, dim_mask)
        if index.delta is not None:
            dwords = delta_slot_words(index.delta, dim_mask)
            return probe_table_filtered_delta(index.table, codes, pred,
                                              index.delta, fact_keys, dwords)
        return probe_table_filtered(index.table, codes, pred)
    if impl != "torch":
        raise ValueError(f"unknown impl {impl!r}")
    pr = probe(index.table, codes)
    if index.delta is not None:
        pr = overlay_delta(pr, index.delta, fact_keys)
    n = dim_mask.shape[0]
    row_ok = dim_mask[pr.payload.clamp(0, n - 1).long()] \
        & (pr.payload >= 0) & (pr.payload < n)
    keep = torch.where(pr.is_dup, True, row_ok)
    return ProbeResult(pr.found & keep, pr.payload, pr.is_dup)


# ---------------------------------------------------------------------------
# Fact-side streaming append: tail-only probes + probe-cache extension
# ---------------------------------------------------------------------------


def found_rows(pr: ProbeResult) -> tuple[torch.Tensor, torch.Tensor]:
    """The engine's cached-probe form of a probe result: ``(found,
    dim_row)`` with ``dim_row == -1`` on misses."""
    return pr.found, torch.where(pr.found, pr.payload, -1)


def tail_lookup(index: DimIndex, tail_keys: torch.Tensor,
                hot_codes: torch.Tensor | None = None, *, impl: str = "cuda",
                plan: SchedulePlan | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Probe only an appended fact tail under the already-planned schedule.

    ``tail_keys`` is the pow2-padded append batch (padding = ``EMPTY_KEY``,
    a miss on every schedule and through the delta overlay).  Returns the
    engine's cached-probe representation: ``(found, dim_row)`` with
    ``dim_row == -1`` on misses.
    """
    m = tail_keys.shape[0]
    if plan is not None and plan.cold_capacity > m:
        # a hot/cold plan's cold stream is sized to the whole fact stream;
        # the tail's cold probes are at most its length (the same answers,
        # and O(tail) work: what ``tail_extend_seconds`` prices)
        plan = dataclasses.replace(plan, cold_capacity=m)
    return found_rows(lookup(index, tail_keys, impl=impl, plan=plan,
                             hot_codes=hot_codes))


def extend_cached_probe(index: DimIndex, found: torch.Tensor,
                        row: torch.Tensor, tail_keys: torch.Tensor,
                        start: int, hot_codes: torch.Tensor | None = None, *,
                        impl: str = "cuda", plan: SchedulePlan | None = None,
                        owned: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Tail probe plus cache splice: probes ``tail_keys`` (the padded
    append batch, delta overlay included) and writes the window into the
    cached ``(found, dim_row)`` at ``start``, without re-probing the rows
    already cached.  With ``owned`` (the caller holds the only reference)
    the cached tensors are written in place; otherwise copies are."""
    tf, tr = tail_lookup(index, tail_keys, hot_codes, impl=impl, plan=plan)
    return splice_probe((found, row), (tf, tr), start, owned=owned)


def join_pairs(index: DimIndex, fact_keys: torch.Tensor, *, capacity: int,
               deduped: bool = True, impl: str = "cuda") -> JoinResult:
    """General join (duplication-list expansion), fixed output capacity:
    ``left`` are fact-row indices, ``right`` dimension-row indices.  The
    probe runs through ``probe_rows`` on ``impl="cuda"``."""
    probe_fn = probe_fn_for(impl)
    codes = encode(index.dictionary, fact_keys)
    return join(index.table, codes, capacity=capacity, deduped=deduped,
                probe_fn=probe_fn)
