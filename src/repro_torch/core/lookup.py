"""JSPIM search-engine semantics: probe, join, select (§3.1.1, §3.2).

PyTorch port of ``repro.core.lookup``.  Three probe schedules:

* ``probe``          -- every probe key activates its bucket (a gather of
                        one row), all ``bucket_width`` slots are compared
                        and a match-select picks the value.
* ``probe_deduped``  -- the RLU coalescing window generalized: dedup the
                        stream, probe the unique keys only, scatter the
                        results back.  Falls back to the plain probe when
                        the unique capacity is exceeded.
* ``probe_hot_cold`` -- the §3.3 hot-key path: the hottest codes are
                        served from a small direct-mapped ``HotTable``, the
                        cold remainder is compacted (cumsum + binary
                        search, no sort over the full stream) and probed
                        deduped, and the two streams are merged.

Each has a delta-aware flavor (``probe_with_delta``): buffered ingest ops
in a ``core/delta.py`` side table are overlaid after the main probe, and a
tombstone reads as a miss because its stored word is ``NULL_WORD``.
``splice_probe`` writes a probe of an appended fact tail into cached
full-stream results.  ``join`` expands matches through the duplication table
(CSR) with a fixed output capacity; ``select_where_eq`` and
``select_distinct`` are the paper's SELECT paths.

The schedules take ``probe_fn``, the probe they run on the keys they
keep: the plain ``probe`` by default, or the ``probe_rows`` kernel
(``kernels.ops.probe_table``), which gives the same packed words.  The
reference's two ``lax.cond`` overflow fallbacks become a host branch on
one scalar (one device sync per probe), taken only where the capacity
could overflow at all.

``overlay_delta`` is spanned as ``probe.overlay`` (``repro_torch.trace``,
off unless a run enables the recorder); it takes its ``dim`` from the
span open around it.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch import trace
from repro_torch.core import dedup
from repro_torch.core.delta import DeltaTable, delta_lookup
from repro_torch.core.hash_table import EMPTY_KEY, JSPIMTable, hash_bucket

# packed value word meaning "no match": payload -1, is_dup 0
NULL_WORD = -2


class ProbeResult(NamedTuple):
    found: torch.Tensor    # (m,) bool
    payload: torch.Tensor  # (m,) int32 row index OR duplication-group id
    is_dup: torch.Tensor   # (m,) bool tag bit from the value word


def pack_words(pr: ProbeResult) -> torch.Tensor:
    """ProbeResult -> packed value words (payload<<1 | dup; NULL_WORD miss)."""
    word = (pr.payload.to(torch.int32) << 1) | pr.is_dup.to(torch.int32)
    return torch.where(pr.found, word, NULL_WORD)


def unpack_words(words: torch.Tensor) -> ProbeResult:
    """Packed value words -> ProbeResult."""
    return ProbeResult(words != NULL_WORD, words >> 1, (words & 1).bool())


def probe(table: JSPIMTable, probe_keys: torch.Tensor) -> ProbeResult:
    """Streaming associative search: one bucket activation per probe."""
    k = probe_keys.to(torch.int32)
    b = hash_bucket(k, table.num_buckets, table.hash_mode).long()
    rows_k = table.keys[b]          # (m, W) the "row buffer"
    rows_v = table.values[b]
    match = rows_k == k[:, None]    # comparator array
    found = match.any(dim=-1) & (k != EMPTY_KEY)
    slot = torch.argmax(match.to(torch.uint8), dim=-1)  # first match
    word = rows_v.gather(1, slot[:, None])[:, 0]
    return ProbeResult(found, word >> 1, (word & 1).bool())


ProbeFn = Callable[[JSPIMTable, torch.Tensor], ProbeResult]


def probe_deduped(table: JSPIMTable, probe_keys: torch.Tensor,
                  unique_capacity: int | None = None, *,
                  probe_fn: ProbeFn = probe) -> ProbeResult:
    """Coalescing-window schedule: dedup, probe uniques, scatter back.

    When ``unique_capacity`` is below the stream's distinct count the
    coalesce overflows; probing the truncated unique set would return
    wrong results for the dropped keys, so the whole stream falls back to
    the plain probe instead.
    """
    m = probe_keys.shape[0]
    cap = int(unique_capacity or m)
    co = dedup.coalesce(probe_keys, cap, pad=EMPTY_KEY)
    # cap >= m can never overflow: no sync
    if cap < m and bool(co.overflow):
        return probe_fn(table, probe_keys)
    u = probe_fn(table, co.unique)
    inv = co.inverse.long()
    return ProbeResult(u.found[inv], u.payload[inv], u.is_dup[inv])


# ---------------------------------------------------------------------------
# Hot/cold schedule: replicated hot table + compacted cold remainder (§3.3)
# ---------------------------------------------------------------------------


class HotTable(NamedTuple):
    """Small direct-mapped replica of the hottest hash-table entries.

    ``keys[s]`` is the hot code owning slot ``s`` (EMPTY_KEY if none) and
    ``words[s]`` its packed value word, fetched from the live table: one
    gather serves a hot probe, no bucket search.
    """

    keys: torch.Tensor   # (num_slots,) int32 codes, EMPTY_KEY padded
    words: torch.Tensor  # (num_slots,) int32 packed value words


def build_hot_table(table: JSPIMTable, hot_codes: torch.Tensor,
                    num_slots: int, *, probe_fn: ProbeFn = probe
                    ) -> HotTable:
    """Direct-map the hottest codes; on a slot collision the hotter wins.

    ``hot_codes`` must be ordered hottest-first (``skew.top_keys``).  The
    words are probed from the live table on every build, so an update can
    never leave a stale replica.  ``num_slots`` must be a power of two.
    """
    if num_slots & (num_slots - 1):
        raise ValueError(f"num_slots must be a power of two, got "
                         f"{num_slots}")
    codes = hot_codes.to(torch.int32)
    h = codes.shape[0]
    dev = codes.device
    slot = hash_bucket(codes, num_slots, table.hash_mode).long()
    rank = torch.arange(h, dtype=torch.int32, device=dev)
    winner = torch.full((num_slots,), h, dtype=torch.int32,
                        device=dev).scatter_reduce_(0, slot, rank, "amin")
    # winner == h (no code in the slot) picks the EMPTY_KEY appended
    keys = torch.cat([codes, codes.new_full((1,), EMPTY_KEY)])[winner.long()]
    return HotTable(keys=keys, words=pack_words(probe_fn(table, keys)))


def hot_hit_count(table: JSPIMTable, hot: HotTable,
                  probe_keys: torch.Tensor) -> torch.Tensor:
    """() int32: how many probes the hot table serves (plan refinement)."""
    codes = probe_keys.to(torch.int32)
    slot = hash_bucket(codes, hot.keys.shape[0], table.hash_mode).long()
    hit = (hot.keys[slot] == codes) & (codes != EMPTY_KEY)
    return hit.sum().to(torch.int32)


def probe_hot_cold(table: JSPIMTable, probe_keys: torch.Tensor,
                   hot: HotTable, *, cold_capacity: int,
                   dedup_cold: bool = True,
                   probe_fn: ProbeFn = probe) -> ProbeResult:
    """Hot/cold split probe, bit-identical to ``probe``.

    Hot probes (code present in the ``HotTable``) take a single gather.
    Cold probes are compacted into a fixed ``cold_capacity``-long stream
    (the j-th cold probe sits where the cold cumsum first reaches j, found
    by binary search), probed through the bucket path, deduped when
    ``dedup_cold``, and merged back.  If the cold count exceeds
    ``cold_capacity`` the whole stream takes the plain probe (correct for
    any stream, not just the planned one).
    """
    codes = probe_keys.to(torch.int32)
    m = codes.shape[0]
    cap = int(cold_capacity)
    slot = hash_bucket(codes, hot.keys.shape[0], table.hash_mode).long()
    hot_hit = (hot.keys[slot] == codes) & (codes != EMPTY_KEY)
    hot_word = hot.words[slot]
    if cap == 0:
        # full replica (a ``full_map`` plan): every live entry is in the
        # hot table, so a hot miss IS a table miss; no cold path
        return unpack_words(torch.where(hot_hit, hot_word, NULL_WORD))

    csum = torch.cumsum(~hot_hit, 0).to(torch.int32)
    n_cold = csum[-1]
    # cap >= m: every probe fits the cold stream, no sync
    if cap < m and int(n_cold) > cap:
        return unpack_words(pack_words(probe_fn(table, codes)))
    j = torch.arange(1, cap + 1, dtype=torch.int32, device=codes.device)
    src = torch.searchsorted(csum, j)
    cold_keys = torch.where(j <= n_cold, codes[src.clamp(max=m - 1)],
                            EMPTY_KEY)
    cpr = (probe_deduped(table, cold_keys, probe_fn=probe_fn)
           if dedup_cold else probe_fn(table, cold_keys))
    cold_word = pack_words(cpr)[(csum - 1).clamp(0, cap - 1).long()]
    return unpack_words(torch.where(hot_hit, hot_word, cold_word))


# ---------------------------------------------------------------------------
# Delta-aware probe: main table, then the delta side-table
# ---------------------------------------------------------------------------


def overlay_delta(pr: ProbeResult, delta: DeltaTable,
                  delta_keys: torch.Tensor) -> ProbeResult:
    """Overlay buffered ingest ops on a main-table probe result.

    One extra bucket gather plus one select: a delta hit overrides the
    main result with its stored word, and a tombstone's word is
    ``NULL_WORD``, so a deleted key comes out as a miss.  ``delta_keys``
    are the probe keys in the delta's key space (raw fact keys at the
    engine layer, where the main table is probed with dictionary codes).
    """
    with trace.span("probe.overlay"):
        hit, word = delta_lookup(delta, delta_keys)
        return unpack_words(torch.where(hit, word, pack_words(pr)))


def probe_with_delta(table: JSPIMTable, delta: DeltaTable,
                     probe_keys: torch.Tensor, *,
                     delta_keys: torch.Tensor | None = None,
                     schedule: str = "gathered",
                     hot: HotTable | None = None,
                     cold_capacity: int = 0, dedup_cold: bool = True,
                     unique_capacity: int | None = None,
                     probe_fn: ProbeFn = probe) -> ProbeResult:
    """Delta-aware variant of every probe schedule: the main probe through
    ``schedule`` (gathered / deduped / hot_cold, with the same geometry
    arguments as the plain schedules), then the overlay.  Bit-identical
    to compacting the delta into the table and probing that."""
    dk = probe_keys if delta_keys is None else delta_keys
    if schedule == "gathered":
        pr = probe_fn(table, probe_keys)
    elif schedule == "deduped":
        pr = probe_deduped(table, probe_keys, unique_capacity,
                           probe_fn=probe_fn)
    elif schedule == "hot_cold":
        if hot is None:
            raise ValueError("hot_cold needs a HotTable")
        pr = probe_hot_cold(table, probe_keys, hot,
                            cold_capacity=cold_capacity,
                            dedup_cold=dedup_cold, probe_fn=probe_fn)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    return overlay_delta(pr, delta, dk)


# ---------------------------------------------------------------------------
# Tail extension: splice a tail-only probe into cached full-stream results
# ---------------------------------------------------------------------------


def splice_probe(head, tail, start: int, *, owned: bool = False) -> tuple:
    """Write (padded) tail probe windows into cached streams at ``start``.

    The fact-side streaming append primitive: ``head`` and ``tail`` are
    matching tuples of per-probe tensors (``ProbeResult`` fields, or the
    engine's cached ``(found, dim_row)`` pair), ``head`` over the
    capacity-padded fact column and ``tail`` over the padded append batch.
    Padding lanes of the tail probe as misses (their key is ``EMPTY_KEY``),
    the value the capacity rows they land on hold.  With ``owned`` the
    windows are written into ``head`` in place; otherwise into copies, so
    that whoever holds ``head`` keeps reading what it read.
    """
    out = []
    for h, t in zip(head, tail):
        if not owned:
            h = h.clone()
        h.narrow(0, int(start), t.shape[0]).copy_(t)
        out.append(h)
    return tuple(out)


# ---------------------------------------------------------------------------
# JOIN with duplicates, SELECT
# ---------------------------------------------------------------------------


class JoinResult(NamedTuple):
    """Fixed-capacity (left_row, right_row) match pairs."""

    left: torch.Tensor       # (capacity,) int32, -1 padded
    right: torch.Tensor      # (capacity,) int32, -1 padded
    n_matches: torch.Tensor  # () int32 (may exceed capacity: truncated)
    truncated: torch.Tensor  # () bool


def _expand(table: JSPIMTable, pr: ProbeResult, capacity: int) -> JoinResult:
    """CSR expansion of probe results through the duplication table."""
    m = pr.found.shape[0]
    dev = pr.found.device
    ng = table.group_count.shape[0]
    # matches contributed by each probe: 0 (miss), 1 (unique), count (dup)
    counts = torch.where(
        pr.found,
        torch.where(pr.is_dup,
                    table.group_count[pr.payload.clamp(0, ng - 1).long()], 1),
        0).to(torch.int32)
    # the reference's cumsum is int32 and wraps; cast torch's int64 back
    offs = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                      torch.cumsum(counts, 0).to(torch.int32)])
    total = offs[-1]
    out_pos = torch.arange(capacity, dtype=torch.int32, device=dev)
    src = torch.searchsorted(offs, out_pos, right=True) - 1
    src_c = src.clamp(0, m - 1)
    within = out_pos - offs[src_c]
    grp = pr.payload[src_c].clamp(0, table.dup_offsets.shape[0] - 2).long()
    dup_row = table.dup_indices[(table.dup_offsets[grp] + within).clamp(
        0, table.dup_indices.shape[0] - 1).long()]
    right = torch.where(pr.is_dup[src_c], dup_row, pr.payload[src_c])
    valid = out_pos < total
    return JoinResult(left=torch.where(valid, src_c.to(torch.int32), -1),
                      right=torch.where(valid, right, -1),
                      n_matches=total, truncated=total > capacity)


def join(table: JSPIMTable, fact_keys: torch.Tensor, *, capacity: int,
         deduped: bool = True, unique_capacity: int | None = None,
         probe_fn: ProbeFn = probe) -> JoinResult:
    """fact ⋈ dim: probe every fact key, expand duplicates via CSR.
    ``left`` are fact-row indices, ``right`` dimension-row indices."""
    pr = (probe_deduped(table, fact_keys, unique_capacity, probe_fn=probe_fn)
          if deduped else probe_fn(table, fact_keys))
    return _expand(table, pr, capacity)


def select_where_eq(table: JSPIMTable, key, *, capacity: int,
                    probe_fn: ProbeFn = probe) -> JoinResult:
    """SELECT * WHERE col = key: a single PIM read (one probe)."""
    k = torch.as_tensor(key, device=table.keys.device).to(
        torch.int32).reshape(1)
    return _expand(table, probe_fn(table, k), capacity)


def select_distinct(table: JSPIMTable, *, capacity: int) -> torch.Tensor:
    """SELECT DISTINCT: the hash table already stores exactly the uniques,
    compacted (stable) into the first ``n_unique`` of ``capacity`` slots."""
    flat = table.keys.reshape(-1)
    live = flat != EMPTY_KEY
    idx = torch.cumsum(live, 0) - 1
    # the reference's scatter with mode="drop": dead and past-capacity
    # slots land in one trailing slot, sliced off
    slot = torch.where(live & (idx < capacity), idx, capacity)
    out = torch.full((capacity + 1,), EMPTY_KEY, dtype=torch.int32,
                     device=flat.device)
    out[slot] = flat
    return out[:capacity]
