"""Delta side-table: batched index maintenance without rebuilds (§3.2.3+).

PyTorch port of ``repro.core.delta``.  A ``DeltaTable`` is a small bucketed
hash map in the same layout as the main ``JSPIMTable`` (a keys row and a
words row per bucket) that absorbs ``insert_batch`` / ``upsert_batch`` /
``delete_batch`` as functional updates: one entry per key, last write wins,
so the delta holds the net effect of every op since the last compaction.

* Probes consult the main table, then the delta
  (``core/lookup.py:overlay_delta``): a delta hit overrides the main result
  with its stored word, and a tombstone's word is ``NULL_WORD``, so a
  deleted key reads as a miss with no special case.
* ``merge_entries`` folds the delta into the main table bucket-locally:
  deletes clear their cell, updates overwrite their word in place, inserts
  take the k-th empty slot of their bucket.  Only when a bucket has no
  empty slot left does the caller rebuild with doubled geometry
  (``engine/join.py:compact_index``).

Every op runs eagerly on the device its tensors live on and is
bit-identical to the JAX package's.  Where the JAX ops scatter with
``mode="drop"``, ``apply_batch`` scatters into one trailing park slot and
slices it off; ``merge_entries`` writes only the selected cells, into
copies of the table planes or, with ``inplace``, into the planes
themselves.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.hash_table import (EMPTY_KEY, HASH_FIBONACCI,
                                         JSPIMTable, hash_bucket)

# A tombstone's stored word: ``lookup.NULL_WORD`` (payload -1, is_dup 0), so
# selecting it over the main probe result is a miss.
TOMBSTONE = -2


@dataclasses.dataclass(frozen=True)
class DeltaTable:
    """Small bucketed hash map holding the net not-yet-merged ops.

    ``keys[b, s]`` is the key owning slot ``s`` of bucket ``b`` (EMPTY_KEY
    if free) and ``words[b, s]`` its packed word: ``payload << 1`` for
    inserts and upserts, ``TOMBSTONE`` for deletes.  ``fill[b]`` counts the
    occupied slots of bucket ``b``, tombstones included.  Keys are raw
    dimension keys at the engine layer (a new key has no dictionary code
    yet), hence the Fibonacci hash.
    """

    keys: torch.Tensor      # (num_buckets, bucket_width) int32
    words: torch.Tensor     # (num_buckets, bucket_width) int32
    fill: torch.Tensor      # (num_buckets,) int32
    n_ops: torch.Tensor     # () int32 batch entries absorbed since creation
    overflow: torch.Tensor  # () bool: an entry could not be placed
    hash_mode: str = HASH_FIBONACCI

    @property
    def num_buckets(self) -> int:
        return self.keys.shape[0]

    @property
    def bucket_width(self) -> int:
        return self.keys.shape[1]

    @property
    def num_slots(self) -> int:
        return self.keys.shape[0] * self.keys.shape[1]


def empty_delta(num_buckets: int, bucket_width: int = 8,
                hash_mode: str = HASH_FIBONACCI, device=None) -> DeltaTable:
    """A fresh delta buffer.  ``num_buckets`` must be a power of two."""
    if num_buckets & (num_buckets - 1):
        raise ValueError(f"num_buckets must be a power of two, got "
                         f"{num_buckets}")
    i32 = dict(dtype=torch.int32, device=device)
    return DeltaTable(
        keys=torch.full((num_buckets, bucket_width), EMPTY_KEY, **i32),
        words=torch.zeros((num_buckets, bucket_width), **i32),
        fill=torch.zeros((num_buckets,), **i32),
        n_ops=torch.zeros((), **i32),
        overflow=torch.zeros((), dtype=torch.bool, device=device),
        hash_mode=hash_mode)


def suggest_delta_buckets(n_build: int, bucket_width: int = 8,
                          frac: float = 0.125) -> int:
    """Power-of-two delta bucket count sized to a fraction of the build
    (``frac`` of the build rows at load 0.5)."""
    want = max(256, int(n_build * frac)) / (bucket_width * 0.5)
    return 1 << max(0, int(want) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class DeltaStats:
    """Host-side occupancy summary (planner input for compaction)."""

    n_entries: int      # occupied slots (net ops: inserts/upserts+tombstones)
    n_tombstones: int
    num_slots: int
    max_bucket_fill: int
    bucket_width: int

    @property
    def fill_frac(self) -> float:
        return self.n_entries / max(1, self.num_slots)

    @property
    def worst_bucket_frac(self) -> float:
        return self.max_bucket_fill / max(1, self.bucket_width)


def delta_is_empty(delta: DeltaTable | None) -> bool:
    """True when the delta buffers no live ops (compaction is a no-op)."""
    return delta is None or not bool(delta.fill.any())


def delta_stats(delta: DeltaTable) -> DeltaStats:
    """Occupancy of a delta buffer, read back to the host."""
    occupied = delta.keys != EMPTY_KEY
    return DeltaStats(
        n_entries=int(occupied.sum()),
        n_tombstones=int((occupied & (delta.words == TOMBSTONE)).sum()),
        num_slots=delta.num_slots,
        max_bucket_fill=int(delta.fill.max()),
        bucket_width=delta.bucket_width)


# ---------------------------------------------------------------------------
# Batched ops
# ---------------------------------------------------------------------------


def _bucket_rank(mask: torch.Tensor, bkt: torch.Tensor,
                 nb: int) -> torch.Tensor:
    """Rank of each masked entry among same-bucket masked entries (0-based).

    Park unmasked entries past the last bucket, group by bucket with a
    stable sort, and subtract each group's first sorted position.
    Unmasked entries get arbitrary ranks (callers gate on ``mask``).
    """
    n = mask.shape[0]
    bkey = torch.where(mask, bkt, nb).to(torch.int32)
    order = torch.sort(bkey, stable=True).indices
    bs = bkey[order].contiguous()
    rank_sorted = (torch.arange(n, dtype=torch.int32, device=bkt.device)
                   - torch.searchsorted(bs, bs).to(torch.int32))
    out = torch.zeros(n, dtype=torch.int32, device=bkt.device)
    out[order] = rank_sorted
    return out


def apply_batch(delta: DeltaTable, keys: torch.Tensor,
                words: torch.Tensor) -> DeltaTable:
    """Upsert a batch of (key, packed word) pairs; last occurrence wins.

    Existing keys are overwritten in place; new keys take the next free
    slots of their bucket.  A bucket with no free slot sets ``overflow``
    and drops the entry: callers grow the delta (``engine/join.py:
    ingest_index``) so ingest stays lossless.
    """
    b = keys.shape[0]
    nb, bw = delta.keys.shape
    dev = delta.keys.device
    keys = keys.to(device=dev, dtype=torch.int32)
    words = words.to(device=dev, dtype=torch.int32)

    # last-wins dedup: a stable key sort keeps arrival order within equal
    # keys, so the last element of each run is the newest op
    order = torch.sort(keys, stable=True).indices
    sk, sw = keys[order], words[order]
    is_last = torch.ones(b, dtype=torch.bool, device=dev)
    is_last[:-1] = sk[:-1] != sk[1:]
    valid = is_last & (sk != EMPTY_KEY)

    bkt = hash_bucket(sk, nb, delta.hash_mode)
    rows = delta.keys[bkt.long()]               # (b, bw)
    match = rows == sk[:, None]
    found = match.any(dim=-1) & valid
    slot_existing = torch.argmax(match.to(torch.uint8), dim=-1)

    # fresh entries: rank within their bucket -> fill[bucket] + rank
    is_new = valid & ~found
    slot_new = delta.fill[bkt.long()] + _bucket_rank(is_new, bkt, nb)
    placed = is_new & (slot_new < bw)
    overflow_now = (is_new & (slot_new >= bw)).any()

    slot = torch.where(found, slot_existing, slot_new.long())
    write = found | placed
    # dropped entries land in one trailing park slot that is sliced off;
    # several may land there, in any order, which is harmless only
    # because the slot is cut
    flat = torch.where(write, bkt.long() * bw + slot, nb * bw)
    new_keys = torch.cat([delta.keys.reshape(-1), delta.keys.new_zeros(1)])
    new_words = torch.cat([delta.words.reshape(-1),
                           delta.words.new_zeros(1)])
    new_keys[flat] = sk
    new_words[flat] = sw
    inc = torch.zeros(nb, dtype=torch.int32, device=dev).index_add_(
        0, bkt.long(), placed.to(torch.int32))
    return dataclasses.replace(
        delta,
        keys=new_keys[:nb * bw].reshape(nb, bw),
        words=new_words[:nb * bw].reshape(nb, bw),
        fill=delta.fill + inc,
        n_ops=delta.n_ops + b,
        overflow=delta.overflow | overflow_now)


def insert_batch(delta: DeltaTable, keys: torch.Tensor,
                 payloads: torch.Tensor) -> DeltaTable:
    """Insert (or overwrite) ``key -> payload`` mappings."""
    return apply_batch(delta, keys, payloads.to(torch.int32) << 1)


# upsert == insert at the delta level: one entry per key, last write wins.
upsert_batch = insert_batch


def delete_batch(delta: DeltaTable, keys: torch.Tensor) -> DeltaTable:
    """Tombstone ``keys``: probes report them missing until compaction."""
    return apply_batch(delta, keys, torch.full(keys.shape, TOMBSTONE,
                                               dtype=torch.int32))


def delta_lookup(delta: DeltaTable, keys: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(hit, packed word) per key: one bucket gather, the main probe's
    comparator-array semantics.  A tombstone hit returns ``TOMBSTONE``
    (== ``NULL_WORD``)."""
    k = keys.to(torch.int32)
    bkt = hash_bucket(k, delta.num_buckets, delta.hash_mode).long()
    rows_k = delta.keys[bkt]
    rows_w = delta.words[bkt]
    match = rows_k == k[:, None]
    hit = match.any(dim=-1) & (k != EMPTY_KEY)
    slot = torch.argmax(match.to(torch.uint8), dim=-1)
    word = rows_w.gather(1, slot[:, None])[:, 0]
    return hit, word


def delta_entries(delta: DeltaTable
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flat (keys, words, live) view of the buffered ops (merge input)."""
    k = delta.keys.reshape(-1)
    w = delta.words.reshape(-1)
    return k, w, k != EMPTY_KEY


# ---------------------------------------------------------------------------
# Merge/compaction: fold delta entries into the main table bucket-locally
# ---------------------------------------------------------------------------


def merge_entries(table: JSPIMTable, codes: torch.Tensor, words: torch.Tensor,
                  live: torch.Tensor, *, inplace: bool = False
                  ) -> tuple[JSPIMTable, torch.Tensor]:
    """Fold (code, word) ops into ``table`` with bucket-local writes.

    ``codes`` are keys in the table's own key space (dictionary codes at
    the engine layer; new keys must have codes already, see
    ``dictionary.extend_dictionary``).  Two phases, so that a delete can
    free the slot an insert then takes:

    1. deletes (word == TOMBSTONE, code present) clear their cell; updates
       (code present) overwrite their value word in place;
    2. inserts (code absent, not a tombstone) take the k-th empty slot of
       their bucket.

    Returns ``(merged, needs_grow)``; ``needs_grow`` (a () bool tensor) is
    True when some insert found no empty slot, and then the merged table
    is incomplete and the caller must rebuild with more buckets.

    By default the merge writes into copies of the table planes, so
    ``table`` stays unchanged for every holder that still reads it (the
    swap flavor).  With ``inplace`` it writes the touched bucket rows into
    ``table``'s own key and value tensors, O(ops) instead of a copy of the
    planes: only for a caller that nothing else reads the planes through.
    """
    nb, bw = table.keys.shape
    dev = table.keys.device
    codes = codes.to(device=dev, dtype=torch.int32)
    words = words.to(device=dev, dtype=torch.int32)
    live = live.to(dev) & (codes != EMPTY_KEY)
    is_tomb = words == TOMBSTONE

    bkt = hash_bucket(codes, nb, table.hash_mode).long()
    rows_k = table.keys[bkt]                     # (d, bw)
    match = rows_k == codes[:, None]
    found = match.any(dim=-1) & live
    slot = torch.argmax(match.to(torch.uint8), dim=-1)
    cur_word = table.values[bkt].gather(1, slot[:, None])[:, 0]
    cur_dup = (cur_word & 1) == 1
    ng = table.group_count.shape[0]
    cur_rows = torch.where(
        cur_dup, table.group_count[(cur_word >> 1).clamp(0, ng - 1).long()],
        1)

    keys, values = ((table.keys, table.values) if inplace
                    else (table.keys.clone(), table.values.clone()))
    flat_k, flat_v = keys.view(-1), values.view(-1)

    # ---- phase 1: deletes clear, updates overwrite ----------------------
    del_mask = found & is_tomb
    upd_mask = found & ~is_tomb
    flat = bkt * bw + slot
    flat_k[flat[del_mask]] = EMPTY_KEY
    flat_v[flat[del_mask]] = 0
    flat_v[flat[upd_mask]] = words[upd_mask]

    # ---- phase 2: inserts take the k-th empty slot of their bucket -------
    ins = live & ~found & ~is_tomb
    empty = keys[bkt] == EMPTY_KEY               # post-delete bucket rows
    rank = _bucket_rank(ins, bkt, nb)
    # index of the (rank+1)-th empty lane: the cumsum increments exactly at
    # empty lanes, so the first position reaching rank+1 is itself empty;
    # bw when the bucket has too few empties
    ecum = torch.cumsum(empty.to(torch.int32), dim=-1).to(torch.int32)
    slot_ins = (ecum < (rank + 1)[:, None]).sum(dim=-1).to(torch.int32)
    placed = ins & (slot_ins < bw)
    needs_grow = (ins & (slot_ins >= bw)).any()
    flat_ins = (bkt * bw + slot_ins)[placed]
    flat_k[flat_ins] = codes[placed]
    flat_v[flat_ins] = words[placed]

    n_ins = placed.sum().to(torch.int32)
    n_del = del_mask.sum().to(torch.int32)
    rows_removed = torch.where(del_mask, cur_rows, 0).sum()
    rows_collapsed = torch.where(upd_mask, cur_rows - 1, 0).sum()
    merged = dataclasses.replace(
        table, keys=keys, values=values,
        n_unique=(table.n_unique + n_ins - n_del).to(torch.int32),
        n_build=(table.n_build + n_ins
                 - (rows_removed + rows_collapsed).to(torch.int32)
                 ).to(torch.int32))
    return merged, needs_grow
