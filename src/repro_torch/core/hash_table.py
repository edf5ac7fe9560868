"""JSPIM hash dataset: bucketed unique-key hash table + duplication list.

PyTorch port of ``repro.core.hash_table`` (§3.2.1 / Algorithm 1 of the
paper): one entry per distinct key in ``bucket_width``-lane buckets, each
value word ``payload << 1 | dup`` where the tag bit selects between a
direct dimension-row payload and a duplication-group id in the CSR
``dup_offsets``/``dup_indices`` table.  ``EMPTY_KEY`` marks unused slots.

The build is sort-based and runs eagerly on whatever device the input
tensors live on.  Every array is int32 and equal, element for element, to
the JAX package's build on the same keys.
"""
from __future__ import annotations

import dataclasses

import torch

EMPTY_KEY = -0x7FFFFFFF             # null slot marker
HASH_IDENTITY = "identity"          # dict-encoded keys: low index bits
HASH_FIBONACCI = "fibonacci"        # raw keys: multiplicative hash
_FIB = 2654435769                   # 2^32 / golden ratio
_U32 = 0xFFFFFFFF


def hash_bucket(keys: torch.Tensor, num_buckets: int,
                mode: str) -> torch.Tensor:
    """Map keys to bucket ids.  ``num_buckets`` must be a power of two."""
    mask = num_buckets - 1
    if mode == HASH_IDENTITY:
        return (keys & mask).to(torch.int32)
    if mode == HASH_FIBONACCI:
        # the uint32 product of the reference, emulated in int64: split the
        # multiplier in 16-bit halves so no partial product leaves int64
        bits = max(1, (num_buckets - 1).bit_length())
        k = keys.to(torch.int64) & _U32
        lo = k * (_FIB & 0xFFFF)
        hi = ((k * (_FIB >> 16)) & 0xFFFF) << 16
        h = ((lo + hi) & _U32) >> (32 - bits)
        return (h & mask).to(torch.int32)
    raise ValueError(f"unknown hash mode {mode!r}")


@dataclasses.dataclass(frozen=True)
class JSPIMTable:
    """The hash dataset (keys/values planes) + the duplication table."""

    keys: torch.Tensor         # (num_buckets, bucket_width) int32
    values: torch.Tensor       # (num_buckets, bucket_width) int32
    dup_offsets: torch.Tensor  # (capacity + 1,) int32
    dup_indices: torch.Tensor  # (capacity,) int32 build values, key-sorted
    group_count: torch.Tensor  # (capacity,) int32 replicas per distinct key
    n_unique: torch.Tensor     # () int32 distinct keys
    n_build: torch.Tensor      # () int32 build rows
    overflow: torch.Tensor     # () int32 entries dropped by bucket overflow
    hash_mode: str = HASH_IDENTITY

    @property
    def num_buckets(self) -> int:
        return self.keys.shape[0]

    @property
    def bucket_width(self) -> int:
        return self.keys.shape[1]


def _scalar(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=device)


def build_table(keys: torch.Tensor, values: torch.Tensor, *,
                num_buckets: int, bucket_width: int = 128,
                hash_mode: str = HASH_IDENTITY) -> JSPIMTable:
    """Algorithm 1: build hash table H and duplication list L.

    ``keys``/``values`` are the build column and its payloads (typically
    row indices).  ``num_buckets`` must be a power of two.
    """
    if num_buckets & (num_buckets - 1):
        raise ValueError(f"num_buckets must be a power of two, got "
                         f"{num_buckets}")
    keys = keys.to(torch.int32)
    values = values.to(torch.int32)
    dev = keys.device
    n = keys.shape[0]
    i32 = dict(dtype=torch.int32, device=dev)
    if n == 0:
        return JSPIMTable(
            keys=torch.full((num_buckets, bucket_width), EMPTY_KEY, **i32),
            values=torch.zeros((num_buckets, bucket_width), **i32),
            dup_offsets=torch.zeros((2,), **i32),
            dup_indices=torch.zeros((1,), **i32),
            group_count=torch.zeros((1,), **i32),
            n_unique=_scalar(0, dev), n_build=_scalar(0, dev),
            overflow=_scalar(0, dev), hash_mode=hash_mode)

    order = torch.sort(keys, stable=True).indices
    sk, sv = keys[order], values[order]
    is_first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          sk[1:] != sk[:-1]])
    uid = torch.cumsum(is_first, 0) - 1
    n_unique = is_first.sum()

    # ---- duplication table (CSR over every group) ------------------------
    counts = torch.zeros(n, **i32).index_add_(
        0, uid, torch.ones(n, **i32))
    group_start = torch.cat([torch.zeros(1, **i32),
                             torch.cumsum(counts, 0).to(torch.int32)])

    # ---- one hash-table entry per group ----------------------------------
    ar = torch.arange(n, device=dev)
    live = ar < n_unique
    head = torch.clamp(group_start[:-1], max=n - 1).long()
    ukeys = torch.where(live, sk[head], EMPTY_KEY)
    is_dup = counts > 1
    payload = torch.where(is_dup, ar.to(torch.int32), sv[head])
    uvals = (payload << 1) | is_dup.to(torch.int32)

    # ---- place unique keys into buckets ----------------------------------
    b = torch.where(live, hash_bucket(ukeys, num_buckets, hash_mode),
                    num_buckets)
    order2 = torch.sort(b, stable=True).indices
    b_sorted = b[order2]
    bucket_start = torch.searchsorted(
        b_sorted, torch.arange(num_buckets + 1, **i32)).to(torch.int32)
    pos = ar.to(torch.int32) - bucket_start[
        torch.clamp(b_sorted, max=num_buckets).long()]
    parked = b_sorted < num_buckets
    ok = parked & (pos < bucket_width)
    slots = num_buckets * bucket_width
    # dropped entries land in one trailing slot that is sliced off (the
    # reference's scatter with mode="drop")
    flat = torch.where(ok, b_sorted.long() * bucket_width + pos, slots)
    tkeys = torch.full((slots + 1,), EMPTY_KEY, **i32)
    tvals = torch.zeros((slots + 1,), **i32)
    tkeys[flat] = ukeys[order2]
    tvals[flat] = uvals[order2]
    return JSPIMTable(
        keys=tkeys[:slots].reshape(num_buckets, bucket_width),
        values=tvals[:slots].reshape(num_buckets, bucket_width),
        dup_offsets=group_start,
        dup_indices=sv,
        group_count=counts,
        n_unique=n_unique.to(torch.int32),
        n_build=_scalar(n, dev),
        overflow=((~ok) & parked).sum().to(torch.int32),
        hash_mode=hash_mode,
    )


def suggest_num_buckets(n_unique: int, bucket_width: int = 128,
                        load: float = 0.5) -> int:
    """Power-of-two bucket count targeting ``load`` occupancy."""
    need = max(1, int(n_unique / (bucket_width * load)))
    return 1 << (need - 1).bit_length()


def table_entries(table: JSPIMTable
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reconstruct the live logical (key, payload) multiset from a table.

    Inverse of ``build_table`` modulo ordering: every non-dup entry yields
    one row, every dup entry expands its CSR group.  Fixed capacity
    ``num_slots + len(dup_indices)``; returns ``(keys, payloads, valid)``.
    """
    flat_k = table.keys.reshape(-1)
    flat_v = table.values.reshape(-1)
    m = flat_k.shape[0]
    dev = flat_k.device
    live = flat_k != EMPTY_KEY
    is_dup = (flat_v & 1) == 1
    payload = flat_v >> 1
    ng = table.group_count.shape[0]
    counts = torch.where(
        live, torch.where(is_dup,
                          table.group_count[payload.clamp(0, ng - 1).long()],
                          1), 0).to(torch.int32)
    offs = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                      torch.cumsum(counts, 0).to(torch.int32)])
    total = offs[-1]
    cap = m + table.dup_indices.shape[0]
    out_pos = torch.arange(cap, dtype=torch.int32, device=dev)
    src = torch.searchsorted(offs, out_pos, right=True) - 1
    src_c = src.clamp(0, m - 1)
    within = out_pos - offs[src_c]
    grp = payload[src_c].clamp(0, table.dup_offsets.shape[0] - 2).long()
    dup_row = table.dup_indices[(table.dup_offsets[grp] + within).clamp(
        0, table.dup_indices.shape[0] - 1).long()]
    val = torch.where(is_dup[src_c], dup_row, payload[src_c])
    valid = out_pos < total
    return (torch.where(valid, flat_k[src_c], EMPTY_KEY),
            torch.where(valid, val, 0), valid)


# ---------------------------------------------------------------------------
# Update commands (§3.2.3): functional versions of the PIM update interface.
# Each returns a new table; the input's planes are not written, so whoever
# still holds the old table keeps seeing it unchanged.
# ---------------------------------------------------------------------------


def _i32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, device=device).to(torch.int32)


def entry_update(table: JSPIMTable, bucket, slot, key,
                 value_word) -> JSPIMTable:
    """Entry Update: overwrite one (bucket, slot) cell, like a DRAM write."""
    keys, values = table.keys.clone(), table.values.clone()
    dev = keys.device
    keys[bucket, slot] = _i32(key, dev)
    values[bucket, slot] = _i32(value_word, dev)
    return dataclasses.replace(table, keys=keys, values=values)


def index_update(table: JSPIMTable, key, new_payload) -> JSPIMTable:
    """Index Update: search for ``key``; on a match update its payload
    (the word's tag bit is kept)."""
    dev = table.keys.device
    k = _i32(key, dev).reshape(())
    b = hash_bucket(k, table.num_buckets, table.hash_mode).long()
    match = table.keys[b] == k
    slot = torch.argmax(match.to(torch.uint8))
    old = table.values[b, slot]
    word = (_i32(new_payload, dev) << 1) | (old & 1)
    values = table.values.clone()
    values[b, slot] = torch.where(match.any(), word, old)
    # fresh planes, both: the engine counts an update as a new table
    # generation, and an in-place compaction of that generation must not
    # write a keys plane an epoch snapshot still reads
    return dataclasses.replace(table, keys=table.keys.clone(),
                               values=values)


def table_update(table: JSPIMTable, bucket_ids, new_keys,
                 new_values) -> JSPIMTable:
    """Table Update: burst-write whole buckets (rows) at once."""
    keys, values = table.keys.clone(), table.values.clone()
    dev = keys.device
    bids = torch.as_tensor(bucket_ids, device=dev).long()
    keys[bids] = _i32(new_keys, dev)
    values[bids] = _i32(new_values, dev)
    return dataclasses.replace(table, keys=keys, values=values)
