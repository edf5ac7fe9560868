"""JSPIM search-engine semantics: the gathered probe (§3.1.1).

PyTorch port of the part of ``repro.core.lookup`` the ported paths run:
``probe`` (the counterpart of the JAX ``kernel="xla"`` gather path), the
packed-word helpers and the delta overlay (``overlay_delta``,
``probe_with_delta``, gathered schedule).  The deduped and hot/cold
schedules wait for the probe-schedule slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

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
    hit, word = delta_lookup(delta, delta_keys)
    return unpack_words(torch.where(hit, word, pack_words(pr)))


def probe_with_delta(table: JSPIMTable, delta: DeltaTable,
                     probe_keys: torch.Tensor, *,
                     delta_keys: torch.Tensor | None = None) -> ProbeResult:
    """Delta-aware probe: the gathered main probe, then the overlay.
    Bit-identical to compacting the delta into the table and probing
    that.  The other schedules wait for the probe-schedule slice."""
    dk = probe_keys if delta_keys is None else delta_keys
    return overlay_delta(probe(table, probe_keys), delta, dk)
