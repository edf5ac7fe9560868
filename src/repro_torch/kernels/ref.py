"""Plain PyTorch versions of the kernels (the correctness contract).

Each function takes pre-gathered ``(m, W)`` bucket rows, exactly like the
JAX package's ``repro.kernels.ref`` oracles, and is bit-identical to them:
all arithmetic is int32 and wraps mod 2^32.  The kernel wrappers' plain
paths gather ``table[bucket_ids]`` and call these.
"""
from __future__ import annotations

import torch

from repro_torch.core.hash_table import EMPTY_KEY
from repro_torch.core.lookup import NULL_WORD, unpack_words

__all__ = ["NULL_WORD", "unpack_words", "probe_rows_ref", "bucket_probe_ref",
           "probe_filter_rows_ref", "probe_filter_rows_delta_ref",
           "fused_query_ref", "segment_sum"]


def _select_sum(match: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Sum of the matching lanes, wrapped to int32 (at most one match)."""
    return torch.where(match, rows, 0).sum(dim=1).to(torch.int32)


def probe_rows_ref(probe_keys, rows_k, rows_v):
    """Comparator-array semantics over pre-activated bucket rows:
    (m,), (m, W), (m, W) -> (m,) packed words, NULL_WORD when absent."""
    match = rows_k == probe_keys[:, None]
    found = match.any(dim=1) & (probe_keys != EMPTY_KEY)
    return torch.where(found, _select_sum(match, rows_v), NULL_WORD)


def bucket_probe_ref(table_keys, table_vals, probe_keys, bucket_ids):
    """Streaming probe: activate row ``bucket_ids[i]`` per probe, then the
    comparator-array select.  (B, W) x2, (m,) x2 -> (m,) packed words."""
    b = bucket_ids.long()
    return probe_rows_ref(probe_keys, table_keys[b], table_vals[b])


def probe_filter_rows_ref(probe_keys, rows_k, rows_v, rows_p):
    """Fused probe + per-slot predicate (§4.1.5 filter-on-the-fly): a match
    whose predicate bit is 0 returns NULL_WORD."""
    match = rows_k == probe_keys[:, None]
    found = match.any(dim=1) & (probe_keys != EMPTY_KEY)
    pred = _select_sum(match, rows_p) > 0
    return torch.where(found & pred, _select_sum(match, rows_v), NULL_WORD)


def probe_filter_rows_delta_ref(probe_keys, rows_k, rows_v, rows_p,
                                delta_keys, drows_k, drows_w):
    """Delta-aware fused probe + predicate (§3.2.3 + §4.1.5): the main
    probe is ``probe_filter_rows_ref``; the raw ``delta_keys`` probe the
    delta bucket rows, and a delta hit overrides the main word.
    ``drows_w`` is predicate-folded: tombstones and filtered-out delta
    payloads carry NULL_WORD."""
    main = probe_filter_rows_ref(probe_keys, rows_k, rows_v, rows_p)
    dmatch = drows_k == delta_keys[:, None]
    dhit = dmatch.any(dim=1) & (delta_keys != EMPTY_KEY)
    return torch.where(dhit, _select_sum(dmatch, drows_w), main)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """int32 segment sum that drops out-of-range ids, as
    ``jax.ops.segment_sum`` does.

    Only non-zero contributions are added: a query's masked-out rows carry
    0 at segment 0, and adding them all there serialises the atomics of
    ``index_add_`` on one address (an int32 zero changes no sum).
    """
    keep = (segment_ids >= 0) & (segment_ids < num_segments) & (data != 0)
    out = torch.zeros(num_segments, dtype=torch.int32, device=data.device)
    return out.index_add_(0, segment_ids[keep].long(),
                          data[keep].to(torch.int32))


def fused_query_ref(dim_operands, fmeasure, *, num_segments: int):
    """One-launch probe -> filter -> aggregate semantics.

    ``dim_operands`` holds per-dimension ``(pk, rows_k, rows_a)`` or, with
    a live delta, ``(pk, rows_k, rows_a, dpk, drows_k, drows_a)``, where
    ``rows_a`` is the attribute plane ``(group_key*stride << 1) | pred_bit``
    (-1 for dup/invalid slots and tombstones).  ``fmeasure`` is the
    fact-filter-masked measure.  Returns ``(total, groups)``, int32.
    """
    m = fmeasure.shape[0]
    dev = fmeasure.device
    mask = torch.ones(m, dtype=torch.bool, device=dev)
    gk = torch.zeros(m, dtype=torch.int32, device=dev)
    for ops in dim_operands:
        pk, rows_k, rows_a = ops[:3]
        match = rows_k == pk[:, None]
        found = match.any(dim=1) & (pk != EMPTY_KEY)
        attr = torch.where(found, _select_sum(match, rows_a), -1)
        if len(ops) == 6:
            dpk, drows_k, drows_a = ops[3:]
            dmatch = drows_k == dpk[:, None]
            dhit = dmatch.any(dim=1) & (dpk != EMPTY_KEY)
            attr = torch.where(dhit, _select_sum(dmatch, drows_a), attr)
        mask &= (attr >= 0) & ((attr & 1) == 1)
        gk += torch.where(attr >= 0, attr >> 1, 0)
    groups = segment_sum(torch.where(mask, fmeasure.to(torch.int32), 0),
                         torch.where(mask, gk, 0), num_segments)
    return groups.sum().to(torch.int32), groups
