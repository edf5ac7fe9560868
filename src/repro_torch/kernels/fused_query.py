"""Wrapper for the one-launch SSB query CUDA kernel (``csrc/fused_query.cu``).

Replaces ``repro/kernels/fused_query.py:fused_query``.  One launch per query
probes every joined dimension, decodes the per-slot attribute plane
(``(group_key*stride << 1) | pred_bit``, -1 for dup/invalid slots and
tombstones), applies the optional delta override, ANDs the predicate bits,
sums the group keys and segment-sums the masked measure.

Operands per dimension: ``(pk, table_keys, table_attr, hash_mode)`` or,
with a live delta, ``(pk, table_keys, table_attr, hash_mode, dpk,
delta_keys, delta_attr, delta_hash_mode)``.  The kernel hashes ``pk``
(``dpk``) into the planes' buckets itself (the bucket count is the planes'
first dimension) and reads the bucket rows from the ``(B, W)`` planes.
Before it, ``pack_query_bits`` (one launch per query) packs every attribute
plane into what the kernel screens on: a pass bit and a byte of passing-key
fingerprints per bucket, and a passing table (per bucket its passing keys
beside their group parts); it counts each plane's passing and occupied
slots (the kernel probes the most selective dimension first), and packs
each delta's pass and occupancy bits per bucket.  A CPU tensor takes the
plain versions: ``fused_query_plain`` hashes with ``hash_bucket``, gathers
``plane[bucket_ids]`` and applies ``kernels/ref.fused_query_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.hash_table import (EMPTY_KEY, HASH_FIBONACCI,
                                         hash_bucket)
from repro_torch.kernels import _build, ref
from repro_torch.kernels.bucket_probe import (_check_cuda, _check_operands,
                                              _hash_code, _pack_words,
                                              _stream, pack_bits_plain)

MAX_DIMS = 4


def _hashed(ops):
    """One dimension's operands with its planes gathered at the hashed
    buckets: what ``ref.fused_query_ref`` takes."""
    pk, tk, ta, mode = ops[:4]
    b = hash_bucket(pk, tk.shape[0], mode).long()
    out = (pk, tk[b], ta[b])
    if len(ops) == 8:
        dpk, dtk, dta, dmode = ops[4:]
        db = hash_bucket(dpk, dtk.shape[0], dmode).long()
        out += (dpk, dtk[db], dta[db])
    return out


def fused_query_plain(dim_operands, fmeasure, *, num_segments: int):
    """The plain version of ``fused_query``: hash, gather, then ``ref``."""
    return ref.fused_query_ref(tuple(_hashed(ops) for ops in dim_operands),
                               fmeasure, num_segments=num_segments)


def passing_slots(keys: torch.Tensor, attr: torch.Tensor):
    """(B, W) key and attribute planes -> (B, W) bool pass per slot, and
    the wrapping int32 sum behind it.

    A probe of key ``k`` sums the attributes of the lanes of its bucket that
    hold ``k``; slot ``(b, j)`` passes where ``keys[b, j]`` is not EMPTY_KEY
    and that sum for ``k = keys[b, j]`` is >= 0 and odd.  Exact on any
    plane, duplicate keys in a bucket included.
    """
    same = keys[:, :, None] == keys[:, None, :]
    sums = torch.where(same, attr[:, None, :].to(torch.int64), 0).sum(dim=2)
    sums = sums.to(torch.int32)  # wraps mod 2^32
    return (keys != EMPTY_KEY) & (sums >= 0) & ((sums & 1) == 1), sums


_FIB = 2654435769


def fingers(keys: torch.Tensor, num_buckets: int, mode: str) -> torch.Tensor:
    """``finger_of`` in ``csrc/fused_query.cu``: three hash bits beside
    the bucket's -- the bits just above the bucket bits of the key
    (identity), or just below them in the uint32 Fibonacci product."""
    bits = max(1, (num_buckets - 1).bit_length())
    u = keys.to(torch.int64) & 0xFFFFFFFF
    if mode != HASH_FIBONACCI:
        return (u >> bits) & 7
    # the uint32 product, in int64 halves as hash_bucket computes it
    p = (u * (_FIB & 0xFFFF) + (((u * (_FIB >> 16)) & 0xFFFF) << 16)) \
        & 0xFFFFFFFF
    shift = 32 - bits
    return (p >> (shift - 3) if shift >= 3 else p) & 7


def passing_rows(keys: torch.Tensor, passing: torch.Tensor,
                 sums: torch.Tensor) -> torch.Tensor:
    """(B, W, 2) int32: per bucket its passing keys, each once in lane
    order (a key's first lane), beside their group parts (sum >> 1), then
    (EMPTY_KEY, 0)."""
    w = keys.shape[1]
    lanes = torch.arange(w, device=keys.device)
    earlier = (keys[:, :, None] == keys[:, None, :]) \
        & (lanes[None, None, :] < lanes[None, :, None])
    lead = passing & ~earlier.any(dim=2)
    order = torch.sort((~lead).to(torch.int8), dim=1, stable=True).indices
    taken = lead.gather(1, order)
    pairs = torch.stack([torch.where(taken, keys.gather(1, order),
                                     EMPTY_KEY),
                         torch.where(taken, sums.gather(1, order) >> 1, 0)],
                        dim=2)
    return pairs.to(torch.int32).contiguous()


def pack_query_bits_plain(dim_operands):
    """The plain version of ``pack_query_bits``."""
    bits, stats = [], []
    for ops in dim_operands:
        keys, attr, mode = ops[1:4]
        passing, sums = passing_slots(keys, attr)
        eight = torch.arange(8, device=keys.device)
        hit = (fingers(keys, keys.shape[0], mode)[:, :, None] == eight) \
            & passing[:, :, None]
        finger = (hit.any(dim=1).to(torch.int64) << eight).sum(dim=1) \
            .to(torch.uint8)
        delta = (None, None)
        if len(ops) == 8:
            dpassing, _ = passing_slots(ops[5], ops[6])
            delta = (_pack_words(dpassing.any(dim=1)),
                     pack_bits_plain(ops[5], "occupied")[1])
        bits.append((_pack_words(passing.any(dim=1)), finger,
                     passing_rows(keys, passing, sums)) + delta)
        stats.append(torch.stack([passing.sum(), (keys != EMPTY_KEY).sum()]))
    return tuple(bits), torch.stack(stats).to(torch.int64)


def _tables(dim_operands, bits):
    """The launchers' host tables: 11 pointers and 6 integers a dimension
    (pk, tk, ta, bucket bits, fingerprints, passing table, dpk, dtk, dta,
    delta pass bits, delta occupancy bits; B, W, hash mode, DB, DW, delta
    hash mode)."""
    ptrs, ints = [], []
    for ops, dim_bits in zip(dim_operands, bits):
        pk, tk, ta, mode = ops[:4]
        ptrs += [pk.data_ptr(), tk.data_ptr(), ta.data_ptr()]
        ptrs += [t.data_ptr() for t in dim_bits[:3]]
        ints += [tk.shape[0], tk.shape[1], _hash_code(mode)]
        if len(ops) == 8:
            dpk, dtk, dta, dmode = ops[4:]
            ptrs += [dpk.data_ptr(), dtk.data_ptr(), dta.data_ptr()]
            ptrs += [t.data_ptr() for t in dim_bits[3:]]
            ints += [dtk.shape[0], dtk.shape[1], _hash_code(dmode)]
        else:
            ptrs += [0] * 5
            ints += [0, 0, 0]
    return ((ctypes.c_void_p * len(ptrs))(*ptrs),
            (ctypes.c_int64 * len(ints))(*ints))


def _check(dim_operands, fmeasure=None) -> None:
    if not 1 <= len(dim_operands) <= MAX_DIMS or \
            any(len(ops) not in (4, 8) for ops in dim_operands):
        raise ValueError(f"fused_query: 1..{MAX_DIMS} dimensions of 4 or 8 "
                         "operands each")
    vectors = () if fmeasure is None else (fmeasure,)
    for ops in dim_operands:
        for off in range(0, len(ops), 4):
            pk, tk, ta, mode = ops[off:off + 4]
            _check_operands("fused_query", (tk, ta),
                            (pk, *vectors, dim_operands[0][0]))
            _hash_code(mode)


def pack_query_bits(dim_operands):
    """Per dimension ``(bucket_bits, fingers, passing, delta_pass,
    delta_occupancy)``, and ``stats``: (n_dims, 2) int64 (passing slots,
    occupied slots).

    Bucket bit ``b`` of ``bucket_bits`` (int32 words, ``ceil(B / 32)``) is
    set where some slot of bucket ``b`` passes (``passing_slots``);
    ``fingers`` (uint8, ``B``) holds bit ``fingers(key)`` of each passing
    key of bucket ``b``; ``passing`` is ``passing_rows``' (B, W, 2) table.
    Without a delta the last two are ``None``; with one, ``delta_pass``
    holds the delta's bucket pass bits and ``delta_occupancy`` its key
    plane's bucket bits of ``pack_bits(delta_keys, "occupied")``.  One
    launch packs every plane.
    """
    _check(dim_operands)
    dev = dim_operands[0][0].device
    if dev.type == "cpu":
        return pack_query_bits_plain(dim_operands)

    def words(n):
        return torch.empty(n, dtype=torch.int32, device=dev)

    bits = []
    for ops in dim_operands:
        nb, w = ops[1].shape
        _check_cuda("pack_query_bits", ops[1:3], w)
        dim_bits = (words((nb + 31) // 32),
                    torch.empty(nb, dtype=torch.uint8, device=dev),
                    torch.empty((nb, w, 2), dtype=torch.int32, device=dev))
        if len(ops) == 8:
            _check_cuda("pack_query_bits", ops[5:7], ops[5].shape[1])
            dnb = (ops[5].shape[0] + 31) // 32
            dim_bits += (words(dnb), words(dnb))
        else:
            dim_bits += (None, None)
        bits.append(dim_bits)
    stats = torch.zeros((len(dim_operands), 2), dtype=torch.int64,
                        device=dev)
    ptrs, ints = _tables(dim_operands, bits)
    lib = _build.load("fused_query")
    _build.check(lib.fused_pack_launch(ptrs, ints, len(dim_operands),
                                       stats.data_ptr(), _stream()),
                 "pack_query_bits")
    pack_query_bits.launches += 1
    return tuple(bits), stats


def fused_query(dim_operands, fmeasure: torch.Tensor, *,
                num_segments: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One-launch SSB query: ``(total, groups)`` from raw probe operands.

    dim_operands -- 1 to 4 per-dimension tuples (see the module docstring).
    fmeasure -- (m,) int32 measure, already fact-filter-masked to 0.
    num_segments -- composite group-key space size.

    Returns ``total`` () and ``groups`` (num_segments,), int32; ``total``
    is the int32-wrapped sum of ``groups``.  On the card the wrapper first
    launches ``pack_query_bits``.
    """
    _check(dim_operands, fmeasure)
    if fmeasure.device.type == "cpu":
        return fused_query_plain(dim_operands, fmeasure,
                                 num_segments=num_segments)
    m = fmeasure.shape[0]
    groups = torch.zeros(num_segments, dtype=torch.int32,
                         device=fmeasure.device)
    if m == 0:
        return groups.sum().to(torch.int32), groups
    bits, stats = pack_query_bits(dim_operands)
    ptrs, ints = _tables(dim_operands, bits)
    lib = _build.load("fused_query")
    _build.check(lib.fused_query_launch(
        ptrs, ints, len(dim_operands), stats.data_ptr(), fmeasure.data_ptr(),
        m, groups.data_ptr(), num_segments, _stream()), "fused_query")
    fused_query.launches += 1
    return groups.sum().to(torch.int32), groups


fused_query.launches = 0
pack_query_bits.launches = 0
