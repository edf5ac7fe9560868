"""Wrapper for the one-launch SSB query CUDA kernel (``csrc/fused_query.cu``).

Replaces ``repro/kernels/fused_query.py:fused_query``.  One launch per query
probes every joined dimension, decodes the per-slot attribute plane
(``(group_key*stride << 1) | pred_bit``, -1 for dup/invalid slots and
tombstones), applies the optional delta override, ANDs the predicate bits,
sums the group keys and segment-sums the masked measure.

Operands per dimension: ``(pk, bucket_ids, table_keys, table_attr)`` or,
with a live delta, ``(pk, bucket_ids, table_keys, table_attr, dpk,
delta_bucket_ids, delta_keys, delta_attr)``: the kernel gathers bucket rows
itself from the ``(B, W)`` planes.  A CPU tensor takes the plain version
(``kernels/ref.fused_query_ref`` over ``plane[bucket_ids]``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.bucket_probe import (_check_cuda, _check_operands,
                                              _stream)

MAX_DIMS = 4
# persistent grid: blocks per SM for the grid-stride loop
_BLOCKS_PER_SM = 4


def _gather(ops):
    pk, bids, tk, ta = ops[:4]
    b = bids.long()
    out = (pk, tk[b], ta[b])
    if len(ops) == 8:
        dpk, dbids, dtk, dta = ops[4:]
        db = dbids.long()
        out += (dpk, dtk[db], dta[db])
    return out


def fused_query_plain(dim_operands, fmeasure, *, num_segments: int):
    """The plain version of ``fused_query``: gather, then ``ref``."""
    return ref.fused_query_ref(tuple(_gather(ops) for ops in dim_operands),
                               fmeasure, num_segments=num_segments)


def fused_query(dim_operands, fmeasure: torch.Tensor, *,
                num_segments: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One-launch SSB query: ``(total, groups)`` from raw probe operands.

    dim_operands -- 1 to 4 per-dimension tuples (see the module docstring).
    fmeasure -- (m,) int32 measure, already fact-filter-masked to 0.
    num_segments -- composite group-key space size.

    Returns ``total`` () and ``groups`` (num_segments,), int32; ``total``
    is the int32-wrapped sum of ``groups``.
    """
    if not 1 <= len(dim_operands) <= MAX_DIMS or \
            any(len(ops) not in (4, 8) for ops in dim_operands):
        raise ValueError(f"fused_query: 1..{MAX_DIMS} dimensions of 4 or 8 "
                         "operands each")
    m = fmeasure.shape[0]
    for ops in dim_operands:
        for off in range(0, len(ops), 4):
            pk, bids, tk, ta = ops[off:off + 4]
            _check_operands("fused_query", (tk, ta), (pk, bids, fmeasure))
    if fmeasure.device.type == "cpu":
        return fused_query_plain(dim_operands, fmeasure,
                                 num_segments=num_segments)
    ptrs, wpairs = [], []
    for ops in dim_operands:
        _check_cuda("fused_query", ops[2:4], ops[2].shape[1])
        if len(ops) == 8:
            _check_cuda("fused_query", ops[6:8], ops[6].shape[1])
        ptrs += [t.data_ptr() for t in ops] + [0] * (8 - len(ops))
        wpairs += [ops[2].shape[1], ops[6].shape[1] if len(ops) == 8 else 0]
    dev = fmeasure.device
    groups = torch.zeros(num_segments, dtype=torch.int32, device=dev)
    if m == 0:
        return groups.sum().to(torch.int32), groups
    lib = _build.load("fused_query")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = min(-(-m // 256), sms * _BLOCKS_PER_SM)
    _build.check(lib.fused_query_launch(
        (ctypes.c_void_p * len(ptrs))(*ptrs),
        (ctypes.c_int32 * len(wpairs))(*wpairs), len(dim_operands),
        fmeasure.data_ptr(), m, groups.data_ptr(), num_segments, grid,
        _stream()), "fused_query")
    fused_query.launches += 1
    return groups.sum().to(torch.int32), groups


fused_query.launches = 0
