"""Wrappers for the bucket-probe CUDA kernels (``csrc/bucket_probe.cu``).

Each replaces the kernel of the same name in ``repro/kernels/
bucket_probe.py``: ``probe_rows``, ``probe_filter_rows``,
``probe_filter_rows_delta`` and ``bucket_probe_stream``.  All take the
``(B, W)`` table planes and per-probe bucket ids and gather each bucket row
inside the kernel, so the ``(m, W)`` rows the TPU kernels consume never
reach device memory.  ``bucket_probe_stream`` computes what ``probe_rows``
computes, with W lanes of a warp per probe instead of one thread.

Dispatch: a CUDA tensor launches the kernel (and raises if it cannot be
built or launched); a CPU tensor takes the plain version, which gathers
``table[bucket_ids]`` and applies ``kernels/ref.py``.  ``launches`` on each
wrapper counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def _check_operands(what: str, planes, vectors) -> tuple[int, int]:
    """Validate the kernel operands; returns (m, W)."""
    dev = vectors[0].device
    for t in (*planes, *vectors):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{what}: operands must be contiguous int32 "
                             f"tensors on one device, got {t.dtype} "
                             f"contiguous={t.is_contiguous()} on {t.device}")
    shape = planes[0].shape
    m = vectors[0].shape[0]
    if len(shape) != 2 or any(p.shape != shape for p in planes) or \
            any(v.shape != (m,) for v in vectors):
        raise ValueError(f"{what}: planes must share one (B, W) shape and "
                         f"probe vectors one (m,) shape")
    return m, shape[1]


def _check_cuda(what: str, planes, w: int) -> None:
    """What the CUDA kernels additionally need: whole int4 row loads."""
    if planes[0].device.type != "cuda":
        raise ValueError(f"{what}: tensors on {planes[0].device} (CPU "
                         "tensors take the plain version, CUDA tensors the "
                         "kernel)")
    if w % 4 or w > 128 or w & (w - 1):
        raise ValueError(f"{what}: bucket width {w} unsupported on CUDA "
                         "(a power of two from 4 to 128)")
    if any(p.data_ptr() % 16 for p in planes):
        raise ValueError(f"{what}: table planes must be 16-byte aligned")


def probe_rows_plain(table_keys, table_vals, probe_keys, bucket_ids):
    """The plain version of ``probe_rows``: gather, then ``ref``."""
    return ref.bucket_probe_ref(table_keys, table_vals, probe_keys,
                                bucket_ids)


# the stream kernel computes what probe_rows computes
bucket_probe_stream_plain = probe_rows_plain


def probe_filter_rows_plain(table_keys, table_vals, table_pred, probe_keys,
                            bucket_ids):
    """The plain version of ``probe_filter_rows``: gather, then ``ref``."""
    b = bucket_ids.long()
    return ref.probe_filter_rows_ref(probe_keys, table_keys[b],
                                     table_vals[b], table_pred[b])


def probe_filter_rows_delta_plain(table_keys, table_vals, table_pred,
                                  probe_keys, bucket_ids, delta_keys,
                                  delta_words, raw_keys, delta_bucket_ids):
    """The plain version of ``probe_filter_rows_delta``: gather, then
    ``ref``."""
    b, db = bucket_ids.long(), delta_bucket_ids.long()
    return ref.probe_filter_rows_delta_ref(
        probe_keys, table_keys[b], table_vals[b], table_pred[b], raw_keys,
        delta_keys[db], delta_words[db])


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def probe_rows(table_keys: torch.Tensor, table_vals: torch.Tensor,
               probe_keys: torch.Tensor,
               bucket_ids: torch.Tensor) -> torch.Tensor:
    """(B, W) x2, (m,) keys, (m,) bucket ids -> (m,) packed value words.

    ``bucket_ids`` must come from ``hash_bucket`` over ``B`` buckets.
    """
    planes = (table_keys, table_vals)
    m, w = _check_operands("probe_rows", planes, (probe_keys, bucket_ids))
    if probe_keys.device.type == "cpu":
        return probe_rows_plain(*planes, probe_keys, bucket_ids)
    _check_cuda("probe_rows", planes, w)
    out = torch.empty(m, dtype=torch.int32, device=probe_keys.device)
    if m == 0:
        return out
    lib = _build.load("bucket_probe")
    _build.check(lib.probe_rows_launch(
        table_keys.data_ptr(), table_vals.data_ptr(), probe_keys.data_ptr(),
        bucket_ids.data_ptr(), out.data_ptr(), m, w, _stream()),
        "probe_rows")
    probe_rows.launches += 1
    return out


def bucket_probe_stream(table_keys: torch.Tensor, table_vals: torch.Tensor,
                        probe_keys: torch.Tensor,
                        bucket_ids: torch.Tensor) -> torch.Tensor:
    """The streaming schedule's probe: ``probe_rows``'s operands and
    result, with ``min(W, 32)`` lanes of a warp sharing each probe."""
    planes = (table_keys, table_vals)
    m, w = _check_operands("bucket_probe_stream", planes,
                           (probe_keys, bucket_ids))
    if probe_keys.device.type == "cpu":
        return bucket_probe_stream_plain(*planes, probe_keys, bucket_ids)
    _check_cuda("bucket_probe_stream", planes, w)
    out = torch.empty(m, dtype=torch.int32, device=probe_keys.device)
    if m == 0:
        return out
    lib = _build.load("bucket_probe")
    _build.check(lib.bucket_probe_stream_launch(
        table_keys.data_ptr(), table_vals.data_ptr(), probe_keys.data_ptr(),
        bucket_ids.data_ptr(), out.data_ptr(), m, w, _stream()),
        "bucket_probe_stream")
    bucket_probe_stream.launches += 1
    return out


def probe_filter_rows(table_keys: torch.Tensor, table_vals: torch.Tensor,
                      table_pred: torch.Tensor, probe_keys: torch.Tensor,
                      bucket_ids: torch.Tensor) -> torch.Tensor:
    """Fused probe + predicate: (B, W) x3, (m,) x2 -> (m,) packed words.

    ``table_pred`` is the int32 0/1 per-slot predicate plane
    (``ops.slot_predicate``).  NULL_WORD for misses and filtered matches.
    """
    planes = (table_keys, table_vals, table_pred)
    m, w = _check_operands("probe_filter_rows", planes,
                           (probe_keys, bucket_ids))
    if probe_keys.device.type == "cpu":
        return probe_filter_rows_plain(*planes, probe_keys, bucket_ids)
    _check_cuda("probe_filter_rows", planes, w)
    out = torch.empty(m, dtype=torch.int32, device=probe_keys.device)
    if m == 0:
        return out
    lib = _build.load("bucket_probe")
    _build.check(lib.probe_filter_rows_launch(
        table_keys.data_ptr(), table_vals.data_ptr(), table_pred.data_ptr(),
        probe_keys.data_ptr(), bucket_ids.data_ptr(), out.data_ptr(), m, w,
        _stream()), "probe_filter_rows")
    probe_filter_rows.launches += 1
    return out


def probe_filter_rows_delta(table_keys: torch.Tensor,
                            table_vals: torch.Tensor,
                            table_pred: torch.Tensor,
                            probe_keys: torch.Tensor,
                            bucket_ids: torch.Tensor,
                            delta_keys: torch.Tensor,
                            delta_words: torch.Tensor,
                            raw_keys: torch.Tensor,
                            delta_bucket_ids: torch.Tensor) -> torch.Tensor:
    """``probe_filter_rows`` plus the delta overlay -> (m,) packed words.

    The first five operands are ``probe_filter_rows``'s.  ``delta_keys``
    and ``delta_words`` are the delta's ``(DB, DW)`` key plane and its
    predicate-folded word plane (``ops.delta_slot_words``); ``raw_keys``
    probe it at ``delta_bucket_ids``.  A delta hit overrides the main
    word, even with NULL_WORD.
    """
    planes = (table_keys, table_vals, table_pred)
    dplanes = (delta_keys, delta_words)
    m, w = _check_operands("probe_filter_rows_delta", planes,
                           (probe_keys, bucket_ids))
    _, dw = _check_operands("probe_filter_rows_delta", dplanes,
                            (raw_keys, delta_bucket_ids, probe_keys))
    if probe_keys.device.type == "cpu":
        return probe_filter_rows_delta_plain(*planes, probe_keys, bucket_ids,
                                             *dplanes, raw_keys,
                                             delta_bucket_ids)
    _check_cuda("probe_filter_rows_delta", planes, w)
    _check_cuda("probe_filter_rows_delta", dplanes, dw)
    out = torch.empty(m, dtype=torch.int32, device=probe_keys.device)
    if m == 0:
        return out
    lib = _build.load("bucket_probe")
    _build.check(lib.probe_filter_rows_delta_launch(
        table_keys.data_ptr(), table_vals.data_ptr(), table_pred.data_ptr(),
        probe_keys.data_ptr(), bucket_ids.data_ptr(), delta_keys.data_ptr(),
        delta_words.data_ptr(), raw_keys.data_ptr(),
        delta_bucket_ids.data_ptr(), out.data_ptr(), m, w, dw, _stream()),
        "probe_filter_rows_delta")
    probe_filter_rows_delta.launches += 1
    return out


probe_rows.launches = 0
bucket_probe_stream.launches = 0
probe_filter_rows.launches = 0
probe_filter_rows_delta.launches = 0
