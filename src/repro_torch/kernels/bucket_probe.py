"""Wrappers for the bucket-probe CUDA kernels (``csrc/bucket_probe.cu``).

Each replaces the kernel of the same name in ``repro/kernels/
bucket_probe.py``: ``probe_rows``, ``probe_filter_rows``,
``probe_filter_rows_delta`` and ``bucket_probe_stream``.  All take the
``(B, W)`` table planes and the table's hash mode (the bucket count is the
planes' first dimension), hash each key and gather each bucket row inside
the kernel, so neither a bucket-id vector nor the ``(m, W)`` rows the TPU
kernels consume ever reach device memory.  The filter kernels read the
predicate plane as bits per slot and per bucket (``pack_bits``).
``probe_rows`` and ``bucket_probe_stream`` compute the same function:
``probe_rows`` one probe a thread, its key row and then the matching
lane's value read straight into registers, ``bucket_probe_stream`` through
a ring of asynchronous key-row copies in shared memory; both probe a table
whose planes fit shared memory from there.

Dispatch: a CUDA tensor launches the kernel (and raises if it cannot be
built or launched); a CPU tensor takes the plain version, which hashes
with ``hash_bucket``, gathers ``table[bucket_ids]`` and applies
``kernels/ref.py``.  ``launches`` on each wrapper counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.hash_table import (EMPTY_KEY, HASH_FIBONACCI,
                                         HASH_IDENTITY, hash_bucket)
from repro_torch.kernels import _build, ref

_HASH_CODE = {HASH_IDENTITY: 0, HASH_FIBONACCI: 1}  # the kernels' hash modes


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


def probe_rows_plain(table_keys, table_vals, probe_keys, hash_mode):
    """The plain version of ``probe_rows``: hash, gather, ``ref``."""
    b = hash_bucket(probe_keys, table_keys.shape[0], hash_mode)
    return ref.bucket_probe_ref(table_keys, table_vals, probe_keys, b)


def bucket_probe_stream_plain(table_keys, table_vals, probe_keys,
                              hash_mode):
    """The plain version of ``bucket_probe_stream``: ``probe_rows_plain``."""
    return probe_rows_plain(table_keys, table_vals, probe_keys, hash_mode)


def _hash_code(hash_mode: str) -> int:
    if hash_mode not in _HASH_CODE:
        raise ValueError(f"unknown hash mode {hash_mode!r}")
    return _HASH_CODE[hash_mode]


_PACK_TESTS = {"positive": 1, "occupied": 0}  # pack_bits_launch's flag


def _pack_words(flags: torch.Tensor) -> torch.Tensor:
    """Flat 0/1 flags -> int32 words of 32 bits (max(1, ceil(n / 32)))."""
    flat = flags.reshape(-1).to(torch.int64)
    n = flat.shape[0]
    flat = torch.nn.functional.pad(flat, (0, -n % 32 if n else 32))
    shifts = torch.arange(32, dtype=torch.int64, device=flat.device)
    words = (flat.view(-1, 32) << shifts).sum(dim=1)
    return (words - ((words >> 31) << 32)).to(torch.int32)  # uint32 bits


def pack_bits_plain(plane: torch.Tensor, test: str):
    """The plain version of ``pack_bits``."""
    slots = plane > 0 if test == "positive" else plane != EMPTY_KEY
    return _pack_words(slots), _pack_words(slots.any(dim=1))


def pack_bits(plane: torch.Tensor, test: str):
    """(B, W) int32 plane -> (slot words, bucket words), int32 bit sets.

    Slot bit ``b W + j`` (bit ``(b W + j) % 32`` of word ``(b W + j) //
    32``; ``max(1, B W / 32)`` words) is ``plane[b, j] > 0`` for ``test=
    "positive"`` (a predicate plane) or ``plane[b, j] != EMPTY_KEY`` for
    ``"occupied"`` (a key plane); bucket bit ``b`` (``ceil(B / 32)``
    words) is set where some slot bit of bucket ``b`` is.  The filter
    kernels read these in place of the planes.
    """
    if test not in _PACK_TESTS:
        raise ValueError(f"pack_bits: unknown test {test!r}")
    if plane.dtype != torch.int32 or plane.dim() != 2 or \
            not plane.is_contiguous():
        raise ValueError("pack_bits: a contiguous (B, W) int32 plane is "
                         f"needed, got {plane.dtype} {tuple(plane.shape)}")
    if plane.device.type == "cpu":
        return pack_bits_plain(plane, test)
    nb, w = plane.shape
    _check_cuda("pack_bits", (plane,), w)
    slots = torch.empty(max(1, nb * w // 32), dtype=torch.int32,
                        device=plane.device)
    buckets = torch.empty((nb + 31) // 32, dtype=torch.int32,
                          device=plane.device)
    lib = _build.load("bucket_probe")
    _build.check(lib.pack_bits_launch(
        plane.data_ptr(), nb, w, _PACK_TESTS[test], slots.data_ptr(),
        buckets.data_ptr(), _stream()), "pack_bits")
    pack_bits.launches += 1
    return slots, buckets


def probe_filter_rows_plain(table_keys, table_vals, table_pred, probe_keys,
                            hash_mode):
    """The plain version of ``probe_filter_rows``: hash, gather, ``ref``."""
    b = hash_bucket(probe_keys, table_keys.shape[0], hash_mode).long()
    return ref.probe_filter_rows_ref(probe_keys, table_keys[b],
                                     table_vals[b], table_pred[b])


def probe_filter_rows_delta_plain(table_keys, table_vals, table_pred,
                                  probe_keys, hash_mode, delta_keys,
                                  delta_words, raw_keys, delta_hash_mode):
    """The plain version of ``probe_filter_rows_delta``: hash, gather,
    ``ref``."""
    b = hash_bucket(probe_keys, table_keys.shape[0], hash_mode).long()
    db = hash_bucket(raw_keys, delta_keys.shape[0], delta_hash_mode).long()
    return ref.probe_filter_rows_delta_ref(
        probe_keys, table_keys[b], table_vals[b], table_pred[b], raw_keys,
        delta_keys[db], delta_words[db])


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def probe_rows(table_keys: torch.Tensor, table_vals: torch.Tensor,
               probe_keys: torch.Tensor, hash_mode: str) -> torch.Tensor:
    """(B, W) x2, (m,) keys -> (m,) packed value words: the sum of the
    matching lanes' values, NULL_WORD on a miss or an EMPTY_KEY probe.

    The kernel hashes each key into the ``B`` buckets itself (``hash_mode``
    is the table's).
    """
    planes = (table_keys, table_vals)
    m, w = _check_operands("probe_rows", planes, (probe_keys,))
    fib = _hash_code(hash_mode)
    if probe_keys.device.type == "cpu":
        return probe_rows_plain(*planes, probe_keys, hash_mode)
    _check_cuda("probe_rows", planes, w)
    out = torch.empty(m, dtype=torch.int32, device=probe_keys.device)
    if m == 0:
        return out
    lib = _build.load("bucket_probe")
    _build.check(lib.probe_rows_launch(
        table_keys.data_ptr(), table_vals.data_ptr(), probe_keys.data_ptr(),
        out.data_ptr(), m, table_keys.shape[0], w, fib, _stream()),
        "probe_rows")
    probe_rows.launches += 1
    return out


def bucket_probe_stream(table_keys: torch.Tensor, table_vals: torch.Tensor,
                        probe_keys: torch.Tensor,
                        hash_mode: str) -> torch.Tensor:
    """The streaming schedule's probe: (B, W) x2, (m,) keys -> (m,) packed
    words, ``probe_rows``'s result.  The kernel hashes each key into the
    ``B`` buckets itself (``hash_mode`` is the table's)."""
    planes = (table_keys, table_vals)
    m, w = _check_operands("bucket_probe_stream", planes, (probe_keys,))
    fib = _hash_code(hash_mode)
    if probe_keys.device.type == "cpu":
        return bucket_probe_stream_plain(*planes, probe_keys, hash_mode)
    _check_cuda("bucket_probe_stream", planes, w)
    out = torch.empty(m, dtype=torch.int32, device=probe_keys.device)
    if m == 0:
        return out
    lib = _build.load("bucket_probe")
    _build.check(lib.bucket_probe_stream_launch(
        table_keys.data_ptr(), table_vals.data_ptr(), probe_keys.data_ptr(),
        out.data_ptr(), m, table_keys.shape[0], w, fib, _stream()),
        "bucket_probe_stream")
    bucket_probe_stream.launches += 1
    return out


def probe_filter_rows(table_keys: torch.Tensor, table_vals: torch.Tensor,
                      table_pred: torch.Tensor, probe_keys: torch.Tensor,
                      hash_mode: str) -> torch.Tensor:
    """Fused probe + predicate: (B, W) x3, (m,) keys -> (m,) packed words.

    The kernel hashes each key into the ``B`` buckets itself (``hash_mode``
    is the table's, ``B`` the planes' first dimension).  ``table_pred`` is
    the int32 0/1 per-slot predicate plane (``ops.slot_predicate``); the
    wrapper packs it with ``pack_bits`` and the kernel tests a matched
    lane's bit.  On a 0/1 plane "a matched lane's bit is set" is the
    reference's "summed matched lanes > 0" (and with at most one match per
    bucket it is so on any plane).  NULL_WORD for misses and filtered
    matches.
    """
    planes = (table_keys, table_vals, table_pred)
    m, w = _check_operands("probe_filter_rows", planes, (probe_keys,))
    fib = _hash_code(hash_mode)
    if probe_keys.device.type == "cpu":
        return probe_filter_rows_plain(*planes, probe_keys, hash_mode)
    _check_cuda("probe_filter_rows", planes, w)
    out = torch.empty(m, dtype=torch.int32, device=probe_keys.device)
    if m == 0:
        return out
    slot_bits, bucket_bits = pack_bits(table_pred, "positive")
    lib = _build.load("bucket_probe")
    _build.check(lib.probe_filter_rows_launch(
        table_keys.data_ptr(), table_vals.data_ptr(), slot_bits.data_ptr(),
        bucket_bits.data_ptr(), probe_keys.data_ptr(), out.data_ptr(), m,
        table_keys.shape[0], w, fib, _stream()), "probe_filter_rows")
    probe_filter_rows.launches += 1
    return out


def probe_filter_rows_delta(table_keys: torch.Tensor,
                            table_vals: torch.Tensor,
                            table_pred: torch.Tensor,
                            probe_keys: torch.Tensor, hash_mode: str,
                            delta_keys: torch.Tensor,
                            delta_words: torch.Tensor,
                            raw_keys: torch.Tensor,
                            delta_hash_mode: str) -> torch.Tensor:
    """``probe_filter_rows`` plus the delta overlay -> (m,) packed words.

    The first five operands are ``probe_filter_rows``'s.  ``delta_keys``
    and ``delta_words`` are the delta's ``(DB, DW)`` key plane and its
    predicate-folded word plane (``ops.delta_slot_words``); the kernel
    hashes ``raw_keys`` into its ``DB`` buckets with ``delta_hash_mode``.
    A delta hit overrides the main word, even with NULL_WORD.
    """
    planes = (table_keys, table_vals, table_pred)
    dplanes = (delta_keys, delta_words)
    m, w = _check_operands("probe_filter_rows_delta", planes, (probe_keys,))
    _, dw = _check_operands("probe_filter_rows_delta", dplanes,
                            (raw_keys, probe_keys))
    fib, dfib = _hash_code(hash_mode), _hash_code(delta_hash_mode)
    if probe_keys.device.type == "cpu":
        return probe_filter_rows_delta_plain(*planes, probe_keys, hash_mode,
                                             *dplanes, raw_keys,
                                             delta_hash_mode)
    _check_cuda("probe_filter_rows_delta", planes, w)
    _check_cuda("probe_filter_rows_delta", dplanes, dw)
    out = torch.empty(m, dtype=torch.int32, device=probe_keys.device)
    if m == 0:
        return out
    slot_bits, bucket_bits = pack_bits(table_pred, "positive")
    _, delta_bits = pack_bits(delta_keys, "occupied")
    lib = _build.load("bucket_probe")
    _build.check(lib.probe_filter_rows_delta_launch(
        table_keys.data_ptr(), table_vals.data_ptr(), slot_bits.data_ptr(),
        bucket_bits.data_ptr(), probe_keys.data_ptr(), delta_keys.data_ptr(),
        delta_words.data_ptr(), delta_bits.data_ptr(), raw_keys.data_ptr(),
        out.data_ptr(), m, table_keys.shape[0], w, fib, delta_keys.shape[0],
        dw, dfib, _stream()), "probe_filter_rows_delta")
    probe_filter_rows_delta.launches += 1
    return out


probe_rows.launches = 0
bucket_probe_stream.launches = 0
probe_filter_rows.launches = 0
probe_filter_rows_delta.launches = 0
pack_bits.launches = 0
