"""Probe entry points over the CUDA kernels, and the kernel registry.

``probe_table`` / ``probe_table_filtered`` / ``probe_table_filtered_delta``
are what ``engine/join.py`` calls on the ``"cuda"`` kernel.  Each hands the
table planes and the table's hash mode to its kernel (``probe_rows`` on the
gathered schedule, ``bucket_probe_stream`` on the stream schedule, the
filter kernels), which hashes each key and gathers each bucket row itself:
no bucket-id vector is made.  ``probe_table_ref`` is the plain reference
probe with the same signature.

``KERNEL_REGISTRY`` lists every hand-written kernel with its plain version,
the TPU kernel it replaces and deterministic operand cases, and
``kernel_supported`` reports whether it holds a kernel for a backend.  The
cases are the JAX registry's (``repro/kernels/ops.py``), drawn from the
same numpy seeds and built with the port's own ``core/delta.py``, in the
port's calling convention: table planes plus the hash mode instead of
gathered rows.  ``coalesce_window_mask`` adds a Zipf stream to the
reference's case.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.delta import (TOMBSTONE, DeltaTable, delete_batch,
                                    empty_delta, upsert_batch)
from repro_torch.core.hash_table import (EMPTY_KEY, HASH_FIBONACCI,
                                         JSPIMTable, build_table, hash_bucket)
from repro_torch.core.lookup import NULL_WORD, ProbeResult, unpack_words
from repro_torch.core.skew import zipf_sample
from repro_torch.kernels.batched_tail import (batched_tail,
                                              batched_tail_plain)
from repro_torch.kernels.bucket_probe import (
    bucket_probe_stream, bucket_probe_stream_plain, probe_filter_rows,
    probe_filter_rows_delta, probe_filter_rows_delta_plain,
    probe_filter_rows_plain, probe_rows, probe_rows_plain)
from repro_torch.kernels.coalesce_window import (coalesce_window_mask,
                                                 coalesce_window_mask_plain)
from repro_torch.kernels.fused_query import fused_query, fused_query_plain
from repro_torch.kernels.ref import bucket_probe_ref


def probe_table(table: JSPIMTable, probe_keys: torch.Tensor, *,
                schedule: str = "gathered") -> ProbeResult:
    """Associative search through the probe kernels.

    ``schedule="gathered"`` runs ``probe_rows`` (one probe a thread, the
    key row and the matching lane's value read into registers);
    ``"stream"`` runs ``bucket_probe_stream`` (a ring of asynchronous
    key-row copies).  Both hash the keys themselves and give the same
    words.
    """
    keys = probe_keys.to(torch.int32)
    if schedule == "gathered":
        words = probe_rows(table.keys, table.values, keys, table.hash_mode)
    elif schedule == "stream":
        words = bucket_probe_stream(table.keys, table.values, keys,
                                    table.hash_mode)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    return unpack_words(words)


def probe_table_ref(table: JSPIMTable, probe_keys: torch.Tensor
                    ) -> ProbeResult:
    """The plain reference probe, with ``probe_table``'s signature."""
    keys = probe_keys.to(torch.int32)
    bids = hash_bucket(keys, table.num_buckets, table.hash_mode)
    return unpack_words(bucket_probe_ref(table.keys, table.values, keys,
                                         bids))


def slot_predicate(table: JSPIMTable, dim_mask: torch.Tensor) -> torch.Tensor:
    """Pre-evaluate a dimension predicate per hash-table slot.

    A unique-key slot's payload is the dimension row, so its bit is
    ``dim_mask[payload]``; duplication-group slots keep 1 (their rows are
    filtered after CSR expansion).  Returns (num_buckets, bucket_width)
    int32 0/1, the third plane of ``probe_filter_rows``.
    """
    payload = table.values >> 1
    is_dup = (table.values & 1).bool()
    n = dim_mask.shape[0]
    hit = dim_mask[payload.clamp(0, n - 1).long()] & (payload >= 0) \
        & (payload < n)
    return (is_dup | hit).to(torch.int32)


def probe_table_filtered(table: JSPIMTable, probe_keys: torch.Tensor,
                         slot_pred: torch.Tensor) -> ProbeResult:
    """Fused associative search + dimension filter (``probe_filter_rows``,
    which hashes the keys itself): ``found`` is True only where the match
    also passes the predicate."""
    return unpack_words(probe_filter_rows(
        table.keys, table.values, slot_pred, probe_keys.to(torch.int32),
        table.hash_mode))


def delta_slot_words(delta: DeltaTable, dim_mask: torch.Tensor
                     ) -> torch.Tensor:
    """Fold a dimension predicate into the delta's word plane.

    Per delta slot: a live payload that passes ``dim_mask`` keeps its
    word; a filtered-out payload and a tombstone both become NULL_WORD, so
    the kernel's "a delta hit overrides" rule needs no other branch.
    Returns (num_buckets, bucket_width) int32.
    """
    payload = delta.words >> 1
    is_tomb = delta.words == TOMBSTONE
    n = dim_mask.shape[0]
    ok = (dim_mask[payload.clamp(0, n - 1).long()]
          & (payload >= 0) & (payload < n))
    return torch.where(~is_tomb & ok, delta.words,
                       NULL_WORD).to(torch.int32)


def probe_table_filtered_delta(table: JSPIMTable, probe_keys: torch.Tensor,
                               slot_pred: torch.Tensor, delta: DeltaTable,
                               raw_keys: torch.Tensor,
                               delta_words: torch.Tensor) -> ProbeResult:
    """``probe_table_filtered`` on an index with a live delta
    (``probe_filter_rows_delta``): ``raw_keys`` probe the delta's key
    plane, and ``delta_words`` comes from ``delta_slot_words``."""
    return unpack_words(probe_filter_rows_delta(
        table.keys, table.values, slot_pred, probe_keys.to(torch.int32),
        table.hash_mode, delta.keys, delta_words, raw_keys.to(torch.int32),
        delta.hash_mode))


# --------------------------------------------------------------------------
# Kernel registry
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelOp:
    """One hand-written kernel: wrapper, plain version, provenance, cases.

    ``fn(*args, **kwargs)`` must be bit-identical to
    ``plain_fn(*args, **kwargs)`` on every case ``make_cases(device)``
    yields (``[(name, args, kwargs)]``, deterministic).  ``fn.launches``
    counts kernel launches.  ``source`` is the CUDA file, ``replaces`` the
    Pallas kernel (file:line of its ``pallas_call``), or ``None`` for a
    kernel that replaces none.
    """

    name: str
    fn: Callable
    plain_fn: Callable
    backends: tuple[str, ...]
    make_cases: Callable[[str], list]
    source: str
    replaces: str | None


KERNEL_REGISTRY: dict[str, KernelOp] = {}


def register_kernel(op: KernelOp) -> KernelOp:
    if op.name in KERNEL_REGISTRY:
        raise ValueError(f"kernel {op.name!r} already registered")
    KERNEL_REGISTRY[op.name] = op
    return op


def kernel_supported(name: str, backend: str) -> bool:
    """True when the registry holds kernel ``name`` for ``backend`` (an
    unknown kernel reports False).  It reports; no path consults it to
    choose a slower one."""
    op = KERNEL_REGISTRY.get(name)
    return op is not None and backend in op.backends


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int32), device=device)


def _probe_cases(device):
    """The reference's probe operands: a hit/miss mix over a small
    Fibonacci-hashed table, at a size that is not a block multiple."""
    rng = np.random.default_rng(7)
    n, m = 64, 83
    keys = np.arange(n, dtype=np.int32) * 3
    payloads = rng.integers(0, 1 << 20, n).astype(np.int32)
    table = build_table(_t(keys, device), _t(payloads, device),
                        num_buckets=32, bucket_width=8,
                        hash_mode=HASH_FIBONACCI)
    pk = rng.choice(keys, m).astype(np.int32)
    pk[::7] = 10_001  # guaranteed misses (not a multiple of 3)
    pk[5] = EMPTY_KEY
    return table, _t(pk, device)


def _probe_rows_cases(device="cpu"):
    table, pk = _probe_cases(device)
    return [("hit_miss_mix", (table.keys, table.values, pk, table.hash_mode),
             {})]


def _filter_cases(device="cpu"):
    table, pk = _probe_cases(device)
    mask = torch.as_tensor(np.arange(64) % 3 == 0, device=device)
    pred = slot_predicate(table, mask)
    return [("pred_mix", (table.keys, table.values, pred, pk,
                          table.hash_mode), {})]


def _delta_states(device):
    """(state, delta) across the reference's empty / live / tombstone axis:
    upsert {3: 7, 9: 1, 10001: 40}, then delete {9, 30}."""
    empty = empty_delta(16, 8, hash_mode=HASH_FIBONACCI, device=device)
    live = upsert_batch(empty, _t([3, 9, 10_001], device),
                        _t([7, 1, 40], device))
    tomb = delete_batch(live, _t([9, 30], device))
    return [("delta_empty", empty), ("delta_live", live),
            ("delta_tombstone", tomb)]


def _filter_delta_cases(device="cpu"):
    table, pk = _probe_cases(device)
    mask = torch.as_tensor(np.arange(64) % 3 == 0, device=device)
    pred = slot_predicate(table, mask)
    raw = pk  # the case table holds raw keys: raw key == probe key
    cases = []
    for state, delta in _delta_states(device):
        dwords = delta_slot_words(delta, mask)
        cases.append((state, (table.keys, table.values, pred, pk,
                              table.hash_mode, delta.keys, dwords, raw,
                              delta.hash_mode), {}))
    return cases


def _fused_query_cases(device="cpu"):
    table, pk = _probe_cases(device)
    rng = np.random.default_rng(11)
    n_rows, card = 64, 5
    mask = torch.as_tensor(np.arange(n_rows) % 3 == 0, device=device)
    gcol = _t(rng.integers(0, card, n_rows), device)

    def attr_of(words, invalid):
        payload = words >> 1
        clip = payload.clamp(0, n_rows - 1).long()
        valid = (payload >= 0) & (payload < n_rows) & ~invalid
        return torch.where(valid, ((gcol[clip] % card) << 1)
                           | mask[clip].to(torch.int32), -1).to(torch.int32)

    attr = attr_of(table.values, (table.values & 1) == 1)
    fmeasure = _t(rng.integers(0, 1000, pk.shape[0]), device)
    main = (pk, table.keys, attr, table.hash_mode)
    cases = [("no_delta", ((main,), fmeasure), {"num_segments": card})]
    for state, delta in _delta_states(device):
        dattr = attr_of(delta.words, delta.words == TOMBSTONE)
        dim_ops = (main + (pk, delta.keys, dattr, delta.hash_mode),)
        cases.append((state, (dim_ops, fmeasure), {"num_segments": card}))
    return cases


def _tail_case(device, rng, n, dims, n_requests, op, fact_filter,
               offset=0):
    """Random ``batched_tail`` operands: ``dims`` lists ``(n_dim, pred,
    card)`` (``card`` 0: not grouped), a tenth of the rows miss (``dim_row``
    -1) and a few found rows point past the table (clamped); measures near
    2^31 overflow.  ``offset`` > 0 takes every fact-row vector as a slice
    starting that many elements in, so it is not 16-byte aligned."""
    def vec(a):
        a = np.concatenate([np.zeros(offset, a.dtype), a])
        return torch.as_tensor(a, device=device)[offset:]

    size = int(np.prod([c for _, _, c in dims if c]))
    stride = size
    dim_ops = []
    for n_dim, pred, card in dims:
        found = rng.random(n) > 0.1
        row = rng.integers(0, n_dim, n).astype(np.int32)
        row[rng.random(n) < 0.02] = n_dim + 5
        row = np.where(found, row, -1).astype(np.int32)
        words = group = None
        if pred:
            words = _t(rng.integers(-2 ** 31, 2 ** 31, n_dim), device)
        if card:
            stride //= card
            group = _t(rng.integers(0, card, n_dim) * stride, device)
        dim_ops.append((vec(found), vec(row), words, group))
    fword = None
    if fact_filter:
        fword = vec(rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32))
    ma = vec(rng.integers(2 ** 30, 2 ** 31, n).astype(np.int32))
    mb = None if op == 0 else \
        vec(rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32))
    return ((tuple(dim_ops), fword, (op, ma, mb)),
            {"n_requests": n_requests, "num_segments": size})


def _batched_tail_cases(device="cpu"):
    """A Q1-like tail (one filtered dimension and a fact filter, one
    segment), Q2/Q4.1-like grouped tails that fit a block histogram, a
    four-dimension tail over 32 requests whose groups do not, and the
    last with unaligned fact-row vectors; row counts not multiples of 4."""
    rng = np.random.default_rng(13)
    specs = [
        ("one_dim_fact_filter", 1001, [(7, True, 0)], 3, 1, True, 0),
        ("three_dims_grouped", 2047, [(5, False, 7), (60, True, 0),
                                      (300, True, 25)], 8, 2, False, 0),
        ("four_dims_32_requests", 3001, [(5, True, 7), (40, True, 25),
                                         (90, True, 0), (300, True, 500)],
         32, 0, False, 0),
        ("unaligned_slices", 1003, [(9, True, 3), (70, True, 11)], 5, 3,
         True, 1),
    ]
    return [(name,) + _tail_case(device, rng, n, dims, b, op, ff, off)
            for name, n, dims, b, op, ff, off in specs]


def _coalesce_cases(device="cpu"):
    """The reference's duplicate-heavy stream, then a Zipf(1.5) stream
    long enough to cross several 256-key blocks; window 8."""
    rng = np.random.default_rng(3)
    return [("dup_stream", (_t(rng.integers(0, 9, 100), device),), {}),
            ("zipf_stream",
             (_t(zipf_sample(200, 1000, 1.5, seed=25), device),), {})]


register_kernel(KernelOp(
    "probe_rows", probe_rows, probe_rows_plain, ("cuda",),
    _probe_rows_cases, "src/repro_torch/kernels/csrc/bucket_probe.cu",
    "src/repro/kernels/bucket_probe.py:79"))
register_kernel(KernelOp(
    "bucket_probe_stream", bucket_probe_stream, bucket_probe_stream_plain,
    ("cuda",), _probe_rows_cases,
    "src/repro_torch/kernels/csrc/bucket_probe.cu",
    "src/repro/kernels/bucket_probe.py:140"))
register_kernel(KernelOp(
    "probe_filter_rows", probe_filter_rows, probe_filter_rows_plain,
    ("cuda",), _filter_cases, "src/repro_torch/kernels/csrc/bucket_probe.cu",
    "src/repro/kernels/bucket_probe.py:194"))
register_kernel(KernelOp(
    "probe_filter_rows_delta", probe_filter_rows_delta,
    probe_filter_rows_delta_plain, ("cuda",), _filter_delta_cases,
    "src/repro_torch/kernels/csrc/bucket_probe.cu",
    "src/repro/kernels/bucket_probe.py:271"))
register_kernel(KernelOp(
    "fused_query", fused_query, fused_query_plain, ("cuda",),
    _fused_query_cases, "src/repro_torch/kernels/csrc/fused_query.cu",
    "src/repro/kernels/fused_query.py:140"))
register_kernel(KernelOp(
    "batched_tail", batched_tail, batched_tail_plain, ("cuda",),
    _batched_tail_cases, "src/repro_torch/kernels/csrc/batched_tail.cu",
    None))
register_kernel(KernelOp(
    "coalesce_window_mask", coalesce_window_mask, coalesce_window_mask_plain,
    ("cuda",), _coalesce_cases,
    "src/repro_torch/kernels/csrc/coalesce_window.cu",
    "src/repro/kernels/coalesce_window.py:50"))
