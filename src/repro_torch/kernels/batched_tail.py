"""Wrapper for the batched query-tail CUDA kernel (``csrc/batched_tail.cu``).

Replaces no Pallas kernel: the JAX package vmaps its shared query tail
(filter -> mask -> measure -> segment sum) over a dispatch's parameter
vectors inside one compiled program and XLA fuses it; ``batched_tail`` is
that fusion, written by hand.  One launch answers up to ``MAX_REQUESTS``
requests of one query in a single pass over the fact rows, and keeps
nothing of size ``rows`` or ``B x rows`` in device memory.

Operands (``tail_operands`` builds them once per dispatch):

* per joined dimension ``(found, dim_row, pred, group)``: the cached probe
  (bool and int32 over the fact rows), then over the dimension's rows the
  int32 word whose bit ``i`` is request ``i``'s predicate (``None`` where
  the query does not filter the dimension) and the int32 group part
  ``remainder(col, card) * stride`` (``None`` where it does not group by
  it);
* ``fact_word``: int32 over the fact rows, bit ``i`` request ``i``'s fact
  filter, or ``None``;
* ``measure``: ``(op, a, b)``, columns ``a`` and ``b`` (``None`` for op 0)
  combined by ``MEASURE_OPS[op]``, in wrapping int32.

The predicates are the query's own callables, evaluated on the dimension
tables (and the fact filter on the fact rows, a chunk at a time) with one
``(B, 1)`` parameter column each, so the kernel holds no predicate or
constant of its own.  A row joins a dimension iff ``found``, and reads its
planes at ``clamp(dim_row, 0, n_dim - 1)``; totals and segment sums wrap
mod 2^32.

Dispatch: a CUDA tensor launches the kernel (and raises if it cannot be
built or launched); a CPU tensor takes the plain version,
``batched_tail_plain``.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import segment_sum

MAX_DIMS = 4
MAX_REQUESTS = 32        # request bits in one int32 word
# bool cells of one chunk of the fact filter's evaluation (its (B, chunk)
# masks): the word over the fact rows is the only thing of their length
FACT_FILTER_CELLS = 1 << 26
MEASURE_OPS = ("column", "mul", "sub", "add")


class _Column:
    """A fact column seen by a measure callable while it is traced."""

    def __init__(self, name, op=0, other=None):
        self.name, self.op, self.other = name, op, other

    def _combine(self, other, op):
        if self.op or not isinstance(other, _Column) or other.op:
            raise NotImplementedError(
                "batched_tail: a measure must be a fact column or two fact "
                "columns combined by *, - or +")
        return _Column(self.name, op, other.name)

    def __mul__(self, other):
        return self._combine(other, 1)

    def __sub__(self, other):
        return self._combine(other, 2)

    def __add__(self, other):
        return self._combine(other, 3)


class _Columns:
    def __getitem__(self, name):
        return _Column(name)


def measure_form(measure) -> tuple[int, str, str | None]:
    """``(op, a, b)`` of a measure callable, traced on named columns: a
    column is ``(0, name, None)``, ``t[a] * t[b]`` ``(1, a, b)``, ``-`` 2,
    ``+`` 3.  Raises ``NotImplementedError`` for any other form."""
    out = measure(_Columns())
    if not isinstance(out, _Column):
        raise NotImplementedError("batched_tail: the measure is not a fact "
                                  "column expression")
    return out.op, out.name, out.other


def request_bit(n_requests: int, device) -> torch.Tensor:
    """``(B, 1)`` int32: ``1 << i`` in row ``i``."""
    return (torch.ones(n_requests, dtype=torch.int32, device=device)
            << torch.arange(n_requests, dtype=torch.int32,
                            device=device))[:, None]


def request_bits(mask: torch.Tensor, bit: torch.Tensor, *,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """``(B, n)`` bool (or one that broadcasts to it) -> ``(n,)`` int32
    words, bit ``i`` set where ``mask[i]`` is True; ``bit`` is
    ``request_bit(B, device)``."""
    mask = mask.expand(bit.shape[0], mask.shape[-1])
    # distinct bits never carry, so the int32 sum is their OR
    words = torch.where(mask, bit, 0)
    if out is None:
        return words.sum(dim=0, dtype=torch.int32)
    return torch.sum(words, dim=0, dtype=torch.int32, out=out)


def tail_operands(spec, fact_cols, dim_cols, probes, n_requests: int):
    """The kernel's operands for one dispatch of ``n_requests``.

    ``spec`` is the query bound to ``(B, 1)`` parameter columns
    (``ParamQuery.bind``): its ``dim_filters`` and ``fact_filter`` map a
    table to ``(B, rows)`` masks.  ``fact_cols`` / ``dim_cols[dim]`` map
    column names to tensors, ``probes[dim]`` is the cached ``(found,
    dim_row)``.  Returns ``(dim_ops, fact_word, measure, num_segments)``
    in ``batched_tail``'s argument order.
    """
    if not 1 <= n_requests <= MAX_REQUESTS:
        raise ValueError(f"tail_operands: {n_requests} requests outside "
                         f"1..{MAX_REQUESTS}")
    size = math.prod(card for _, _, card in spec.group_by)
    parts: dict[str, list[tuple[str, int, int]]] = {}
    rem = size
    for dim, col, card in spec.group_by:
        rem //= card
        parts.setdefault(dim, []).append((col, card, rem))
    bit = request_bit(n_requests, next(iter(fact_cols.values())).device)
    dim_ops = []
    for dim in spec.joined_dims():
        cols = dim_cols[dim]
        found, row = probes[dim]
        pred = None
        if dim in spec.dim_filters:
            pred = request_bits(spec.dim_filters[dim](cols), bit)
        group = None
        for col, card, stride in parts.get(dim, ()):
            g = torch.remainder(cols[col], card) * stride
            group = g if group is None else group + g
        dim_ops.append((found.contiguous(), row.contiguous(), pred, group))
    op, a, b = measure_form(spec.measure)
    fact_word = None
    if spec.fact_filter is not None:
        n = fact_cols[a].shape[0]
        fact_word = torch.empty(n, dtype=torch.int32,
                                device=fact_cols[a].device)
        chunk = max(1, FACT_FILTER_CELLS // n_requests)
        for s in range(0, n, chunk):
            part = {k: v[s:s + chunk] for k, v in fact_cols.items()}
            request_bits(spec.fact_filter(part), bit,
                         out=fact_word[s:s + chunk])
    measure = (op, fact_cols[a], None if b is None else fact_cols[b])
    return tuple(dim_ops), fact_word, measure, size


def _plane_rows(what, pred, group) -> int:
    lens = {t.shape[0] for t in (pred, group) if t is not None}
    if len(lens) > 1:
        raise ValueError(f"{what}: a dimension's planes differ in length "
                         f"{sorted(lens)}")
    n_dim = lens.pop() if lens else 1
    if n_dim < 1:
        raise ValueError(f"{what}: an empty dimension table")
    return n_dim


def _check(dim_ops, fact_word, measure, n_requests, num_segments) -> int:
    """Validate the operands; returns the fact row count."""
    what = "batched_tail"
    if not 1 <= len(dim_ops) <= MAX_DIMS or \
            any(len(ops) != 4 for ops in dim_ops):
        raise ValueError(f"{what}: 1..{MAX_DIMS} dimensions of (found, "
                         "dim_row, pred, group)")
    if not 1 <= n_requests <= MAX_REQUESTS:
        raise ValueError(f"{what}: {n_requests} requests outside "
                         f"1..{MAX_REQUESTS}")
    if not 1 <= num_segments < 2 ** 31 // n_requests:
        raise ValueError(f"{what}: {num_segments} segments a request")
    op, ma, mb = measure
    if op not in range(len(MEASURE_OPS)) or (mb is None) != (op == 0):
        raise ValueError(f"{what}: measure op {op!r} with "
                         f"{'no' if mb is None else 'a'} second column")
    n = ma.shape[0]
    dev = ma.device
    planes = [t for ops in dim_ops for t in ops[2:] if t is not None]
    vectors = [ma, mb, fact_word] + [ops[1] for ops in dim_ops]
    for t in [v for v in vectors if v is not None] + planes:
        if t.dtype != torch.int32 or t.dim() != 1 or \
                not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{what}: operands must be contiguous 1-D int32 "
                             f"tensors on one device, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    for ops in dim_ops:
        f = ops[0]
        if f.dtype != torch.bool or f.dim() != 1 or \
                not f.is_contiguous() or f.device != dev:
            raise ValueError(f"{what}: found must be a contiguous 1-D bool "
                             f"tensor on {dev}, got {f.dtype} on {f.device}")
        _plane_rows(what, *ops[2:])
    if any(v.shape[0] != n for v in vectors if v is not None) or \
            any(ops[0].shape[0] != n for ops in dim_ops):
        raise ValueError(f"{what}: the fact-row vectors differ in length")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: tensors on {dev} (CPU tensors take the "
                         "plain version, CUDA tensors the kernel)")
    return n


def _measure(op, ma, mb):
    if op == 0:
        return ma
    return (ma * mb, ma - mb, ma + mb)[op - 1]


def batched_tail_plain(dim_ops, fact_word, measure, *, n_requests: int,
                       num_segments: int):
    """The plain version of ``batched_tail``: the same operands, in torch."""
    n = _check(dim_ops, fact_word, measure, n_requests, num_segments)
    dev = measure[1].device
    keep = torch.full((n,), -1, dtype=torch.int32, device=dev)
    gk = torch.zeros(n, dtype=torch.int32, device=dev)
    for found, row, pred, group in dim_ops:
        keep = torch.where(found, keep, 0)
        r = row.clamp(0, _plane_rows("batched_tail", pred, group) - 1).long()
        if pred is not None:
            keep = keep & pred[r]
        if group is not None:
            gk = gk + group[r]
    if fact_word is not None:
        keep = keep & fact_word
    m = _measure(*measure)
    totals, groups = [], []
    for i in range(n_requests):
        hit = ((keep >> i) & 1).bool()
        contrib = torch.where(hit, m, 0)
        totals.append(contrib.sum().to(torch.int32))
        if num_segments > 1:
            groups.append(segment_sum(contrib, torch.where(hit, gk, 0),
                                      num_segments))
    totals = torch.stack(totals)
    if num_segments == 1:
        return totals, totals[:, None]
    return totals, torch.stack(groups)


def batched_tail(dim_ops, fact_word, measure, *, n_requests: int,
                 num_segments: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(totals (B,), groups (B, num_segments))``, int32: request ``i``'s
    sums over the fact rows it keeps (see the module docstring).  With one
    segment ``groups`` is ``totals[:, None]``."""
    n = _check(dim_ops, fact_word, measure, n_requests, num_segments)
    op, ma, mb = measure
    if ma.device.type == "cpu":
        return batched_tail_plain(dim_ops, fact_word, measure,
                                  n_requests=n_requests,
                                  num_segments=num_segments)
    dev = ma.device
    totals = torch.zeros(n_requests, dtype=torch.int32, device=dev)
    groups = None
    if num_segments > 1:
        groups = torch.zeros((n_requests, num_segments), dtype=torch.int32,
                             device=dev)
    if n:
        # smallest dimension first: its gathers are the cheapest, and a row
        # it rejects reads nothing of the larger ones
        order = sorted(dim_ops, key=lambda ops: _plane_rows(
            "batched_tail", *ops[2:]))
        ptrs = [t.data_ptr() if t is not None else 0
                for ops in order for t in ops]
        ints = [_plane_rows("batched_tail", *ops[2:]) for ops in order]
        lib = _build.load("batched_tail")
        with torch.cuda.device(dev):
            status = lib.batched_tail_launch(
                (ctypes.c_void_p * len(ptrs))(*ptrs),
                (ctypes.c_int64 * len(ints))(*ints), len(order),
                0 if fact_word is None else fact_word.data_ptr(),
                ma.data_ptr(), 0 if mb is None else mb.data_ptr(), op, n,
                n_requests, num_segments, totals.data_ptr(),
                0 if groups is None else groups.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _build.check(status, "batched_tail")
        batched_tail.launches += 1
    if groups is None:
        return totals, totals[:, None]
    return totals, groups


batched_tail.launches = 0
