"""Host cost model: the parts of ``repro.core.costmodel`` the planners use.

``probe_schedule_seconds`` prices one probe schedule (``plan_probe``),
``tail_extend_seconds`` a probe-cache extension over an appended fact tail
(``plan_fact_append``), ``plan_compaction`` prices three things: the
delta overlay every probe stream pays while a delta is live, one
bucket-local merge (in place, or swapped to fresh planes under a live
snapshot), and the full rebuild the delta path avoids; and
``batch_serve_seconds`` one batched serving dispatch (``plan_batch``).  The
per-element costs are the JAX package's ``"cpu"`` entry, measured there on
a CPU host.  The port has no costs measured on a CUDA card yet, so any
other backend raises ``NotImplementedError`` instead of being priced as a
CPU: the planner slice (ROADMAP Queue 1 item 5) brings the card's entry.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class HostProbeCost:
    """Per-element costs (ns) of the probe building blocks on a backend."""

    gather_ns_per_byte: float     # random gather, per byte moved (miss)
    cached_gather_ns_per_byte: float  # ...when the gathered set is resident
    cache_bytes: int              # last-level-cache-class working-set bound
    lane_ns: float                # comparator work per bucket lane compared
    sort_ns_per_elem_log2: float  # argsort, per element per log2(n)
    pass_ns: float                # one elementwise pass over the stream
    interpret_probe_ns: float     # interpret-mode stream kernel, per probe
    op_ns: float                  # fixed dispatch/launch cost per fused op


# rough fused-op counts per schedule: the fixed-overhead term that decides
# small streams (where a richer schedule can only lose)
_SCHEDULE_OPS = {"gathered": 3, "stream": 3, "deduped": 10, "hot_cold": 16}


HOST_COSTS: dict[str, HostProbeCost] = {
    "cpu": HostProbeCost(gather_ns_per_byte=1.0,
                         cached_gather_ns_per_byte=0.25,
                         cache_bytes=32 * 2**20, lane_ns=2.0,
                         sort_ns_per_elem_log2=28.0, pass_ns=7.5,
                         interpret_probe_ns=46_000.0, op_ns=50_000.0),
}


def host_costs(backend: str) -> HostProbeCost:
    """The cost entry of ``backend``; raises ``NotImplementedError`` for a
    backend without one (``"cuda"`` until the planner slice)."""
    cost = HOST_COSTS.get(backend)
    if cost is None:
        raise NotImplementedError(
            f"no host cost entry for backend {backend!r}: pricing on it "
            "arrives with the planner slice (ROADMAP Queue 1 item 5)")
    return cost


def _log2(n: int) -> float:
    return math.log2(max(2, n))


def probe_schedule_seconds(schedule: str, *, n_probes: int, distinct: int,
                           bucket_width: int, cold_capacity: int = 0,
                           hot_slots: int = 0, delta_slots: int = 0,
                           backend: str = "cpu") -> float:
    """Modeled wall seconds of one probe schedule on ``backend``.

    ``cold_capacity`` / ``hot_slots`` parameterize ``hot_cold`` only (the
    planned hot coverage is already folded into ``cold_capacity``);
    ``cold_capacity == 0`` is the full-map case (no cold path at all).
    Bucket-row gathers are cache-aware: a stream touching few distinct rows
    keeps them resident, which speeds the gathered baseline too.  The
    ``"stream"`` price is the reference's CPU one, where its stream kernel
    runs in interpret mode.
    """
    c = host_costs(backend)
    m, w = n_probes, bucket_width
    row_bytes = 2 * w * 4  # key row + value row per activation

    def gather_rate(resident_bytes: float) -> float:
        return (c.cached_gather_ns_per_byte
                if resident_bytes <= c.cache_bytes else c.gather_ns_per_byte)

    def activations(k: int, touched_rows: int) -> float:
        """k bucket activations over ``touched_rows`` distinct rows."""
        return k * (row_bytes * gather_rate(touched_rows * row_bytes)
                    + w * c.lane_ns)

    if schedule == "gathered":
        ns = activations(m, distinct) + 2 * m * c.pass_ns
    elif schedule == "stream":
        ns = m * c.interpret_probe_ns
    elif schedule == "deduped":
        uniq = min(m, distinct)
        ns = (m * _log2(m) * c.sort_ns_per_elem_log2   # coalesce argsort
              + 4 * m * c.pass_ns                      # scan/scatter/inverse
              + activations(uniq, uniq)
              + 2 * m * c.pass_ns)                     # scatter back
    elif schedule == "hot_cold":
        # the hot table (8 B/slot) is resident by construction; the fused
        # gather + compare + select is about one pass
        ns = (m * (8 * c.cached_gather_ns_per_byte + c.pass_ns)
              + hot_slots * row_bytes * c.gather_ns_per_byte)  # table build
        cold = min(m, int(cold_capacity))
        if cold > 0:
            uniq = min(cold, distinct)
            ns += (m * 3 * c.pass_ns                   # mask/cumsum/merge
                   + cold * _log2(cold) * c.sort_ns_per_elem_log2
                   + activations(uniq, uniq))
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    if delta_slots > 0:  # un-merged ingest: every schedule pays the overlay
        ns += delta_overlay_seconds(n_probes, delta_slots,
                                    bucket_width=bucket_width,
                                    backend=backend) * 1e9
    return (ns + _SCHEDULE_OPS[schedule] * c.op_ns) * 1e-9


def tail_extend_seconds(schedule: str, *, n_tail: int, n_cached: int,
                        distinct: int, bucket_width: int,
                        cold_capacity: int = 0, hot_slots: int = 0,
                        delta_slots: int = 0,
                        backend: str = "cpu") -> float:
    """Modeled cost of extending a cached probe over an appended fact tail.

    One tail-only probe (``n_tail`` = the pow2-padded batch, under the
    dimension's planned schedule) plus a splice into the cached
    ``(found, dim_row)`` arrays: in place once the engine owns them, so
    the steady-state cost is the window write, with the O(``n_cached``)
    copy of the first extension after a cold probe as a small residual
    term.  ``plan_fact_append`` compares it with
    ``probe_schedule_seconds`` of the whole grown stream.
    """
    c = host_costs(backend)
    probe_s = probe_schedule_seconds(
        schedule, n_probes=n_tail, distinct=min(distinct, n_tail),
        bucket_width=bucket_width, cold_capacity=min(cold_capacity, n_tail),
        hot_slots=hot_slots, delta_slots=delta_slots, backend=backend)
    splice_ns = (2 * 5 * n_tail * c.cached_gather_ns_per_byte
                 + 0.1 * 2 * 5 * n_cached * c.cached_gather_ns_per_byte
                 + 2 * c.op_ns)
    return probe_s + splice_ns * 1e-9


def delta_overlay_seconds(n_probes: int, delta_slots: int,
                          bucket_width: int = 8,
                          backend: str = "cpu") -> float:
    """Per-stream cost of consulting the delta side-table during probes:
    one bucket gather into the (small) delta plus a select per probe."""
    c = host_costs(backend)
    row_bytes = 2 * bucket_width * 4
    rate = (c.cached_gather_ns_per_byte
            if delta_slots * 8 <= c.cache_bytes else c.gather_ns_per_byte)
    ns = (n_probes * (row_bytes * rate + bucket_width * c.lane_ns
                      + c.pass_ns)
          + 3 * c.op_ns)
    return ns * 1e-9


def merge_seconds(n_delta: int, n_dict: int, bucket_width: int,
                  backend: str = "cpu", *, swap: bool = False) -> float:
    """Bucket-local compaction: dictionary positional merge plus two write
    phases over the delta entries' bucket rows.

    ``swap=False`` is the in-place flavor (only the touched bucket rows are
    written); ``swap=True`` the flavor a live epoch snapshot forces, which
    first copies both table planes (keys and values, about ``2 n_dict``
    slots each at load 0.5) into a fresh pair.
    """
    c = host_costs(backend)
    row_bytes = 2 * bucket_width * 4
    ns = (3.0 * (n_dict + n_delta) * c.pass_ns          # dictionary merge
          + n_delta * _log2(max(2, n_dict)) * c.pass_ns  # cross searchsorted
          + 2.0 * n_delta * (row_bytes * c.gather_ns_per_byte
                             + bucket_width * c.lane_ns)  # phase-1/2 rows
          + 8 * c.op_ns)
    if swap:  # sequential copy of keys + values into the fresh pair
        ns += 2 * (2 * n_dict) * 8 * c.cached_gather_ns_per_byte
    return ns * 1e-9


def rebuild_seconds(n_build: int, bucket_width: int,
                    backend: str = "cpu") -> float:
    """Full sort-based rebuild (``build_table`` + dictionary re-sort)."""
    c = host_costs(backend)
    n = max(2, n_build)
    ns = (3.0 * n * _log2(n) * c.sort_ns_per_elem_log2
          + 8.0 * n * c.pass_ns
          + 10 * c.op_ns)
    return ns * 1e-9


# Serving pricing (``planner.plan_batch``): elementwise passes per request
# in the batched filter -> mask -> measure -> segment-sum tail (dimension
# filter gathers, fact predicates, the measure, the segment sum), each one
# pass over the fact rows and repeated per parameter vector...
SERVE_PASSES_PER_REQUEST = 6.0
# ...and the fixed dispatches of one batched serve: the batch program and
# the distribution of its results.
SERVE_OPS_PER_DISPATCH = 2


def batch_serve_seconds(batch: int, n_rows: int,
                        backend: str = "cpu") -> float:
    """Modeled wall seconds of one batched query dispatch: ``batch``
    parameter vectors of one query over an ``n_rows`` fact stream.  The
    stream work grows with the batch; the fixed dispatch cost is paid
    once, the amortization ``plan_batch`` trades against deadline slack."""
    c = host_costs(backend)
    ns = (max(1, batch) * max(1, n_rows) * SERVE_PASSES_PER_REQUEST
          * c.pass_ns + SERVE_OPS_PER_DISPATCH * c.op_ns)
    return ns * 1e-9
