"""Host cost model: the part of ``repro.core.costmodel`` compaction needs.

``plan_compaction`` prices three things: the delta overlay every probe
stream pays while a delta is live, one bucket-local merge, and the full
rebuild the delta path avoids.  The per-element costs are the JAX
package's ``"cpu"`` entry, measured there on a CPU host.  The port has no
costs measured on a CUDA card yet, so any other backend raises
``NotImplementedError`` instead of being priced as a CPU: the planner slice
(ROADMAP Queue 1 item 5) brings the card's entry.
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
    op_ns: float                  # fixed dispatch/launch cost per fused op


HOST_COSTS: dict[str, HostProbeCost] = {
    "cpu": HostProbeCost(gather_ns_per_byte=1.0,
                         cached_gather_ns_per_byte=0.25,
                         cache_bytes=32 * 2**20, lane_ns=2.0,
                         sort_ns_per_elem_log2=28.0, pass_ns=7.5,
                         op_ns=50_000.0),
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
                  backend: str = "cpu") -> float:
    """Bucket-local compaction: dictionary positional merge plus two write
    phases over the delta entries' bucket rows."""
    c = host_costs(backend)
    row_bytes = 2 * bucket_width * 4
    ns = (3.0 * (n_dict + n_delta) * c.pass_ns          # dictionary merge
          + n_delta * _log2(max(2, n_dict)) * c.pass_ns  # cross searchsorted
          + 2.0 * n_delta * (row_bytes * c.gather_ns_per_byte
                             + bucket_width * c.lane_ns)  # phase-1/2 rows
          + 8 * c.op_ns)
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
