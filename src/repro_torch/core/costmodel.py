"""Cost models: the paper's analytic PIM model and the host planner's.

PyTorch port of ``repro.core.costmodel`` without the checkpoint pricing
(``CKPT_*``, ``REPLAY_OPS_PER_RECORD``, ``checkpoint_write_seconds``,
``wal_replay_seconds``: the durability slice brings them).

* **The paper's analytic model** (§4): a DDR4-3200 timing model of JSPIM's
  RLU pipeline and of its baselines (single-thread and DuckDB-class CPU
  joins, the UPMEM PID/SPID joins), the setup and SELECT models, and
  ``data_overhead_bytes``.  Host arithmetic, equal to the reference's.
* **The host planner's model**: per-element costs of the probe building
  blocks (``HostProbeCost``) per backend.  ``probe_schedule_seconds``
  prices one probe schedule (``plan_probe``), ``tail_extend_seconds`` a
  probe-cache extension over an appended fact tail (``plan_fact_append``),
  ``delta_overlay_seconds`` / ``merge_seconds`` / ``rebuild_seconds`` a
  compaction (``plan_compaction``), ``batch_serve_seconds`` one batched
  serving dispatch (``plan_batch``), and ``fused_query_seconds`` /
  ``composed_query_seconds`` the two query shapes (``plan_query``).

``HOST_COSTS`` holds two entries: ``"cpu"``, the reference's, measured
there on a CPU host, and ``"cuda"``, measured on an NVIDIA H100 by
``chip_smoke.py``'s ``[calib]`` phase.  Any other backend raises
``NotImplementedError`` instead of being priced as a CPU.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


# --------------------------------------------------------------------------
# DDR4-3200 timing (cycles @ 1600 MHz clock, tCK = 0.625 ns)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DDR4Timing:
    tck_ns: float = 0.625
    trcd: int = 22      # ACT -> READ
    trp: int = 22       # PRE -> ACT
    tcas: int = 22      # READ -> data
    trrd: int = 4       # ACT -> ACT (different bank/subarray)
    tccd: int = 4       # column-to-column (burst gap)
    tburst: int = 4     # BL8 @ DDR
    t_cmp: int = 0      # JSPIM comparator delay (sensitivity knob, Fig. 13)


@dataclasses.dataclass(frozen=True)
class PIMConfig:
    """JSPIM deployment (defaults: paper's PIM-comparison setup §4.1.3)."""
    channels: int = 4
    ranks_per_channel: int = 4
    # concurrently active subarray search engines per rank (bounded by the
    # ACT command bus: one activation per tRRD)
    parallel_subarrays: int = 64
    coalescing_window: int = 8
    key_bits: int = 32
    value_bits: int = 32
    bucket_width: int = 128
    channel_gbps: float = 25.6  # DDR4-3200 x64 channel

    @property
    def ranks(self) -> int:
        return self.channels * self.ranks_per_channel


@dataclasses.dataclass(frozen=True)
class Workload:
    n_probes: int                   # fact-table rows streamed
    n_build: int                    # dimension-table rows
    n_matches: int                  # output pairs
    coalesce_hit_rate: float = 0.0  # fraction filtered by the window
    zipf: float = 0.0               # probe-key skew
    consecutive_run: float = 1.0    # mean run length of repeated keys


# --------------------------------------------------------------------------
# JSPIM
# --------------------------------------------------------------------------
def jspim_join_seconds(w: Workload, cfg: PIMConfig = PIMConfig(),
                       t: DDR4Timing = DDR4Timing()) -> float:
    """RLU-pipelined join latency.  max() of the three pipeline stages
    (fetch / search / return) models the paper's Fig. 7 overlap."""
    per_rank = math.ceil(w.n_probes / cfg.ranks)
    effective = per_rank * (1.0 - w.coalesce_hit_rate)

    # search stage: each probe = one row activation + parallel compare.
    # Activations to distinct subarrays overlap; the ACT bus issues one per
    # tRRD, and each engine is busy tRCD+tCAS+t_CMP+tRP before reuse.
    per_probe_cycles = max(
        t.trrd,
        (t.trcd + t.tcas + t.t_cmp + t.trp) / cfg.parallel_subarrays,
    )
    # Comparator-delay interference with the controller schedule, calibrated
    # to Fig. 13: +11% at t_CMP=1 then diminishing marginal cost (+32% avg
    # at t_CMP=4) — once the delay exceeds the burst window the pipeline is
    # already stalled and further cycles partially hide.
    if t.t_cmp >= 1:
        per_probe_cycles += 0.44 + 0.28 * (t.t_cmp - 1)
    search = effective * per_probe_cycles * t.tck_ns * 1e-9

    # fetch stage: keys stream from regular chips of the same rank (BL8)
    keys_per_burst = 64 * 8 // cfg.key_bits  # 64B per chip-burst, 8 chips
    fetch = per_rank / keys_per_burst * (t.tccd * t.tck_ns) * 1e-9

    # return stage: matched (key, value) pairs cross the channel to the CPU
    # (Fig. 11: "JSPIM sends key-value pairs to CPU")
    out_bytes = w.n_matches * ((cfg.key_bits + cfg.value_bits) // 8)
    ret = out_bytes / (cfg.channels * cfg.channel_gbps * 1e9)

    fill = (t.trcd + t.tcas + t.t_cmp) * t.tck_ns * 1e-9  # pipeline fill
    return max(search, fetch, ret) + fill


def coalesce_hit_rate(keys, window: int = 8) -> float:
    """Exact window-filter rate for a concrete probe stream (a numpy array
    or a tensor, read on the host)."""
    if torch.is_tensor(keys):
        keys = keys.cpu().numpy()
    keys = np.asarray(keys)
    hit = np.zeros(keys.shape, bool)
    for d in range(1, window):
        hit[d:] |= keys[d:] == keys[:-d]
    return float(hit.mean())


# --------------------------------------------------------------------------
# CPU baselines
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CPUConfig:
    cores: int = 112                 # paper's Xeon Gold 6330 (2 sockets)
    freq_ghz: float = 2.0
    l3_bytes: int = 42 * 2**20
    dram_latency_ns: float = 90.0    # random miss (NUMA-averaged)
    l3_latency_ns: float = 18.0
    mem_bw_gbps: float = 160.0       # achievable stream bw, 8ch DDR4-3200
    # DuckDB-class constants, calibrated to the paper's Fig. 8 (log-scale
    # seconds at SF100) and its "SELECT n.*, r.*" result shape: the baseline
    # materializes *wide rows* (lineorder has 17 attributes) via gather-heavy
    # writes — effective bandwidth far below stream — while JSPIM streams
    # 8-byte (fact_idx, dim_idx) pairs.  This asymmetry is the bulk of the
    # paper's 400-1000x.
    vectorized_overhead_ns: float = 18.0
    materialize_row_bytes: int = 200          # n.* + r.* wide output row
    materialize_bw_gbps: float = 3.0          # gather+copy(+spill) effective


def cpu_classic_join_seconds(w: Workload, c: CPUConfig = CPUConfig()) -> float:
    """Single-thread classic hash join (build + probe), cache-modeled."""
    entry_bytes = 16
    table_bytes = w.n_build * entry_bytes
    miss = min(1.0, max(0.05, 1.0 - c.l3_bytes / max(table_bytes, 1)))
    lat = miss * c.dram_latency_ns + (1 - miss) * c.l3_latency_ns
    # duplicate chains lengthen probes under skew (classic chaining)
    chain = 1.0 + 0.35 * w.zipf
    build = w.n_build * (lat + 6.0) * 1e-9
    probe_t = w.n_probes * (lat * chain + 8.0) * 1e-9
    # single-thread wide-row materialization (gather + copy, no parallelism)
    mat = w.n_matches * c.materialize_row_bytes / 0.8e9
    return build + probe_t + mat


def cpu_vectorized_join_seconds(w: Workload,
                                c: CPUConfig = CPUConfig()) -> float:
    """DuckDB-class multicore radix/partitioned hash join."""
    entry_bytes = 16
    # two partition passes over both inputs + probe pass, bandwidth bound
    bytes_moved = (w.n_probes + w.n_build) * entry_bytes * 2.2
    bw_time = bytes_moved / (c.mem_bw_gbps * 1e9)
    compute = (w.n_probes * c.vectorized_overhead_ns * 1e-9) / max(
        1, c.cores // 2)
    mat = w.n_matches * c.materialize_row_bytes / (c.materialize_bw_gbps * 1e9)
    return bw_time + compute + mat


# --------------------------------------------------------------------------
# UPMEM-class PIM baselines (PID-Join / SPID-Join)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class UPMEMConfig:
    ranks: int = 16
    dpus_per_rank: int = 64
    dpu_mips: float = 350.0          # effective DPU instruction rate (M/s)
    wram_bytes: int = 64 * 1024
    # per-DPU join working-set ceiling (WRAM tiling over MRAM); beyond this
    # the published systems report OOM (PID: 8M tuples @ Zipf>=1.5;
    # SPID: 32M/64M @ Zipf=2) — threshold calibrated to those failures.
    oom_bytes: int = 23 * 2**20
    instr_per_probe: float = 60.0    # scalar hash+compare+branch
    launch_s: float = 0.04           # program load + rank orchestration
    instr_per_build: float = 80.0
    inter_rank_gbps: float = 6.0     # CPU-mediated rank-to-rank copies


def _skew_imbalance(zipf: float, parts: int) -> float:
    """max-partition / mean-partition under Zipf hashing into ``parts``."""
    if zipf <= 0:
        return 1.0
    # hottest key share ~ 1/H(n,s); a single partition inherits it
    h = sum(r ** -zipf for r in range(1, 10001))
    hot = (1.0 ** -zipf) / h
    return max(1.0, hot * parts)


def pid_join_seconds(w: Workload, u: UPMEMConfig = UPMEMConfig()) -> tuple[float, bool]:
    """PID-Join: partitioned, bank-level, synchronized on the slowest DPU.

    Returns (seconds, oom).  OOM when the hottest partition's hash chunk
    exceeds WRAM (paper: fails at |R|=8M, Zipf>=1.5).
    """
    parts = u.ranks * u.dpus_per_rank
    imb = _skew_imbalance(w.zipf, parts)
    per_dpu_build = w.n_build / parts * imb
    oom = per_dpu_build * 8 > u.oom_bytes
    build = per_dpu_build * u.instr_per_build / (u.dpu_mips * 1e6)
    probe = (w.n_probes / parts) * imb * u.instr_per_probe / (u.dpu_mips * 1e6)
    gather = w.n_matches * 8 / (u.inter_rank_gbps * 1e9)
    return u.launch_s + build + probe + gather, bool(oom)


def spid_join_seconds(w: Workload, u: UPMEMConfig = UPMEMConfig(),
                      replication: int = 8) -> tuple[float, bool]:
    """SPID-Join: replicate hot keys across banks/ranks (skew-resistant),
    paying CPU-mediated replication traffic and a larger footprint."""
    parts = u.ranks * u.dpus_per_rank
    imb = max(1.0, _skew_imbalance(w.zipf, parts) / replication)
    per_dpu_build = w.n_build / parts * imb * (1 + replication * 0.05)
    oom = per_dpu_build * 8 * replication > u.oom_bytes * replication
    build = per_dpu_build * u.instr_per_build / (u.dpu_mips * 1e6)
    replicate = (w.n_build * 8 * replication) / (u.inter_rank_gbps * 1e9)
    probe = (w.n_probes / parts) * imb * u.instr_per_probe / (u.dpu_mips * 1e6)
    gather = w.n_matches * 8 / (u.inter_rank_gbps * 1e9)
    return u.launch_s + build + replicate + probe + gather, bool(oom)


# --------------------------------------------------------------------------
# Setup-phase + select models (Table 2, Fig. 10)
# --------------------------------------------------------------------------
def jspim_population_seconds(n_rows: int, cfg: PIMConfig = PIMConfig(),
                             t: DDR4Timing = DDR4Timing()) -> float:
    """Burst-writing the hash dataset + fact keys into PIM ranks."""
    bytes_total = n_rows * (cfg.key_bits + cfg.value_bits) // 8
    return bytes_total / (cfg.channels * cfg.channel_gbps * 1e9)


def jspim_select_where_seconds(t: DDR4Timing = DDR4Timing()) -> float:
    """One activation + compare + burst back — 'a single DRAM read'."""
    return (t.trcd + t.tcas + t.t_cmp + t.tburst) * t.tck_ns * 1e-9


def jspim_select_distinct_seconds(n_unique: int,
                                  cfg: PIMConfig = PIMConfig(),
                                  t: DDR4Timing = DDR4Timing()) -> float:
    """Stream the unique keys (they ARE the hash table) back to the CPU."""
    return (n_unique * cfg.key_bits / 8) / (cfg.channels * cfg.channel_gbps * 1e9)


# --------------------------------------------------------------------------
# Host-side probe-schedule model (planner input, core/planner.py)
# --------------------------------------------------------------------------


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
    # NVIDIA H100 80GB HBM3 at 700.00 W: each constant is the value of the
    # chip_smoke.py ``[calib]`` line of its name (PERF.md §6, PR 19, run
    # 1).  A gather's bytes are the 32-byte sectors it moves, so a bucket
    # row of 2 x 8 int32 lanes costs two random sectors
    "cuda": HostProbeCost(
        # [calib] gather: 60M random 4-byte reads of a 512 MiB table,
        # 2.0525 ms
        gather_ns_per_byte=0.001069,
        # [calib] cached_gather: the same reads of a 16 MiB table, 0.5054 ms
        cached_gather_ns_per_byte=0.000263,
        # [calib] cache_bytes: the L2 size get_device_properties reports
        cache_bytes=52_428_800,
        # [calib] lane: probe_rows on part's 60M probes, 1.2874 ms, per
        # probe per lane (the whole kernel: the model adds its row gathers)
        lane_ns=0.002682,
        # [calib] sort: torch.sort(stable=True) of 60M int32 keys, 3.0541 ms
        sort_ns_per_elem_log2=0.00197,
        # [calib] pass: an int32 elementwise pass over 60M rows, 0.1610 ms
        pass_ns=0.002684,
        # no interpret mode on the card
        interpret_probe_ns=0.0,
        # [calib] op: one small launch by the host clock
        op_ns=6004.2),
}


def host_costs(backend: str) -> HostProbeCost:
    """The cost entry of ``backend``; raises ``NotImplementedError`` for a
    backend without one (the reference prices it as a CPU instead)."""
    cost = HOST_COSTS.get(backend)
    if cost is None:
        raise NotImplementedError(
            f"no host cost entry for backend {backend!r} (have "
            f"{sorted(HOST_COSTS)})")
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
    ``"stream"`` kernel is compiled on ``"cuda"`` (its traffic is the
    gathered probe's) and priced as the reference's interpret mode on
    ``"cpu"``.
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
        if backend == "cuda":  # compiled: the gathered probe's traffic
            ns = activations(m, distinct) + 2 * m * c.pass_ns
        else:                  # the reference's interpret-mode price
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


# Fraction of the per-query stream work the one-dispatch ("mega") suite
# pays: sharing the probes and the subexpressions repeated across the SSB
# flights leaves each query well under a full set of passes (the
# reference's calibration against its warm run_all).
FUSED_SHARED_FRAC = 0.6


def fused_query_seconds(n_rows: int, n_queries: int = 1,
                        backend: str = "cpu", *,
                        kernel: str = "torch") -> float:
    """Modeled wall seconds of the one-dispatch fused (mega) query path.

    ``kernel="torch"`` is the suite over shared probes (the reference's
    ``"xla"``): one fixed dispatch instead of ``n_queries``, and the
    per-query stream work cut to ``FUSED_SHARED_FRAC``.  ``"cuda"`` is
    ``fused_query`` (the reference's ``"pallas"``): compiled on
    ``"cuda"`` (``lane_ns`` per row and query); on a CPU tensor it runs
    its plain version, priced as the reference's interpreter, which the
    planner never picks.
    """
    c = host_costs(backend)
    rows = max(1, n_rows)
    if kernel == "cuda":
        probe_ns = c.lane_ns if backend == "cuda" else c.interpret_probe_ns
        ns = rows * max(1, n_queries) * probe_ns + c.op_ns
    else:
        ns = (max(1, n_queries) * rows * SERVE_PASSES_PER_REQUEST
              * FUSED_SHARED_FRAC * c.pass_ns + c.op_ns)
    return ns * 1e-9


def composed_query_seconds(n_rows: int, n_queries: int = 1,
                           backend: str = "cpu") -> float:
    """Modeled wall seconds of the composed (per-query dispatch) path:
    each query pays its full stream passes plus its own dispatch."""
    c = host_costs(backend)
    ns = max(1, n_queries) * (max(1, n_rows) * SERVE_PASSES_PER_REQUEST
                              * c.pass_ns + c.op_ns)
    return ns * 1e-9


def data_overhead_bytes(n_fact: int, n_dim: int, dup_total: int,
                        cfg: PIMConfig = PIMConfig()) -> dict:
    """§4.2.1 accounting: dictionary + encoded fact copy + hash table + dup
    list."""
    key_b = cfg.key_bits // 8
    val_b = cfg.value_bits // 8
    return {
        "dictionary": n_dim * key_b,
        "encoded_fact_copy": n_fact * key_b,
        "hash_table": n_dim * (key_b + val_b),
        "duplication_list": dup_total * val_b,
    }
