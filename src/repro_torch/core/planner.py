"""Planning: probe schedules, compaction, fact appends, serving, fusion,
checkpoints.

PyTorch port of ``repro.core.planner``.  ``plan_probe`` is the paper's
skew-adaptive choice (§3.3) realized as planning: fed with the fact-side
``SkewStats`` recorded at index build and the index's bucket geometry, it
prices every probe schedule through ``costmodel.probe_schedule_seconds``
and picks ``gathered``, ``deduped`` or ``hot_cold`` (a replicated hot
table plus a compacted cold remainder); ``stream`` is priced for
reporting and taken only when forced.  A non-default schedule needs a
``GATHERED_MARGIN`` win.  ``plan_compaction`` decides whether a
dimension's delta folds back into its main table now (and in which
flavor), ``plan_fact_append`` whether a cached probe is extended over an
appended fact tail or re-probed, ``skew_drift`` whether the fact-side
skew moved enough since it was measured to re-plan, ``plan_batch`` how
many serving requests one dispatch takes, ``plan_query`` whether a query
suite runs as one fused dispatch ("mega") or per query ("composed"), and
``plan_checkpoint`` whether the write-ahead log's suffix earns a fresh
checkpoint.

Every planner prices on ``costmodel.HOST_COSTS[backend]``: ``"cpu"`` (the
reference's entry; every plan there equals the JAX package's) or
``"cuda"`` (measured on an H100); any other backend raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import costmodel
from repro_torch.core.skew import TOP_SHARE_GRID, SkewStats

# Largest hot table the planner will replicate (entries): 32K entries is
# 256 KiB of (key, word) pairs, resident in any device's fastest memory,
# the point of the paper's rank-level replication.
MAX_HOT_ENTRIES = 32768
# Direct-map slots per hot entry (load factor 0.5, like the main table).
HOT_SLOT_LOAD = 0.5
# Switch away from the gathered default only for a modeled >=60% win: the
# model is coarse, and the adaptive pick should never be knowingly slower
# than gathered.
GATHERED_MARGIN = 1.6
# Below this stream length fixed dispatch overheads dominate every
# schedule, so the gathered default always stands.
MIN_ADAPTIVE_PROBES = 100_000
# Cold-stream capacity slack over the modeled cold count (the coverage
# estimate is collision-blind; the engine tightens it to the exact count,
# and probe_hot_cold falls back on overflow regardless).
COLD_SLACK = 1.3
# Fact-side skew drift: re-plan a dimension's probe schedule once the
# appended tail moves any point of the measured top-share curve (or the
# hottest-key share) by this much; below it a re-plan could only thrash.
TOP_SHARE_DRIFT = 0.05
# Re-measure fact skew only after the logical fact stream has grown by
# this fraction since the last measurement (``measure_skew`` is an
# O(n log n) pass, too dear to run per append batch).
FACT_REMEASURE_FRAC = 0.10
# Compact once the delta holds this fraction of its slots: a 2x-mean
# bucket is routine under Fibonacci hashing, so compacting at half full
# keeps per-bucket overflow (which forces a delta grow) rare.
MAX_DELTA_FILL = 0.5
# ...or once any single delta bucket is this close to its width.
MAX_DELTA_BUCKET_FILL = 0.75


@dataclasses.dataclass(frozen=True)
class SchedulePlan:
    """Hashable probe-schedule decision for one dimension."""

    schedule: str                 # gathered | stream | deduped | hot_cold
    hot_entries: int = 0          # top-h hot keys replicated (hot_cold only)
    hot_slots: int = 0            # direct-map size, power of two
    cold_capacity: int = 0        # compacted cold stream shape (0: no cold)
    full_map: bool = False        # hot table replicates the whole dimension
    dedup_cold: bool = True       # coalesce fused into the cold path
    est_seconds: tuple[tuple[str, float], ...] = ()  # model, all schedules


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def cold_capacity_for(n_probes: int, coverage: float) -> int:
    """Fixed cold-stream shape for a modeled hot coverage (pow2, slack)."""
    want = int(n_probes * (1.0 - coverage) * COLD_SLACK) + 256
    return min(_next_pow2(n_probes), _next_pow2(want))


def hot_geometry(stats: SkewStats, hot_entries: int,
                 code_space: int | None = None) -> tuple[int, int]:
    """(entries, slots) of a direct-mapped hot table for ``hot_entries``.

    When the dimension's code space fits the slot budget, slots cover it
    entirely: dictionary codes are dense, so the identity hash then maps
    every hot code to its own slot, a collision-free direct map.
    """
    h = min(hot_entries, stats.distinct, MAX_HOT_ENTRIES)
    slots = _next_pow2(max(2, int(h / HOT_SLOT_LOAD)))
    budget = _next_pow2(int(MAX_HOT_ENTRIES / HOT_SLOT_LOAD))
    if code_space is not None and _next_pow2(code_space) <= budget:
        slots = max(slots, _next_pow2(code_space))
    return h, slots


def plan_probe(stats: SkewStats, *, bucket_width: int, backend: str = "cpu",
               impl: str = "torch", code_space: int | None = None,
               hash_mode: str = "identity", delta_slots: int = 0,
               force: str | None = None) -> SchedulePlan:
    """Pick the probe schedule for one dimension from its fact-side stats.

    ``code_space`` is the dimension's dictionary size.  When it fits the
    hot-table budget under the identity hash, ``hot_cold`` degenerates to
    a **full map**: the whole dimension is replicated collision-free, a
    hot miss is a table miss, and the cold path vanishes
    (``cold_capacity == 0``).  ``impl="cuda"`` keeps the gathered schedule
    unless forced, as the reference's ``"pallas"`` does; ``"torch"`` (its
    ``"xla"``) is planned.  ``force`` overrides the decision but keeps the
    estimates and the hot/cold geometry selection.  Raises
    ``NotImplementedError`` on a backend the cost model has no entry for.
    """
    m, distinct = stats.n, stats.distinct
    full_map = (code_space is not None and hash_mode == "identity"
                and _next_pow2(code_space) <= _next_pow2(
                    int(MAX_HOT_ENTRIES / HOT_SLOT_LOAD)))

    def est(schedule: str, **kw) -> float:
        return costmodel.probe_schedule_seconds(
            schedule, n_probes=m, distinct=distinct,
            bucket_width=bucket_width, backend=backend,
            delta_slots=delta_slots, **kw)

    # best hot-table size among the measured grid points
    if full_map:
        best_h = min(code_space, MAX_HOT_ENTRIES)
        best_hot_est = est("hot_cold", cold_capacity=0,
                           hot_slots=_next_pow2(max(2, code_space)))
    else:
        best_h, best_hot_est = 0, float("inf")
        for h in TOP_SHARE_GRID:
            if h > MAX_HOT_ENTRIES:
                continue
            cov = stats.coverage(min(h, distinct))
            _, slots = hot_geometry(stats, h, code_space)
            e = est("hot_cold", cold_capacity=cold_capacity_for(m, cov),
                    hot_slots=slots)
            if e < best_hot_est:
                best_h, best_hot_est = min(h, distinct), e
    ests = {"gathered": est("gathered"), "stream": est("stream"),
            "deduped": est("deduped"), "hot_cold": best_hot_est}

    if force is not None:
        schedule = force
    elif impl == "cuda" or m < MIN_ADAPTIVE_PROBES:
        schedule = "gathered"
    else:
        # "stream" is the faithfulness schedule: priced, never auto-picked
        schedule = "gathered"
        for cand in ("deduped", "hot_cold"):
            if ests[cand] * GATHERED_MARGIN < ests[schedule]:
                schedule = cand

    if schedule != "hot_cold":
        hot_entries, hot_slots, cold_capacity = 0, 0, 0
        full_map = False
    elif full_map:
        hot_entries = code_space
        hot_slots = _next_pow2(max(2, code_space))
        cold_capacity = 0
    else:
        hot_entries, hot_slots = hot_geometry(stats,
                                              best_h or MAX_HOT_ENTRIES,
                                              code_space)
        cold_capacity = cold_capacity_for(m, stats.coverage(hot_entries))
    return SchedulePlan(schedule=schedule, hot_entries=hot_entries,
                        hot_slots=hot_slots, cold_capacity=cold_capacity,
                        full_map=full_map, dedup_cold=True,
                        est_seconds=tuple(sorted(ests.items())))


def skew_drift(old: SkewStats, new: SkewStats) -> float:
    """How far the fact-side top-share curve moved (re-plan trigger input):
    the worst absolute movement of the curve's points and of the
    hottest-key share, the inputs the schedule choice depends on."""
    deltas = [abs(a - b) for a, b in zip(old.top_share, new.top_share)]
    return max([abs(old.max_share - new.max_share), *deltas])


def refine_plan(plan: SchedulePlan, exact_cold: int,
                n_probes: int) -> SchedulePlan:
    """Tighten ``cold_capacity`` to an exactly measured cold count.

    Once the hot table is built, one pass over the concrete probe stream
    gives the exact cold count (``lookup.hot_hit_count``) and the capacity
    snaps to it, with a little slack (``probe_hot_cold`` still falls back
    on overflow regardless).
    """
    if plan.schedule != "hot_cold" or plan.full_map:
        return plan
    cap = min(_next_pow2(n_probes),
              max(256, _next_pow2(int(exact_cold * 1.15) + 256)))
    return dataclasses.replace(plan, cold_capacity=cap)


@dataclasses.dataclass(frozen=True)
class CompactionPlan:
    """Hashable compact-or-defer decision for one dimension's delta."""

    compact: bool
    reason: str          # "fill" | "bucket" | "amortized" | "defer" | "empty"
    est_overlay_s: float  # per-probe-stream delta-overlay tax right now
    est_merge_s: float    # one compaction, in the flavor ``swap`` names
    est_rebuild_s: float  # the full sort-based rebuild being avoided
    # True when a live epoch snapshot pins the main-table planes: the merge
    # writes a fresh pair of planes instead of the existing ones
    swap: bool = False


def plan_compaction(*, delta_entries: int, delta_slots: int,
                    fill_frac: float, worst_bucket_frac: float = 0.0,
                    n_build: int, n_dict: int, bucket_width: int,
                    expected_probes: int,
                    backend: str = "cpu",
                    pinned: bool = False) -> CompactionPlan:
    """Decide whether to fold the delta into the main table now.

    Two triggers: occupancy (compact before a bucket overflows and forces
    a delta grow) and amortization (the overlay tax of one expected probe
    stream already exceeds the one-off merge).  ``pinned`` (a live epoch
    snapshot holds the main-table planes) prices the swap flavor, dearer
    by a copy of the planes, which defers amortized compactions while
    readers hold old epochs; the occupancy triggers hold regardless.
    """
    overlay = costmodel.delta_overlay_seconds(
        expected_probes, delta_slots, bucket_width=bucket_width,
        backend=backend)
    merge = costmodel.merge_seconds(delta_entries, n_dict, bucket_width,
                                    backend=backend, swap=pinned)
    rebuild = costmodel.rebuild_seconds(n_build + delta_entries,
                                        bucket_width, backend=backend)
    if delta_entries == 0:
        compact, reason = False, "empty"
    elif fill_frac >= MAX_DELTA_FILL:
        compact, reason = True, "fill"
    elif worst_bucket_frac >= MAX_DELTA_BUCKET_FILL:
        compact, reason = True, "bucket"
    elif overlay > merge:
        compact, reason = True, "amortized"
    else:
        compact, reason = False, "defer"
    return CompactionPlan(compact=compact, reason=reason,
                          est_overlay_s=overlay, est_merge_s=merge,
                          est_rebuild_s=rebuild, swap=pinned)


# ---------------------------------------------------------------------------
# Fact-side append planning: extend the probe cache, or reprobe from cold?
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FactAppendPlan:
    """Hashable extend-or-reprobe decision for one dimension's probe cache
    after a fact-side append."""

    extend: bool
    reason: str           # "tail" | "reprobe" | "empty"
    est_tail_s: float     # tail probe + cache splice
    est_reprobe_s: float  # cold re-probe of the full grown stream


def plan_fact_append(plan: SchedulePlan, *, n_tail: int, n_cached: int,
                     distinct: int, bucket_width: int,
                     delta_slots: int = 0,
                     backend: str = "cpu") -> FactAppendPlan:
    """Price probe-cache tail extension against invalidate-and-reprobe.

    ``n_tail`` is the pow2-padded append batch, ``n_cached`` the cached
    probe stream it extends.  Extension probes only the tail and splices;
    reprobing pays the full schedule over ``n_cached + n_tail`` rows.  The
    tail wins whenever the batch is small next to the stream.
    """
    if n_tail == 0:
        return FactAppendPlan(extend=False, reason="empty",
                              est_tail_s=0.0, est_reprobe_s=0.0)
    geom = dict(cold_capacity=plan.cold_capacity, hot_slots=plan.hot_slots) \
        if plan.schedule == "hot_cold" else {}
    tail = costmodel.tail_extend_seconds(
        plan.schedule, n_tail=n_tail, n_cached=n_cached, distinct=distinct,
        bucket_width=bucket_width, delta_slots=delta_slots, backend=backend,
        **geom)
    reprobe = costmodel.probe_schedule_seconds(
        plan.schedule, n_probes=n_cached + n_tail, distinct=distinct,
        bucket_width=bucket_width, delta_slots=delta_slots, backend=backend,
        **geom)
    extend = tail < reprobe
    return FactAppendPlan(extend=extend,
                          reason="tail" if extend else "reprobe",
                          est_tail_s=tail, est_reprobe_s=reprobe)


# ---------------------------------------------------------------------------
# Durability: when does the WAL suffix earn a fresh checkpoint?
# ---------------------------------------------------------------------------

# Checkpoint only once the modeled replay debt of the log suffix exceeds
# this multiple of the checkpoint's own write cost: both sides of the
# model are coarse, and a premature checkpoint steals disk bandwidth from
# the log's fsyncs for a recovery that may never run.
CKPT_SAFETY = 2.0
# Below this many logged bytes the decision is not even priced: a
# checkpoint per tiny mutation would turn every ingest into a state dump.
CKPT_MIN_LOG_BYTES = 1 << 16


@dataclasses.dataclass(frozen=True)
class CheckpointPlan:
    """Hashable checkpoint-or-defer decision for the durability tier."""

    checkpoint: bool
    reason: str          # "replay_debt" | "log_small" | "write_dominates"
    est_replay_s: float  # modeled recovery replay of the current suffix
    est_write_s: float   # modeled cost of writing the checkpoint now


def plan_checkpoint(*, log_bytes: int, n_records: int, state_bytes: int,
                    backend: str = "cpu", safety: float = CKPT_SAFETY,
                    min_log_bytes: int = CKPT_MIN_LOG_BYTES
                    ) -> CheckpointPlan:
    """Decide whether the log suffix since the last checkpoint justifies
    writing the engine's state now: recovery time against write cost.
    Every logged byte and record adds replay debt
    (``costmodel.wal_replay_seconds`` on ``backend``), a checkpoint costs
    one state write (``costmodel.checkpoint_write_seconds``).  Checkpoint
    when the debt exceeds ``safety`` x the write; below ``min_log_bytes``
    of log, never."""
    replay = costmodel.wal_replay_seconds(log_bytes, n_records,
                                          backend=backend)
    write = costmodel.checkpoint_write_seconds(state_bytes)
    if log_bytes < min_log_bytes:
        return CheckpointPlan(False, "log_small", replay, write)
    if replay > safety * write:
        return CheckpointPlan(True, "replay_debt", replay, write)
    return CheckpointPlan(False, "write_dominates", replay, write)


# ---------------------------------------------------------------------------
# Serving: how many compatible requests one dispatch takes
# ---------------------------------------------------------------------------

# Keep this multiple of the modeled dispatch time in deadline slack: the
# model is coarse, and a missed deadline is an explicit failure of every
# request in the batch.
BATCH_SLACK_FACTOR = 2.0


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """Hashable batch-size decision for one serving dispatch."""

    size: int            # requests to fold into this dispatch
    reason: str          # "depth" | "deadline"
    est_batch_s: float   # modeled wall time of the chosen dispatch
    est_single_s: float  # modeled wall time of a size-1 dispatch


def plan_batch(*, queue_depth: int, slack_s: float | None, n_rows: int,
               max_batch: int, backend: str = "cpu") -> BatchPlan:
    """Batch width against deadline slack for one serving dispatch.

    A wider batch amortizes the fixed dispatch cost, but every rider waits
    for the whole dispatch: the width halves until the modeled dispatch,
    times ``BATCH_SLACK_FACTOR``, fits the tightest member's remaining
    slack.  ``slack_s=None`` (no deadline in the batch) leaves depth and
    ``max_batch`` to decide.
    """
    size = max(1, min(queue_depth, max_batch))
    reason = "depth"
    if slack_s is not None:
        while size > 1 and costmodel.batch_serve_seconds(
                size, n_rows, backend=backend) * BATCH_SLACK_FACTOR \
                > slack_s:
            size //= 2
            reason = "deadline"
    return BatchPlan(
        size=size, reason=reason,
        est_batch_s=costmodel.batch_serve_seconds(size, n_rows,
                                                  backend=backend),
        est_single_s=costmodel.batch_serve_seconds(1, n_rows,
                                                   backend=backend))


# ---------------------------------------------------------------------------
# Query-program fusion: one fused dispatch ("mega") or per query
# ---------------------------------------------------------------------------

# The reference's gate, sized for the Pallas kernel's accumulator resident
# in TPU VMEM: on "cpu" a larger group-key space takes the composed path
# (reason "vmem"), as there.
MAX_MEGA_SEGMENTS = 1 << 21
# The card's fused_query has no such ceiling (kernels/csrc/fused_query.cu,
# launch_query_as): one segment keeps a register sum per thread, up to
# kMaxSharedSegments (12,288) a shared-memory histogram per block, and
# beyond that the rows add into the global int32 histogram in device
# memory.  What bounds it there is the int32 segment id.
MAX_MEGA_SEGMENTS_CUDA = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """Fusion decision for a query (suite): mega one-dispatch or composed."""

    fusion: str          # "mega" | "composed"
    reason: str          # "modeled" | "vmem" | "segments" | "interpret"
    #                      | "forced"
    est_mega_s: float
    est_composed_s: float

    @property
    def modeled_speedup(self) -> float:
        return self.est_composed_s / max(self.est_mega_s, 1e-12)


def plan_query(n_rows: int, n_queries: int = 1, *, backend: str = "cpu",
               kernel: str = "torch", num_segments: int = 1,
               force: str | None = None) -> QueryPlan:
    """Pick the query-program shape: one fused dispatch ("mega") or one
    dispatch per query and stage ("composed").

    The decision is ``fused_query_seconds`` against
    ``composed_query_seconds``, behind two gates: ``fused_query``
    (``kernel="cuda"``) on a CPU tensor runs its plain version, priced as
    the reference's interpreter, and never wins (reason "interpret"; on
    ``"cuda"`` it is compiled); and a group-key space past the backend's
    segment limit takes the composed path (``MAX_MEGA_SEGMENTS``, reason
    "vmem", on ``"cpu"``; ``MAX_MEGA_SEGMENTS_CUDA``, reason "segments",
    on ``"cuda"``).  ``force`` bypasses the model.
    """
    mega_s = costmodel.fused_query_seconds(n_rows, n_queries, backend,
                                           kernel=kernel)
    composed_s = costmodel.composed_query_seconds(n_rows, n_queries, backend)
    if force in ("mega", "composed"):
        return QueryPlan(force, "forced", mega_s, composed_s)
    if kernel == "cuda" and backend != "cuda":
        return QueryPlan("composed", "interpret", mega_s, composed_s)
    if backend == "cuda":
        if num_segments > MAX_MEGA_SEGMENTS_CUDA:
            return QueryPlan("composed", "segments", mega_s, composed_s)
    elif num_segments > MAX_MEGA_SEGMENTS:
        return QueryPlan("composed", "vmem", mega_s, composed_s)
    fusion = "mega" if mega_s < composed_s else "composed"
    return QueryPlan(fusion, "modeled", mega_s, composed_s)
