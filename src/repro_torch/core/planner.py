"""Planning: the probe schedule per dimension, compaction, fact appends.

PyTorch port of the probe-schedule and compaction parts of
``repro.core.planner``.  ``plan_probe`` is the paper's skew-adaptive
choice (§3.3) realized as planning: fed with the fact-side ``SkewStats``
recorded at index build and the index's bucket geometry, it prices every
probe schedule through ``costmodel.probe_schedule_seconds`` and picks
``gathered``, ``deduped`` or ``hot_cold`` (a replicated hot table plus a
compacted cold remainder); ``stream`` is priced for reporting and taken
only when forced.  A non-default schedule needs a ``GATHERED_MARGIN`` win.
``plan_compaction`` decides whether a dimension's delta folds back into
its main table now (and in which flavor), ``plan_fact_append`` whether a
cached probe is extended over an appended fact tail or re-probed,
``skew_drift`` whether the fact-side skew moved enough since it was
measured to re-plan, and ``plan_batch`` how many serving requests one
dispatch takes.

Pricing on a CUDA card waits for the planner slice (ROADMAP Queue 1 item
5): ``costmodel`` has no ``"cuda"`` entry, so on that backend
``plan_probe`` needs ``force`` and ``plan_compaction`` raises
``NotImplementedError``, as do ``plan_fact_append`` and ``plan_batch``
(the serving tier prices on the ``"cpu"`` entry, as the JAX package's
does on every device).  The fusion planner waits for the same slice.
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
    estimates and the hot/cold geometry selection.

    On a backend with no cost entry (``"cuda"`` until the planner slice)
    nothing is priced: ``force`` is required (``NotImplementedError``
    without it), ``est_seconds`` is ``()``, and a forced ``hot_cold``
    that is not a full map replicates ``MAX_HOT_ENTRIES`` keys, the
    reference's own fallback when no grid point was priced.  This is a
    stated rule, not a priced pick: 32,768 entries make a 65,536-slot
    direct map of 512 KiB, resident in the H100's 50 MB L2, and the
    largest grid point leaves the smallest cold stream.
    """
    priced = backend in costmodel.HOST_COSTS
    if not priced and force is None:
        raise NotImplementedError(
            f"plan_probe on backend {backend!r} needs force=: schedules are "
            "priced there with the planner slice (ROADMAP Queue 1 item 5)")
    m, distinct = stats.n, stats.distinct
    full_map = (code_space is not None and hash_mode == "identity"
                and _next_pow2(code_space) <= _next_pow2(
                    int(MAX_HOT_ENTRIES / HOT_SLOT_LOAD)))

    def est(schedule: str, **kw) -> float:
        return costmodel.probe_schedule_seconds(
            schedule, n_probes=m, distinct=distinct,
            bucket_width=bucket_width, backend=backend,
            delta_slots=delta_slots, **kw)

    best_h, ests = 0, {}
    if priced:
        # best hot-table size among the measured grid points
        if full_map:
            best_h = min(code_space, MAX_HOT_ENTRIES)
            best_hot_est = est("hot_cold", cold_capacity=0,
                               hot_slots=_next_pow2(max(2, code_space)))
        else:
            best_hot_est = float("inf")
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
    Raises ``NotImplementedError`` on a backend the cost model has no
    entry for.
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
    tail wins whenever the batch is small next to the stream.  Raises
    ``NotImplementedError`` on a backend the cost model has no entry for.
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
    ``max_batch`` to decide.  Raises ``NotImplementedError`` on a backend
    the cost model has no entry for.
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
