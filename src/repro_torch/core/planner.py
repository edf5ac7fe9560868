"""Compaction planning: the part of ``repro.core.planner`` ingest needs.

``plan_compaction`` decides whether a dimension's delta folds back into
its main table now.  The probe-schedule and fusion planners wait for the
planner slice (ROADMAP Queue 1 item 5), and so does pricing on a CUDA
card: ``costmodel`` raises ``NotImplementedError`` for any backend other
than ``"cpu"``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import costmodel

# Compact once the delta holds this fraction of its slots: a 2x-mean
# bucket is routine under Fibonacci hashing, so compacting at half full
# keeps per-bucket overflow (which forces a delta grow) rare.
MAX_DELTA_FILL = 0.5
# ...or once any single delta bucket is this close to its width.
MAX_DELTA_BUCKET_FILL = 0.75


@dataclasses.dataclass(frozen=True)
class CompactionPlan:
    """Hashable compact-or-defer decision for one dimension's delta."""

    compact: bool
    reason: str          # "fill" | "bucket" | "amortized" | "defer" | "empty"
    est_overlay_s: float  # per-probe-stream delta-overlay tax right now
    est_merge_s: float    # one bucket-local compaction
    est_rebuild_s: float  # the full sort-based rebuild being avoided


def plan_compaction(*, delta_entries: int, delta_slots: int,
                    fill_frac: float, worst_bucket_frac: float = 0.0,
                    n_build: int, n_dict: int, bucket_width: int,
                    expected_probes: int,
                    backend: str = "cpu") -> CompactionPlan:
    """Decide whether to fold the delta into the main table now.

    Two triggers: occupancy (compact before a bucket overflows and forces
    a delta grow) and amortization (the overlay tax of one expected probe
    stream already exceeds the one-off merge).  Raises
    ``NotImplementedError`` on a backend the cost model has no entry for.
    """
    overlay = costmodel.delta_overlay_seconds(
        expected_probes, delta_slots, bucket_width=bucket_width,
        backend=backend)
    merge = costmodel.merge_seconds(delta_entries, n_dict, bucket_width,
                                    backend=backend)
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
                          est_rebuild_s=rebuild)
