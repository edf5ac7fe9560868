"""ExecutionPolicy: the single surface for every execution knob.

PyTorch port of ``repro.core.policy``.  ``kernel="torch"`` is the plain
gather math (the JAX package's ``"xla"``); ``"cuda"`` runs the hand-written
kernels (its ``"pallas"``).  Execution is eager, so the JAX ``interpret``
knob has no counterpart.  The defaults are the reference's
``schedule="auto"`` and ``fusion="auto"``: the planner prices both on the
engine's device (``core/costmodel.py``, its ``"cpu"`` or ``"cuda"`` entry).
"""
from __future__ import annotations

import dataclasses

MODES = ("jspim", "baseline", "pid")
KERNELS = ("torch", "cuda")
SCHEDULES = ("auto", "gathered", "stream", "deduped", "hot_cold")
FUSIONS = ("auto", "mega", "composed")

_ALLOWED = {"mode": MODES, "kernel": KERNELS, "schedule": SCHEDULES,
            "fusion": FUSIONS}


def check_value(field: str, value) -> None:
    """Raise ``ValueError`` unless ``value`` is a value of policy
    ``field``."""
    if value not in _ALLOWED[field]:
        raise ValueError(f"unknown {field} {value!r}")


@dataclasses.dataclass(frozen=True)
class ExecutionPolicy:
    """One frozen value describing *how* queries execute.

    mode      -- join family: "jspim" hash probe, "baseline" sort-merge,
                 "pid" partitioned-join emulation.
    kernel    -- probe implementation: "cuda" hand-written kernels (the
                 plain versions on CPU tensors), "torch" gather math.
    schedule  -- probe schedule: "gathered" (``probe_rows``, one thread per
                 probe), "stream" (``bucket_probe_stream``, a ring of
                 asynchronous key-row copies), "deduped" (coalesce, probe
                 the unique keys), "hot_cold" (a replicated hot table plus
                 a deduped cold remainder), or "auto" (the planner picks
                 one per dimension from the fact-side skew; the CUDA
                 kernels keep "gathered").  Filtered cold probes take the
                 filter kernels under every schedule.
    fusion    -- "mega" one fused_query launch per query, "composed" the
                 per-stage pipeline, "auto" asks ``plan_query`` for
                 ``run_all`` on the probe cache (cold suites and single
                 queries take the composed path).
    use_cache -- default for the cross-query probe cache on ``run``.
    """

    mode: str = "jspim"
    kernel: str = "cuda"
    schedule: str = "auto"
    fusion: str = "auto"
    use_cache: bool = True

    def __post_init__(self):
        for field in _ALLOWED:
            check_value(field, getattr(self, field))


# The sharded engine's policy subspace (``engine/shard.py``): the reference's,
# with ``"torch"`` for its ``("xla",)``.  Its probes run per shard region on
# the plain gather math, and the schedules that rank hot keys over the whole
# FK column are out.
SHARDED_KERNELS = ("torch",)
SHARDED_SCHEDULES = ("auto", "gathered", "deduped")


def validate_sharded(policy: ExecutionPolicy) -> ExecutionPolicy:
    """Reject policy knobs the sharded fact engine cannot honor.

    Raised at engine construction: the sharded engine is jspim-only (the
    baseline and pid join families materialize the fact column on one
    host), runs its probes on ``kernel="torch"`` only, and plans
    shard-local schedules without the hot-key ranking pass
    (``SHARDED_SCHEDULES``).  The kernel limit is parity with the
    reference's XLA-only subspace, not a limit of the region layout: a
    region is a contiguous slice of one tensor on one device, which the
    hand-written probes could take (ROADMAP, Queue 1).
    """
    if policy.mode != "jspim":
        raise ValueError(
            f"sharded engine requires mode='jspim', got {policy.mode!r} "
            "(baseline/pid joins materialize the fact column on one host)")
    if policy.kernel not in SHARDED_KERNELS:
        raise ValueError(
            f"sharded engine requires kernel in {SHARDED_KERNELS}, got "
            f"{policy.kernel!r} (parity with the reference's XLA-only "
            "sharded subspace; the hand-written kernels per shard region "
            "are a ROADMAP Queue 1 item)")
    if policy.schedule not in SHARDED_SCHEDULES:
        raise ValueError(
            f"sharded engine requires schedule in {SHARDED_SCHEDULES}, "
            f"got {policy.schedule!r} (hot-key ranking would pull the "
            "sharded FK column back to the host)")
    return policy


def resolve_policy(policy: ExecutionPolicy | None = None, *,
                   mode: str | None = None,
                   probe_impl: str | None = None,
                   schedule: str | None = None,
                   **overrides) -> ExecutionPolicy:
    """Merge an explicit policy with the legacy ``mode=`` /
    ``probe_impl=`` / ``schedule=`` keywords (``probe_impl`` is the
    policy's ``kernel``: ``"torch"`` or ``"cuda"``).  A keyword that
    disagrees with an explicit ``policy`` raises ``ValueError``: silent
    precedence would make the policy lie about how the engine runs."""
    legacy = {"mode": mode, "kernel": probe_impl, "schedule": schedule}
    legacy.update(overrides)
    legacy = {k: v for k, v in legacy.items() if v is not None}
    if policy is None:
        return ExecutionPolicy(**legacy)
    conflicts = {k: v for k, v in legacy.items()
                 if getattr(policy, k) != v}
    if conflicts:
        raise ValueError(
            f"policy={policy} conflicts with legacy kwargs {conflicts}; "
            f"pass one or the other")
    return policy
