"""The port's cost models and planners against the JAX package's.

The paper's analytic model, ``data_overhead_bytes`` and the fusion costs
are host arithmetic with the reference's float expressions, so they are
compared exactly (``==`` on floats, no tolerance).  Every plan priced on
``"cpu"`` equals the reference's.  On ``"cuda"`` (the card's entry,
measured on an H100) the planners return plans, ``fused_query`` is
compiled and the card's segment limit applies; an unknown backend raises
instead of being priced as a CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import jspim_db as jdb
from repro.core import costmodel as jcost
from repro.core import planner as jplanner
from repro.core.skew import SkewStats as JaxSkewStats
from repro_torch.configs import SSB_PIM, TABLE3_PIM, TIMING
from repro_torch.core import costmodel as tcost
from repro_torch.core import planner as tplanner
from repro_torch.core.skew import measure_skew, zipf_sample

WORKLOADS = [(2_000_000, 500_000, 2_000_000), (600_000_000, 2_000_000,
                                                600_000_000),
             (32_000_000, 8_000_000, 32_000_000), (1, 1, 0),
             (128_000_000, 32_000_000, 1)]
ZIPF = (0.0, 0.5, 1.5, 2.0)


def _workloads(mod):
    for n_probes, n_build, n_matches in WORKLOADS:
        for z in ZIPF:
            for hit in (0.0, 0.37):
                yield mod.Workload(n_probes, n_build, n_matches,
                                   coalesce_hit_rate=hit, zipf=z,
                                   consecutive_run=1.5)


def _pair(name, **kw):
    return getattr(tcost, name)(**kw), getattr(jcost, name)(**kw)


# ---------------------------------------------------------------------------
# the paper's analytic model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cls", ["DDR4Timing", "PIMConfig", "CPUConfig",
                                 "UPMEMConfig"])
def test_configs_have_the_reference_defaults(cls):
    got, want = getattr(tcost, cls)(), getattr(jcost, cls)()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if cls == "PIMConfig":
        assert got.ranks == want.ranks


def test_jspim_db_configs_equal_the_reference():
    for got, want in ((SSB_PIM, jdb.SSB_PIM), (TABLE3_PIM, jdb.TABLE3_PIM),
                      (TIMING, jdb.TIMING)):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("t_cmp", [0, 1, 2, 4])
def test_jspim_join_seconds_equals_the_reference(t_cmp):
    for cfg_kw in ({}, dict(channels=8, ranks_per_channel=4),
                   dict(channels=4, ranks_per_channel=16,
                        parallel_subarrays=8)):
        cfg, jcfg = tcost.PIMConfig(**cfg_kw), jcost.PIMConfig(**cfg_kw)
        t, jt = tcost.DDR4Timing(t_cmp=t_cmp), jcost.DDR4Timing(t_cmp=t_cmp)
        for w, jw in zip(_workloads(tcost), _workloads(jcost)):
            assert tcost.jspim_join_seconds(w, cfg, t) == \
                jcost.jspim_join_seconds(jw, jcfg, jt)
        for n in (0, 1, 6_000_000, 600_000_000):
            assert tcost.jspim_population_seconds(n, cfg, t) == \
                jcost.jspim_population_seconds(n, jcfg, jt)
            assert tcost.jspim_select_distinct_seconds(n, cfg, t) == \
                jcost.jspim_select_distinct_seconds(n, jcfg, jt)
        assert tcost.jspim_select_where_seconds(t) == \
            jcost.jspim_select_where_seconds(jt)


def test_cpu_join_models_equal_the_reference():
    for kw in ({}, dict(cores=8, l3_bytes=8 * 2**20)):
        c, jc = tcost.CPUConfig(**kw), jcost.CPUConfig(**kw)
        for w, jw in zip(_workloads(tcost), _workloads(jcost)):
            assert tcost.cpu_classic_join_seconds(w, c) == \
                jcost.cpu_classic_join_seconds(jw, jc)
            assert tcost.cpu_vectorized_join_seconds(w, c) == \
                jcost.cpu_vectorized_join_seconds(jw, jc)


def test_upmem_join_models_equal_the_reference():
    for kw in ({}, dict(ranks=4, oom_bytes=2**20)):
        u, ju = tcost.UPMEMConfig(**kw), jcost.UPMEMConfig(**kw)
        for w, jw in zip(_workloads(tcost), _workloads(jcost)):
            assert tcost.pid_join_seconds(w, u) == \
                jcost.pid_join_seconds(jw, ju)
            for rep in (1, 8, 32):
                assert tcost.spid_join_seconds(w, u, rep) == \
                    jcost.spid_join_seconds(jw, ju, rep)
    for z in ZIPF + (1.0, 3.0):
        for parts in (1, 64, 1024):
            assert tcost._skew_imbalance(z, parts) == \
                jcost._skew_imbalance(z, parts)


@pytest.mark.parametrize("as_tensor", [False, True],
                         ids=["numpy", "tensor"])
def test_coalesce_hit_rate_equals_the_reference(as_tensor):
    rng = np.random.default_rng(3)
    streams = [np.repeat(np.arange(1000), 6), rng.integers(0, 50, 5_000),
               zipf_sample(4_000, 20_000, 1.5, seed=2),
               np.zeros(0, np.int32)]
    for keys in streams[:-1]:
        for window in (2, 8, 17):
            got = tcost.coalesce_hit_rate(
                torch.from_numpy(np.asarray(keys)) if as_tensor else keys,
                window)
            assert got == jcost.coalesce_hit_rate(keys, window)


def test_data_overhead_bytes_equals_the_reference():
    for n_fact, n_dim, dup in ((6_000_000, 234_556, 600_000), (0, 0, 0),
                               (600_000_000, 2_345_560, 10)):
        for kw in ({}, dict(key_bits=64, value_bits=32)):
            assert tcost.data_overhead_bytes(
                n_fact, n_dim, dup, tcost.PIMConfig(**kw)) == \
                jcost.data_overhead_bytes(n_fact, n_dim, dup,
                                          jcost.PIMConfig(**kw))


# ---------------------------------------------------------------------------
# fusion: the costs and plan_query
# ---------------------------------------------------------------------------

KERNELS = [("torch", "xla"), ("cuda", "pallas")]


@pytest.mark.parametrize("kernel,jkernel", KERNELS)
def test_fusion_costs_equal_the_reference_on_cpu(kernel, jkernel):
    assert tcost.FUSED_SHARED_FRAC == jcost.FUSED_SHARED_FRAC
    for n_rows in (0, 1, 12_000, 6_000_000, 60_000_000):
        for nq in (0, 1, 13):
            assert tcost.fused_query_seconds(n_rows, nq, "cpu",
                                             kernel=kernel) == \
                jcost.fused_query_seconds(n_rows, nq, "cpu", kernel=jkernel)
            assert tcost.composed_query_seconds(n_rows, nq, "cpu") == \
                jcost.composed_query_seconds(n_rows, nq, "cpu")


@pytest.mark.parametrize("kernel,jkernel", KERNELS)
@pytest.mark.parametrize("force", [None, "mega", "composed"])
def test_plan_query_equals_the_reference_on_cpu(kernel, jkernel, force):
    seen = set()
    for n_rows in (1, 12_000, 60_000_000):
        for nq in (1, 13):
            for segs in (1, 7_000, (1 << 21) - 1, 1 << 21, (1 << 21) + 1,
                         1 << 30):
                got = tplanner.plan_query(n_rows, nq, backend="cpu",
                                          kernel=kernel, num_segments=segs,
                                          force=force)
                want = jplanner.plan_query(n_rows, nq, backend="cpu",
                                           kernel=jkernel,
                                           num_segments=segs, force=force)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
                assert got.modeled_speedup == want.modeled_speedup
                seen.add(got.reason)
    assert tplanner.MAX_MEGA_SEGMENTS == jplanner.MAX_MEGA_SEGMENTS
    if force is not None:
        assert seen == {"forced"}
    elif kernel == "cuda":
        assert seen == {"interpret"}
    else:
        assert seen == {"modeled", "vmem"}


def test_plan_query_on_cuda_compiles_and_takes_the_card_limit():
    """On "cuda" the kernel is compiled (never "interpret"), and a group
    space past the reference's VMEM gate still fuses: the card's
    fused_query adds into a global histogram, bounded by int32 ids."""
    for kernel in ("torch", "cuda"):
        for segs in (1, 1 << 21, (1 << 21) + 1, 1_750_000, 1 << 30):
            p = tplanner.plan_query(60_000_000, 13, backend="cuda",
                                    kernel=kernel, num_segments=segs)
            assert p.reason == "modeled"
            assert p.fusion == ("mega" if p.est_mega_s < p.est_composed_s
                                else "composed")
        p = tplanner.plan_query(60_000_000, 1, backend="cuda", kernel=kernel,
                                num_segments=tplanner.MAX_MEGA_SEGMENTS_CUDA
                                + 1)
        assert (p.fusion, p.reason) == ("composed", "segments")
    c = tcost.HOST_COSTS["cuda"]
    assert tcost.fused_query_seconds(60_000_000, 13, "cuda",
                                     kernel="cuda") == \
        (60_000_000 * 13 * c.lane_ns + c.op_ns) * 1e-9
    with pytest.raises(NotImplementedError):
        tplanner.plan_query(10, backend="tpu")


# ---------------------------------------------------------------------------
# the card's entry and an unknown backend
# ---------------------------------------------------------------------------


def _stats(s, n=200_000, keys=50_000, seed=4):
    return measure_skew(zipf_sample(keys, n, s, seed=seed))


def test_the_card_entry_is_a_literal_of_the_card():
    c = tcost.HOST_COSTS["cuda"]
    assert set(tcost.HOST_COSTS) == {"cpu", "cuda"}
    assert c.interpret_probe_ns == 0.0
    assert c.cache_bytes == 50 * 2**20  # the H100's L2
    assert 0 < c.cached_gather_ns_per_byte <= c.gather_ns_per_byte
    assert all(v > 0 for k, v in dataclasses.asdict(c).items()
               if k != "interpret_probe_ns")
    # the compiled stream costs what gathered does (its traffic)
    kw = dict(n_probes=60_000_000, distinct=2_000_000, bucket_width=8,
              backend="cuda")
    assert tcost.probe_schedule_seconds("stream", **kw) == \
        tcost.probe_schedule_seconds("gathered", **kw)


@pytest.mark.parametrize("backend", ["cuda", "tpu", "rocm"])
def test_every_planner_prices_the_card_and_refuses_an_unknown(backend):
    stats = _stats(1.5)
    calls = {
        "plan_probe": lambda: tplanner.plan_probe(
            stats, bucket_width=8, backend=backend, code_space=50_000),
        "plan_compaction": lambda: tplanner.plan_compaction(
            delta_entries=100, delta_slots=1024, fill_frac=0.1,
            n_build=50_000, n_dict=50_000, bucket_width=8,
            expected_probes=200_000, backend=backend),
        "plan_fact_append": lambda: tplanner.plan_fact_append(
            tplanner.SchedulePlan("gathered"), n_tail=256, n_cached=10_000,
            distinct=1_000, bucket_width=8, backend=backend),
        "plan_batch": lambda: tplanner.plan_batch(
            queue_depth=8, slack_s=0.5, n_rows=60_000_000, max_batch=16,
            backend=backend),
        "plan_query": lambda: tplanner.plan_query(60_000_000, 13,
                                                  backend=backend),
    }
    for name, call in calls.items():
        if backend != "cuda":
            with pytest.raises(NotImplementedError, match=backend):
                call()
            continue
        plan = call()
        assert dataclasses.is_dataclass(plan), name
    if backend == "cuda":
        p = calls["plan_probe"]()
        assert dict(p.est_seconds).keys() == {"gathered", "stream",
                                              "deduped", "hot_cold"}
        assert all(v > 0 for v in dict(p.est_seconds).values())


def _sf10_stats(s):
    """Skew stats of part's FK at SF10 (60M probes of 2M keys), from a
    1M-row Zipf sample scaled to the stream (the planner reads ``n``,
    ``distinct`` and the top-share curve)."""
    st = _stats(s, n=1_000_000, keys=2_000_000, seed=9)
    distinct = 2_000_000 if s < 1 else min(2_000_000, st.distinct * 8)
    return dataclasses.replace(st, n=60_000_000, distinct=distinct)


@pytest.mark.parametrize("s", ZIPF)
def test_card_decisions_at_sf10(s):
    """The card's entry at SF10 sizes: the CUDA kernels keep gathered at
    every skew, and a 1% fact append extends every cached dimension."""
    st = _sf10_stats(s)
    plan = tplanner.plan_probe(st, bucket_width=8, backend="cuda",
                               impl="cuda", code_space=2_000_000,
                               hash_mode="identity")
    assert plan.schedule == "gathered"
    assert plan.est_seconds and min(dict(plan.est_seconds).values()) > 0
    for dim, distinct in (("customer", 300_000), ("supplier", 20_000),
                          ("part", 2_000_000), ("date", 2_556)):
        ap = tplanner.plan_fact_append(
            tplanner.SchedulePlan("gathered"), n_tail=1 << 20,
            n_cached=60_000_000, distinct=distinct, bucket_width=8,
            backend="cuda")
        assert ap.extend and ap.reason == "tail", dim
        assert ap.est_tail_s < ap.est_reprobe_s


def test_plan_probe_on_cpu_still_equals_the_reference():
    """The priced path needs no ``force`` and matches on "cpu"."""
    for s in ZIPF:
        st = _stats(s)
        js = JaxSkewStats(**dataclasses.asdict(st))
        for impl, jimpl in (("torch", "xla"), ("cuda", "pallas")):
            got = tplanner.plan_probe(st, bucket_width=8, impl=impl,
                                      code_space=50_000)
            want = jplanner.plan_probe(js, bucket_width=8, impl=jimpl,
                                       code_space=50_000)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
