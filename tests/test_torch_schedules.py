"""The skew-aware probe schedules, JOIN and SELECT against the JAX package.

Every case feeds the same numpy inputs to ``repro`` and ``repro_torch``:

* ``plan_probe`` over a grid of skew, code space, delta occupancy and
  ``force``: whole ``SchedulePlan``s equal, estimates included (the same
  float expressions on the same inputs); and the port's rule for a backend
  with no cost entry (``"cuda"``);
* ``probe_deduped`` / ``probe_hot_cold`` (full map, partial, cold
  overflow, a cold capacity covering the stream) with no delta, a live
  delta and tombstones, through ``probe_with_delta``;
* ``join`` on a duplicated build side, ``select_where_eq``,
  ``select_distinct``, and ``lookup`` / ``join_pairs`` on a ``DimIndex``
  too wide for a full map;
* ``SSBEngine`` under ``schedule`` in {auto, deduped, hot_cold}: plans and
  answers equal JAX's ``kernel="xla"`` engine before ingest, with live
  deltas, and after compaction.

All arithmetic is int32, so equality is exact.  On the CPU the port's
``"cuda"`` kernel takes the plain versions; ``chip_smoke.py`` holds the
kernels against those on the card.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import delta as jdelta
from repro.core import hash_table as jht
from repro.core import lookup as jlookup
from repro.core import planner as jplanner
from repro.core import skew as jskew
from repro.core.policy import ExecutionPolicy as JaxPolicy
from repro.engine import SSBEngine as JaxEngine
from repro.engine import generate_ssb as jax_generate_ssb
from repro.engine import generate_ssb_dims as jax_generate_ssb_dims
from repro.engine import join as jjoin
from repro.engine.ssb import random_mutation as jax_random_mutation
from repro_torch.core import delta as tdelta
from repro_torch.core import hash_table as tht
from repro_torch.core import lookup as tlookup
from repro_torch.core import planner as tplanner
from repro_torch.core import skew as tskew
from repro_torch.core import ExecutionPolicy
from repro_torch.engine import (SSB_QUERIES, SSBEngine, build_stats_from,
                                dim_index_from_numpy, generate_ssb,
                                generate_ssb_dims, join, random_mutation,
                                tables_from_numpy)
from repro_torch.kernels.ops import probe_table

SF = 0.002
ZIPF_S = (0.0, 0.5, 1.5, 2.0)
EMPTY = int(tht.EMPTY_KEY)


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.int32))


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=msg)


def _eq_fields(got, want, msg=""):
    assert got._fields == want._fields
    for f in got._fields:
        _eq(getattr(got, f), getattr(want, f), f"{msg} {f}")


def _same_plan(got, want):
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


# ---------------------------------------------------------------------------
# plan_probe
# ---------------------------------------------------------------------------


def _stats_pair(s: float, scale: int):
    """Equal (port, JAX) SkewStats: a measured Zipf curve whose stream is
    ``scale`` times longer (the planner sees only these numbers)."""
    j = jskew.measure_skew(jskew.zipf_sample(100_000, 20_000, s,
                                             seed=int(s * 10) + 2))
    fields = dict(n=j.n * scale, distinct=j.distinct,
                  dup_factor=j.n * scale / j.distinct,
                  max_share=j.max_share, top_share=j.top_share)
    return tskew.SkewStats(**fields), jskew.SkewStats(**fields)


@pytest.mark.parametrize("force", [None, "gathered", "stream", "deduped",
                                   "hot_cold"])
@pytest.mark.parametrize("code_space", [None, 5_000, 70_000])
@pytest.mark.parametrize("s", ZIPF_S)
def test_plan_probe_matches_jax(s, code_space, force):
    """code_space 70,000 is past the 65,536-slot hot budget: no full map."""
    for scale in (1, 100, 3_000):
        ts, js = _stats_pair(s, scale)
        for delta_slots in (0, 4096):
            for hash_mode in ("identity", "fibonacci"):
                for impl, jimpl in (("torch", "xla"), ("cuda", "pallas")):
                    kw = dict(bucket_width=8, backend="cpu",
                              code_space=code_space, hash_mode=hash_mode,
                              delta_slots=delta_slots, force=force)
                    got = tplanner.plan_probe(ts, impl=impl, **kw)
                    want = jplanner.plan_probe(js, impl=jimpl, **kw)
                    _same_plan(got, want)
                    exact = int(ts.n * (1 - ts.coverage(got.hot_entries)))
                    _same_plan(tplanner.refine_plan(got, exact, ts.n),
                               jplanner.refine_plan(want, exact, js.n))


def test_plan_probe_picks_every_schedule_somewhere():
    """The grid above reaches each automatic decision at least once."""
    picks = set()
    for s in ZIPF_S:
        for scale in (1, 100, 3_000):
            ts, _ = _stats_pair(s, scale)
            for cs in (5_000, 70_000):
                picks.add(tplanner.plan_probe(ts, bucket_width=8,
                                              code_space=cs).schedule)
    assert {"gathered", "hot_cold"} <= picks


@pytest.mark.parametrize("code_space", [5_000, 2_000_000])
def test_plan_probe_on_a_backend_without_costs(code_space):
    """Only a backend the cost model has no entry for is left unpriced: it
    raises, forced or not.  "cuda" is priced without ``force``: the CUDA
    kernels keep gathered, every schedule carries its estimate, and a
    forced hot/cold plan takes the reference's geometry at the grid point
    the card's prices pick."""
    ts, js = _stats_pair(1.5, 3_000)
    for force in (None, "hot_cold"):
        with pytest.raises(NotImplementedError, match="tpu"):
            tplanner.plan_probe(ts, bucket_width=8, backend="tpu",
                                code_space=code_space, force=force)
    auto = tplanner.plan_probe(ts, bucket_width=8, backend="cuda",
                               impl="cuda", code_space=code_space)
    assert auto.schedule == "gathered"
    assert sorted(dict(auto.est_seconds)) == ["deduped", "gathered",
                                              "hot_cold", "stream"]
    kw = dict(bucket_width=8, code_space=code_space, force="hot_cold")
    got = tplanner.plan_probe(ts, backend="cuda", **kw)
    want = jplanner.plan_probe(js, backend="cpu", **kw)
    assert got.est_seconds == auto.est_seconds
    if code_space <= 65_536:  # full map: the reference's own geometry
        _same_plan(got, dataclasses.replace(want,
                                            est_seconds=got.est_seconds))
    else:
        geoms = {jplanner.hot_geometry(js, h, code_space)
                 for h in tskew.TOP_SHARE_GRID
                 if h <= jplanner.MAX_HOT_ENTRIES}
        assert (got.hot_entries, got.hot_slots) in geoms
        assert not got.full_map
        assert got.cold_capacity == jplanner.cold_capacity_for(
            js.n, js.coverage(got.hot_entries))
    for force in ("gathered", "stream", "deduped"):
        p = tplanner.plan_probe(ts, backend="cuda", bucket_width=8,
                                force=force)
        assert (p.schedule, p.hot_entries, p.cold_capacity) == (force, 0, 0)
        assert len(p.est_seconds) == 4


def test_schedule_costs_match_jax_and_gate_cuda():
    from repro.core import costmodel as jcost
    from repro_torch.core import costmodel as tcost
    for sched in ("gathered", "stream", "deduped", "hot_cold"):
        for kw in (dict(n_probes=6_000_000, distinct=2_000_000),
                   dict(n_probes=50_000, distinct=700, cold_capacity=4096,
                        hot_slots=1024, delta_slots=512)):
            kw = dict(kw, bucket_width=8, backend="cpu")
            assert tcost.probe_schedule_seconds(sched, **kw) == \
                jcost.probe_schedule_seconds(sched, **kw)
    # the card's entry prices every schedule; its compiled stream costs
    # what gathered does; an unknown backend raises
    kw = dict(n_probes=6_000_000, distinct=2_000_000, bucket_width=8,
              backend="cuda")
    cuda = {sched: tcost.probe_schedule_seconds(sched, **kw)
            for sched in ("gathered", "stream", "deduped", "hot_cold")}
    assert all(v > 0 for v in cuda.values())
    assert cuda["stream"] == cuda["gathered"]
    with pytest.raises(NotImplementedError, match="tpu"):
        tcost.probe_schedule_seconds("gathered", n_probes=10, distinct=10,
                                     bucket_width=8, backend="tpu")


# ---------------------------------------------------------------------------
# probe schedules, with and without a delta
# ---------------------------------------------------------------------------

N_KEYS = 5_000


def _tables(hash_mode):
    keys = np.arange(N_KEYS, dtype=np.int32)
    nb = tht.suggest_num_buckets(N_KEYS, 8)
    return (tht.build_table(_t(keys), _t(keys), num_buckets=nb,
                            bucket_width=8, hash_mode=hash_mode),
            jht.build_table(jnp.asarray(keys), jnp.asarray(keys),
                            num_buckets=nb, bucket_width=8,
                            hash_mode=hash_mode))


def _probe_keys(s):
    keys = tskew.zipf_sample(8_000, 20_000, s, seed=int(s * 10) + 5)
    keys[::997] = EMPTY   # sentinel probes never match
    keys[5::1_009] = -1   # NO_CODE
    return keys


def _deltas(state):
    """(port, JAX) delta side tables in the probe keys' space."""
    if state == "none":
        return None, None
    rng = np.random.default_rng(4)
    ups = rng.integers(0, 9_000, 60).astype(np.int32)
    pays = rng.integers(0, N_KEYS, 60).astype(np.int32)
    td = tdelta.upsert_batch(tdelta.empty_delta(32, 8), _t(ups), _t(pays))
    jd = jdelta.upsert_batch(jdelta.empty_delta(32, 8), jnp.asarray(ups),
                             jnp.asarray(pays))
    if state == "tombstone":
        dels = np.concatenate([ups[:20], rng.integers(0, 9_000, 20)]
                              ).astype(np.int32)
        td = tdelta.delete_batch(td, _t(dels))
        jd = jdelta.delete_batch(jd, jnp.asarray(dels))
    return td, jd


# (schedule, geometry): hot entries, hot slots, cold capacity; None means
# "the exact cold count plus slack"
VARIANTS = {
    "deduped": ("deduped", {}),
    "deduped_exact_capacity": ("deduped", {"unique": "exact"}),
    "deduped_overflow": ("deduped", {"unique": 32}),
    "hot_cold_full_map": ("hot_cold", {"hot": N_KEYS, "slots": 8192,
                                       "cold": 0}),
    "hot_cold_partial": ("hot_cold", {"hot": 512, "slots": 1024,
                                      "cold": None}),
    "hot_cold_overflow": ("hot_cold", {"hot": 16, "slots": 32,
                                       "cold": 64}),
    "hot_cold_covers_stream": ("hot_cold", {"hot": 64, "slots": 128,
                                            "cold": 32_768}),
    "hot_cold_no_cold_dedup": ("hot_cold", {"hot": 512, "slots": 1024,
                                            "cold": None, "dedup": False}),
}


def _run_schedule(lk, table, keys, delta, variant, hot_codes, probe_fn=None):
    """One variant through package ``lk`` (``tlookup`` or ``jlookup``)."""
    sched, geo = VARIANTS[variant]
    extra = {} if probe_fn is None else {"probe_fn": probe_fn}
    kw = {}
    if sched == "deduped":
        u = geo.get("unique")
        kw["unique_capacity"] = (len(np.unique(np.asarray(keys)))
                                 if u == "exact" else u)
        if delta is None:
            return lk.probe_deduped(table, keys, kw["unique_capacity"],
                                    **extra)
    else:
        hot = lk.build_hot_table(table, hot_codes, geo["slots"], **extra)
        cold = geo["cold"]
        if cold is None:
            cold = max(256, int(keys.shape[0]
                                - lk.hot_hit_count(table, hot, keys)) + 7)
        kw = dict(hot=hot, cold_capacity=cold,
                  dedup_cold=geo.get("dedup", True))
        if delta is None:
            kw.pop("hot")
            return lk.probe_hot_cold(table, keys, hot, **kw, **extra)
    return lk.probe_with_delta(table, delta, keys, schedule=sched, **kw,
                               **extra)


# a full map is planned only under the identity hash
COMBOS = [(h, v) for h in ("identity", "fibonacci") for v in sorted(VARIANTS)
          if h == "identity" or not v.endswith("full_map")]


@pytest.mark.parametrize("state", ["none", "live", "tombstone"])
@pytest.mark.parametrize("hash_mode,variant", COMBOS)
def test_probe_schedules_match_jax(hash_mode, variant, state):
    tt, jt = _tables(hash_mode)
    s = 1.5 if hash_mode == "identity" else 0.5
    keys = _probe_keys(s)
    hot_np = (np.arange(N_KEYS, dtype=np.int32)
              if variant.endswith("full_map")
              else tskew.top_keys(keys[keys >= 0],
                                  VARIANTS[variant][1].get("hot", 0)))
    td, jd = _deltas(state)
    got = _run_schedule(tlookup, tt, _t(keys), td, variant, _t(hot_np))
    want = _run_schedule(jlookup, jt, jnp.asarray(keys), jd, variant,
                         jnp.asarray(hot_np))
    _eq_fields(got, want, variant)
    # through the probe_rows wrapper (its plain version here): same words
    got_k = _run_schedule(tlookup, tt, _t(keys), td, variant, _t(hot_np),
                          probe_fn=probe_table)
    _eq(tlookup.pack_words(got_k), jlookup.pack_words(want))
    # and the gathered probe with the same overlay: every schedule agrees
    plain = tlookup.probe(tt, _t(keys))
    if td is not None:
        plain = tlookup.overlay_delta(plain, td, _t(keys))
    _eq(tlookup.pack_words(got), tlookup.pack_words(plain).numpy())


def test_build_hot_table_and_hit_count_match_jax():
    tt, jt = _tables("fibonacci")
    hot = np.array([3, 3 + 16, 5, 9_999, 40, 7], np.int32)  # 9,999 misses
    for slots in (4, 16, 64):
        got = tlookup.build_hot_table(tt, _t(hot), slots)
        want = jlookup.build_hot_table(jt, jnp.asarray(hot), slots)
        _eq_fields(got, want, f"slots {slots}")
        keys = _probe_keys(1.5)
        assert int(tlookup.hot_hit_count(tt, got, _t(keys))) == \
            int(jlookup.hot_hit_count(jt, want, jnp.asarray(keys)))
    empty = tlookup.build_hot_table(tt, _t(np.zeros(0, np.int32)), 8)
    assert (empty.keys == EMPTY).all() and (empty.words == -2).all()
    with pytest.raises(ValueError, match="power of two"):
        tlookup.build_hot_table(tt, _t(hot), 12)


def test_probe_with_delta_rejects_bad_schedules():
    tt, _ = _tables("identity")
    td, _ = _deltas("live")
    with pytest.raises(ValueError, match="HotTable"):
        tlookup.probe_with_delta(tt, td, _t([1]), schedule="hot_cold")
    with pytest.raises(ValueError, match="unknown schedule"):
        tlookup.probe_with_delta(tt, td, _t([1]), schedule="sorted")


# ---------------------------------------------------------------------------
# JOIN with duplicates, SELECT
# ---------------------------------------------------------------------------


def _dup_tables():
    """A build side with duplicated keys: values are build-row indices."""
    rng = np.random.default_rng(21)
    keys = rng.integers(0, 50, 200).astype(np.int32)
    vals = np.arange(200, dtype=np.int32)
    return (tht.build_table(_t(keys), _t(vals), num_buckets=16,
                            bucket_width=8),
            jht.build_table(jnp.asarray(keys), jnp.asarray(vals),
                            num_buckets=16, bucket_width=8))


@pytest.mark.parametrize("capacity", [2_000, 100])
@pytest.mark.parametrize("deduped", [True, False])
def test_join_with_duplicates_matches_jax(deduped, capacity):
    tt, jt = _dup_tables()
    fk = np.random.default_rng(5).integers(-5, 60, 300).astype(np.int32)
    got = tlookup.join(tt, _t(fk), capacity=capacity, deduped=deduped)
    want = jlookup.join(jt, jnp.asarray(fk), capacity=capacity,
                        deduped=deduped)
    _eq_fields(got, want)
    assert bool(got.truncated) == (capacity == 100)
    got_k = tlookup.join(tt, _t(fk), capacity=capacity, deduped=deduped,
                         probe_fn=probe_table)
    _eq_fields(got_k, want, "probe_rows")


@pytest.mark.parametrize("key", [7, 49, 50, -1])
def test_select_where_eq_matches_jax(key):
    tt, jt = _dup_tables()
    got = tlookup.select_where_eq(tt, key, capacity=8)
    want = jlookup.select_where_eq(jt, jnp.int32(key), capacity=8)
    _eq_fields(got, want)


@pytest.mark.parametrize("capacity", [64, 10])
def test_select_distinct_matches_jax(capacity):
    tt, jt = _dup_tables()
    _eq(tlookup.select_distinct(tt, capacity=capacity),
        jlookup.select_distinct(jt, capacity=capacity))


# ---------------------------------------------------------------------------
# engine layer: a DimIndex too wide for a full map
# ---------------------------------------------------------------------------

WIDE = 70_000


@pytest.fixture(scope="module")
def wide_index():
    """(port index, JAX index, raw fact keys): 70,000 raw keys (even
    numbers), probed by a Zipf stream with misses (odd keys, keys past
    the table)."""
    dim_keys = np.arange(WIDE, dtype=np.int32) * 2
    fk = tskew.zipf_sample(75_000, 20_000, 1.5, seed=31) * 2
    fk[::13] += 1
    tidx = join.build_dim_index(_t(dim_keys), fact_keys=_t(fk))
    jidx = jjoin.build_dim_index(jnp.asarray(dim_keys), fact_keys=fk)
    return tidx, jidx, fk


def _wide_plan(idx, fk, planner, encode, top_keys, lk, keys, probe_fn=None):
    extra = {} if probe_fn is None else {"probe_fn": probe_fn}
    plan = planner.plan_probe(idx.stats.fact_skew, bucket_width=8,
                              code_space=int(idx.dictionary.n),
                              force="hot_cold")
    hot = encode(idx.dictionary, keys(top_keys(fk, plan.hot_entries)))
    ht = lk.build_hot_table(idx.table, hot, plan.hot_slots, **extra)
    codes = encode(idx.dictionary, keys(fk))
    cold = int(fk.shape[0] - lk.hot_hit_count(idx.table, ht, codes))
    return planner.refine_plan(plan, cold, int(fk.shape[0])), hot


@pytest.mark.parametrize("with_delta", [False, True])
@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_wide_index_lookup_matches_jax(wide_index, impl, with_delta):
    from repro.core.dictionary import encode as jencode
    from repro_torch.core.dictionary import encode as tencode
    tidx, jidx, fk = wide_index
    assert dataclasses.astuple(tidx.stats) == dataclasses.astuple(jidx.stats)
    assert build_stats_from(jidx.stats) == tidx.stats
    tplan, thot = _wide_plan(tidx, fk, tplanner, tencode, tskew.top_keys,
                             tlookup, _t)
    jplan, jhot = _wide_plan(jidx, fk, jplanner, jencode, jskew.top_keys,
                             jlookup, jnp.asarray)
    _same_plan(tplan, jplan)
    assert not tplan.full_map and tplan.cold_capacity < fk.shape[0]
    _eq(thot, jhot)
    if with_delta:
        rng = np.random.default_rng(8)
        ups = (rng.integers(0, WIDE, 50) * 2).astype(np.int32)
        new = np.arange(200_001, 200_041, 2, dtype=np.int32)
        pays = rng.integers(0, WIDE, 50).astype(np.int32)
        for keys, pays, op in ((ups, pays, "upsert"),
                               (new, np.arange(20, dtype=np.int32), "insert"),
                               (ups[:10], None, "delete")):
            tidx = join.ingest_index(tidx, keys, pays, op=op)
            jidx = jjoin.ingest_index(jidx, keys, pays, op=op)
        fk = np.concatenate([fk, new])
    for sched in ("gathered", "deduped", "hot_cold"):
        got = join.lookup(tidx, _t(fk), impl=impl, schedule=sched,
                          plan=tplan, hot_codes=thot)
        want = jjoin.lookup(jidx, jnp.asarray(fk), schedule=sched,
                            plan=jplan, hot_codes=jhot)
        _eq(tlookup.pack_words(got), jlookup.pack_words(want), sched)
    got = join.join_pairs(tidx, _t(fk), capacity=25_000, impl=impl)
    want = jjoin.join_pairs(jidx, jnp.asarray(fk), capacity=25_000)
    _eq_fields(got, want, "join_pairs")


# ---------------------------------------------------------------------------
# SSBEngine under every schedule
# ---------------------------------------------------------------------------

KINDS = ("ingest", "delete", "append_rows", "compact")
SEED = 158  # folds two live deltas (see test_torch_ingest.py)


def _answers(engine):
    return {q: (int(t), np.asarray(g)) for q, (t, g) in
            engine.run_all().items()}


def _assert_answers(got, want, msg):
    assert sorted(got) == sorted(want) == sorted(SSB_QUERIES)
    for q, (total, groups) in want.items():
        assert got[q][0] == total, (msg, q)
        np.testing.assert_array_equal(got[q][1], groups, err_msg=f"{msg} {q}")


def _assert_plans(port, ref, msg):
    assert sorted(port.plans) == sorted(ref.plans)
    for dim, plan in ref.plans.items():
        assert dataclasses.astuple(port.plans[dim]) == \
            dataclasses.astuple(plan), (msg, dim)
        if plan.schedule == "hot_cold":
            _eq(port._hot_codes[dim], ref._hot_codes[dim], f"{msg} {dim}")


def _wide_part(tables_fn, dims_fn, device_kw):
    """SSB tables with a 70,000-row part table: past the hot budget."""
    tables = dict(tables_fn(SF, **device_kw))
    tables["part"] = dims_fn(0.35, **device_kw)["part"]
    return tables


@pytest.mark.parametrize("schedule,wide", [
    ("auto", False), ("deduped", False), ("hot_cold", False),
    ("hot_cold", True), ("auto", True)])
def test_engine_schedules_match_jax_through_mutation(schedule, wide):
    """Plans and the 13 answers, before any ingest, with live deltas and
    after compaction, along a seeded mutation stream."""
    if wide:
        jtables = _wide_part(jax_generate_ssb, jax_generate_ssb_dims, {})
        ttables = _wide_part(generate_ssb, generate_ssb_dims,
                             {"device": "cpu"})
    else:
        jtables = jax_generate_ssb(SF)
        ttables = generate_ssb(SF, device="cpu")
    ref = JaxEngine(dict(jtables), policy=JaxPolicy(kernel="xla",
                                                    schedule=schedule))
    engines = {k: SSBEngine(dict(ttables), policy=ExecutionPolicy(
        kernel=k, schedule=schedule), device="cpu")
        for k in ("torch", "cuda")}
    port = engines["torch"]
    if wide:
        assert not port.plans["part"].full_map
    rngs = {k: np.random.default_rng(SEED) for k in ("jax", *engines)}
    seen = set()
    for step in range(4 if wide else 6):
        if step:
            kind, _ = jax_random_mutation(ref, rngs["jax"], kinds=KINDS)
            for k, e in engines.items():
                random_mutation(e, rngs[k], kinds=KINDS)
            seen.add(kind)
        _assert_plans(port, ref, f"step {step}")
        want = _answers(ref)
        for k, e in engines.items():
            _assert_answers(_answers(e), want, f"{k} step {step}")
        assert [d for d, ix in port.indexes.items() if ix.delta is not None] \
            == [d for d, ix in ref.indexes.items() if ix.delta is not None]
    assert port.plans["date"].schedule == \
        ("gathered" if schedule == "auto" else schedule)
    assert "compact" in seen or wide


@pytest.mark.parametrize("schedule", ["deduped", "hot_cold"])
def test_engine_cold_paths_under_forced_schedules(schedule):
    """Cold composed probes and the mega path give the cached answers
    under a forced schedule, on both kernels."""
    tables = generate_ssb(SF, device="cpu")
    for kernel in ("cuda", "torch"):
        e = SSBEngine(tables, policy=ExecutionPolicy(kernel=kernel,
                                                     schedule=schedule),
                      device="cpu")
        want = {q: (int(t), np.asarray(g)) for q, (t, g) in
                e.run_all().items()}
        for path in ({q: e.run(q, use_cache=False) for q in SSB_QUERIES},
                     {q: e.run(q, fusion="mega") for q in SSB_QUERIES},
                     e.run_all(fusion="mega", use_cache=False)):
            _assert_answers({q: (int(t), np.asarray(g))
                             for q, (t, g) in path.items()}, want, kernel)


@pytest.mark.parametrize("kernel", ["cuda", "torch"])
def test_auto_schedule_is_refused_on_a_cuda_engine(monkeypatch, kernel):
    """No longer refused: an engine on the card plans every dimension on
    the card's cost entry (the CUDA kernels keep gathered; the torch
    kernel takes the priced pick) and answers as before."""
    tables = generate_ssb(SF, device="cpu")
    e = SSBEngine(tables, policy=ExecutionPolicy(kernel=kernel),
                  device="cpu")
    want = _answers(e)
    monkeypatch.setattr(e, "device", torch.device("cuda"))
    for dim, ix in e.indexes.items():
        e._plan_dim(dim)
        st = ix.stats
        plan = tplanner.plan_probe(
            st.fact_skew, bucket_width=st.bucket_width, backend="cuda",
            impl=kernel, code_space=int(ix.dictionary.n),
            hash_mode=ix.table.hash_mode)
        got = e.plans[dim]
        assert got.schedule == plan.schedule
        assert got.est_seconds == plan.est_seconds
        if kernel == "cuda":
            assert got.schedule == "gathered"
    monkeypatch.undo()
    e.invalidate_probe_cache()
    _assert_answers(_answers(e), want, f"replanned on cuda ({kernel})")
    # baseline mode plans nothing
    b = SSBEngine(tables, policy=ExecutionPolicy(mode="baseline"),
                  device="cpu")
    assert b.plans == {}


def test_adopted_jax_indexes_carry_their_skew():
    """An engine on the JAX engine's indexes (through engine/convert.py,
    ``build_stats_from``) plans exactly as the JAX engine did."""
    ref = JaxEngine(jax_generate_ssb(SF),
                    policy=JaxPolicy(kernel="xla", schedule="hot_cold"))
    indexes = {d: dim_index_from_numpy(_index_arrays(ix),
                                       build_stats_from(ix.stats), "cpu")
               for d, ix in ref.indexes.items()}
    host = {n: {c: np.asarray(t[c]) for c in t.names()}
            for n, t in ref.tables.items()}
    port = SSBEngine(tables_from_numpy(host, "cpu"), indexes=indexes,
                     policy=ExecutionPolicy(kernel="torch",
                                            schedule="hot_cold"),
                     device="cpu")
    _assert_plans(port, ref, "adopted")
    _assert_answers(_answers(port), _answers(ref), "adopted")
    assert build_stats_from(None) is None
    assert isinstance(port.build_stats["part"].fact_skew, tskew.SkewStats)


def _index_arrays(index):
    """A JAX ``DimIndex`` as the host arrays ``dim_index_from_numpy``
    takes."""
    d, t = index.dictionary, index.table
    return {"dictionary": {"keys": np.asarray(d.keys), "n": np.asarray(d.n),
                           "codes": None if d.codes is None
                           else np.asarray(d.codes)},
            "table": dict({f: np.asarray(getattr(t, f)) for f in (
                "keys", "values", "dup_offsets", "dup_indices",
                "group_count", "n_unique", "n_build", "overflow")},
                hash_mode=t.hash_mode)}
