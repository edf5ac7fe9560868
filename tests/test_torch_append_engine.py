"""The port's fact-side append path, piece by piece, against the JAX package.

The tail geometry (``tail_bucket``, ``round_up``, ``pad_batch``,
``append_tail``), the splice and tail probe, ``generate_fact_batch``, the
forced schedules after appends, the no-op append, batch validation,
appends interleaved with dimension ingest, the skew-drift re-plan, the
planner's pricing, the unpriced append of a CUDA engine, and aliasing:
held probes and columns, and engines sharing one ``tables`` mapping.
The seeded differential stream is ``test_torch_append.py``.
"""
import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import costmodel as jcostmodel
from repro.core import planner as jplanner
from repro.core.lookup import splice_probe as jax_splice
from repro.core.skew import measure_skew as jax_measure_skew
from repro.engine import SSBEngine as JaxEngine
from repro.engine import generate_ssb as jax_generate_ssb
from repro.engine import join as jjoin
from repro.engine import table as jtable
from repro.engine.ssb import generate_fact_batch as jax_generate_fact_batch
from repro_torch.core import ExecutionPolicy, costmodel, planner
from repro_torch.core.hash_table import EMPTY_KEY
from repro_torch.core.lookup import splice_probe
from repro_torch.core.skew import measure_skew
from repro_torch.engine import (SSB_QUERIES, SSBEngine, build_stats_from,
                                generate_fact_batch, generate_ssb)
from repro_torch.engine import table as ptable
from repro_torch.engine.join import (build_dim_index, extend_cached_probe,
                                     ingest_index, tail_lookup)
from repro_torch.engine.ssb import LINEORDER_COLUMNS

SF = 0.002
NAMES = sorted(SSB_QUERIES)
DIMS = ("customer", "supplier", "part", "date")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread_when_parallel():
    """In a parallel run (pytest-xdist workers share the cores) this
    module's torch ops take one thread each: OpenMP regions, which wait
    for every thread, stall when the cores are oversubscribed.  Alone,
    torch keeps its default."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        yield
        return
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(answers):
    return {q: (int(t), np.asarray(g)) for q, (t, g) in answers.items()}


def _assert_same(got, want, msg):
    assert sorted(got) == sorted(want) == NAMES
    for q, (total, groups) in want.items():
        assert got[q][0] == total, f"{msg} {q} total"
        np.testing.assert_array_equal(got[q][1], groups,
                                      err_msg=f"{msg} {q}")


# ---------------------------------------------------------------------------
# tail geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 1000, 4096, 600_000])
def test_tail_bucket_and_round_up_match_jax(n):
    for mb in (1, 256, 1024):
        assert ptable.tail_bucket(n, mb) == jtable.tail_bucket(n, mb)
    for q in (1, 7, 256, 1 << 20):
        assert ptable.round_up(n, q) == jtable.round_up(n, q)
    assert (ptable.TAIL_MIN_BUCKET, ptable.TAIL_GROWTH_BATCHES,
            ptable.TAIL_RESERVE_FRAC) == (jtable.TAIL_MIN_BUCKET,
                                          jtable.TAIL_GROWTH_BATCHES,
                                          jtable.TAIL_RESERVE_FRAC)


def test_pad_batch_matches_jax():
    vals = np.arange(5, dtype=np.int32) * 3
    for n_pad in (5, 8, 256):
        got = ptable.pad_batch(vals, n_pad, EMPTY_KEY, "cpu")
        want = jtable.pad_batch(vals, n_pad, int(EMPTY_KEY))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        ptable.pad_batch(vals, 4, 0, "cpu")


def test_append_tail_matches_jax_over_ragged_batches_and_growth():
    """Ragged batches, forced buckets and several growths: every column,
    ``n_rows`` and ``n_physical`` equal the JAX package's after each."""
    rng = np.random.default_rng(3)
    base = {"a": rng.integers(0, 100, 1000, dtype=np.int32),
            "k": rng.integers(0, 50, 1000, dtype=np.int32)}
    pt = ptable.Table.from_numpy(base, "cpu")
    jt = jtable.Table.from_numpy(base)
    pads = {"k": int(EMPTY_KEY)}
    grew = 0
    for i, b in enumerate((1, 300, 255, 1000, 4000, 17, 2048, 5000)):
        batch = {c: rng.integers(0, 100, b, dtype=np.int32) for c in base}
        kw = {"bucket": 8192} if i == 5 else {"min_bucket": 64 + 64 * (i % 2)}
        n_phys = pt.n_physical
        pt = pt.append_tail(batch, pads, **kw)
        jt = jt.append_tail(batch, pads, **kw)
        grew += pt.n_physical != n_phys
        assert (pt.n_rows, pt.n_physical, pt.tail_owned) == \
            (jt.n_rows, jt.n_physical, jt.tail_owned)
        for c in base:
            np.testing.assert_array_equal(pt[c].numpy(), np.asarray(jt[c]))
        trimmed = pt.trimmed()
        assert trimmed.n_rows == trimmed.n_physical == jt.n_rows
        np.testing.assert_array_equal(trimmed["k"].numpy(),
                                      np.asarray(jt.trimmed()["k"]))
    assert grew >= 3
    with pytest.raises(ValueError):
        pt.append({c: np.zeros(2, np.int32) for c in base})
    with pytest.raises(ValueError):
        pt.append_tail({"a": np.zeros(2, np.int32)})


def test_append_tail_writes_in_place_only_into_its_own_buffers():
    base = {"a": np.arange(100, dtype=np.int32)}
    t0 = ptable.Table.from_numpy(base, "cpu")
    t1 = t0.append_tail({"a": np.arange(3, dtype=np.int32)})
    np.testing.assert_array_equal(t0["a"].numpy(), base["a"])  # copied
    t2 = t1.append_tail({"a": np.arange(3, dtype=np.int32) + 7})
    assert t2["a"].data_ptr() == t1["a"].data_ptr()  # owned: in place
    np.testing.assert_array_equal(t1["a"][:t1.n_rows].numpy(),
                                  t2["a"][:t1.n_rows].numpy())
    shared = ptable.Table(dict(t2.columns), valid_rows=t2.n_rows)
    t3 = shared.append_tail({"a": np.arange(3, dtype=np.int32)})
    assert t3["a"].data_ptr() != t2["a"].data_ptr()  # not owned: a copy
    assert t2["a"][t2.n_rows:].eq(0).all()


def test_splice_and_extension_match_jax():
    """``splice_probe``, ``tail_lookup`` and ``extend_cached_probe`` against
    the JAX package's on an index with a live delta and a padded tail."""
    tables = generate_ssb(SF, device="cpu")
    jt = jax_generate_ssb(SF)
    pidx = build_dim_index(tables["part"]["partkey"])
    jjidx = jjoin.build_dim_index(jt["part"]["partkey"])
    keys = np.array([1, 2, 400, 401], np.int32)
    pays = np.array([3, 401, 0, 5], np.int32)
    pidx = ingest_index(pidx, keys, pays)
    jjidx = jjoin.ingest_index(jjidx, keys, pays)
    fk = np.asarray(jt["lineorder"]["partkey"])
    n0, b = 900, 100
    tail = jtable.pad_batch(fk[n0:n0 + b], 256, int(EMPTY_KEY))
    ptail = ptable.pad_batch(fk[n0:n0 + b], 256, EMPTY_KEY, "cpu")
    for impl in ("torch", "cuda"):
        got = tail_lookup(pidx, ptail, impl=impl)
        want = jjoin.tail_lookup(jjidx, tail, impl="xla")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        found = torch.zeros(2048, dtype=torch.bool)
        row = torch.full((2048,), -1, dtype=torch.int32)
        for owned in (False, True):
            f, r = extend_cached_probe(pidx, found, row, ptail, n0,
                                       impl=impl, owned=owned)
            jf, jr = jjoin.extend_cached_probe(
                jjidx, jnp.zeros(2048, bool), jnp.full(2048, -1, jnp.int32),
                tail, jnp.int32(n0), impl="xla")
            np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
            np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
            assert (f.data_ptr() == found.data_ptr()) == owned
        assert not f[n0 + b:].any() and f[n0:n0 + b].any()
    head = (torch.arange(10, dtype=torch.int32),)
    out = splice_probe(head, (torch.tensor([-5, -6], dtype=torch.int32),), 3)
    jout = jax_splice((jnp.arange(10, dtype=jnp.int32),),
                      (jnp.asarray([-5, -6], jnp.int32),), jnp.int32(3))
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jout[0]))
    assert head[0][3] == 3  # not owned: the head is unchanged


def test_hot_cold_tail_lookup_clamps_the_cold_stream_to_the_tail(
        monkeypatch):
    """A hot/cold plan's cold capacity is sized to the whole fact stream;
    the tail probe clamps it to the tail's length (O(tail) work) and
    answers as the JAX package's unclamped tail lookup."""
    import repro_torch.engine.join as pjoin
    from repro.core.dictionary import encode as jencode
    from repro.core.skew import top_keys as jtop_keys
    from repro_torch.core.dictionary import encode
    from repro_torch.core.skew import top_keys
    tables = generate_ssb(SF, device="cpu")
    jt = jax_generate_ssb(SF)
    pidx = build_dim_index(tables["customer"]["custkey"])
    jjidx = jjoin.build_dim_index(jt["customer"]["custkey"])
    fk = np.asarray(jt["lineorder"]["custkey"])
    tail = jtable.pad_batch(fk[:200], 256, int(EMPTY_KEY))
    ptail = ptable.pad_batch(fk[:200], 256, EMPTY_KEY, "cpu")
    hot = encode(pidx.dictionary, torch.as_tensor(top_keys(fk, 8)))
    jhot = jencode(jjidx.dictionary, jnp.asarray(jtop_keys(fk, 8)))
    caps = []
    real = pjoin.probe_hot_cold
    monkeypatch.setattr(pjoin, "probe_hot_cold", lambda *a, **k: (
        caps.append(k["cold_capacity"]), real(*a, **k))[1])
    for cap in (4096, 64):
        plan = planner.SchedulePlan(schedule="hot_cold", hot_entries=8,
                                    hot_slots=16, cold_capacity=cap)
        jplan = jplanner.SchedulePlan(schedule="hot_cold", hot_entries=8,
                                      hot_slots=16, cold_capacity=cap)
        want = jjoin.tail_lookup(jjidx, tail, jhot, impl="xla", plan=jplan)
        for impl in ("torch", "cuda"):
            got = tail_lookup(pidx, ptail, hot, impl=impl, plan=plan)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # clamped to the 256-row tail; a capacity under it (the overflow
    # fallback's case) is kept
    assert caps == [256, 256, 64, 64]


# ---------------------------------------------------------------------------
# the engine surface: schedules, no-op, interleaving, drift, pricing
# ---------------------------------------------------------------------------


def _batch(tables, rng, n):
    return generate_fact_batch(tables, n, rng)


def test_generate_fact_batch_matches_jax():
    tables = generate_ssb(SF, device="cpu")
    jt = jax_generate_ssb(SF)
    got = generate_fact_batch(tables, 300, np.random.default_rng(4))
    want = jax_generate_fact_batch(jt, 300, np.random.default_rng(4))
    assert tuple(got) == tuple(want) == LINEORDER_COLUMNS
    for c in got:
        assert got[c].dtype == np.int32, c
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)


def _schedule_timeline(tables):
    """The supplier rows and the three fact batches of the forced-schedule
    timeline (a third of each batch joins the new suppliers)."""
    n_supp = tables["supplier"].n_rows
    new_supp = np.arange(n_supp, n_supp + 40, dtype=np.int32)
    supp_rows = {"suppkey": new_supp, "city": np.full(40, 141, np.int32),
                 "nation": np.full(40, 14, np.int32),
                 "region": np.full(40, 2, np.int32)}
    rng = np.random.default_rng(42)
    batches = []
    for i in range(3):
        b = _batch(tables, rng, 150)
        b["suppkey"][:len(new_supp)] = new_supp
        b["orderkey"] += i * 150
        batches.append(b)
    return supp_rows, batches


def _drive_timeline(engine, supp_rows, batches):
    engine.warm_cache()
    engine.append_rows("supplier", supp_rows, auto_compact=False)
    for b in batches:
        engine.append_fact_rows(b)
    assert engine.fact_append_info()["tail_extensions"] > 0
    assert engine.indexes["supplier"].delta is not None


@pytest.fixture(scope="module")
def schedule_reference():
    """The timeline's tables and the JAX engine's answers after it."""
    tables = generate_ssb(SF, seed=3, device="cpu")
    supp_rows, batches = _schedule_timeline(tables)
    jengine = JaxEngine(dict(jax_generate_ssb(SF, seed=3)), "jspim", "xla",
                        "gathered")
    _drive_timeline(jengine, supp_rows, batches)
    return tables, supp_rows, batches, _np(
        jengine.run_all(fusion="composed"))


@pytest.mark.parametrize("kernel", ["cuda", "torch"])
def test_forced_schedules_after_appends(schedule_reference, kernel):
    """Forced-schedule engines (and ``auto``, planned with the CPU costs)
    fed one ingest + append timeline agree with the JAX engine, cached and
    cold, and so do the baseline engine and a rebuild over the trimmed
    tables: cached probes extended over the tails, the delta overlay
    live."""
    tables, supp_rows, batches, want = schedule_reference
    engines = {s: SSBEngine(dict(tables), "jspim", kernel, s, device="cpu")
               for s in ("auto", "gathered", "stream", "deduped",
                         "hot_cold")}
    for s, e in engines.items():
        _drive_timeline(e, supp_rows, batches)
        _assert_same(_np(e.run_all(fusion="composed")), want, s)
        _assert_same(_np({q: e.run(q, use_cache=False) for q in NAMES}),
                     want, f"{s} cold")
    assert engines["hot_cold"].plans["part"].schedule == "hot_cold"
    ref = engines["gathered"]
    trimmed = dict(ref.tables, lineorder=ref.tables["lineorder"].trimmed())
    for mode in ("jspim", "baseline"):
        oracle = SSBEngine(dict(trimmed), mode, kernel, device="cpu")
        _assert_same(_np(oracle.run_all(fusion="composed")), want, mode)


def test_zero_row_append_is_a_strict_noop():
    engine = SSBEngine(dict(generate_ssb(SF, device="cpu")), device="cpu")
    engine.warm_cache()
    before = (engine.cache_info(), engine.fact_append_info(), engine.epoch)
    cached = {d: engine._probe_cache[d] for d in DIMS}
    fact = engine.tables["lineorder"]
    empty = {c: np.zeros(0, np.int32) for c in LINEORDER_COLUMNS}
    report = engine.append_fact_rows(empty)
    assert report == {"appended": 0, "epoch": 0, "dims": {},
                      "capacity_grew": False, "skew_replanned": []}
    assert (engine.cache_info(), engine.fact_append_info(),
            engine.epoch) == before
    assert engine.tables["lineorder"] is fact
    assert all(engine._probe_cache[d] is cached[d] for d in DIMS)


@pytest.mark.parametrize("bad", ["missing", "ragged", "float", "2d"])
def test_fact_batches_are_validated(bad):
    engine = SSBEngine(dict(generate_ssb(SF, device="cpu")), device="cpu")
    rows = generate_fact_batch(engine.tables, 5, np.random.default_rng(0))
    if bad == "missing":
        del rows["revenue"]
    elif bad == "ragged":
        rows["revenue"] = rows["revenue"][:3]
    elif bad == "float":
        rows["revenue"] = rows["revenue"].astype(np.float32)
    else:
        rows["revenue"] = rows["revenue"].reshape(5, 1)
    with pytest.raises(ValueError):
        engine.append_fact_rows(rows)
    assert engine.fact_append_info()["appends"] == 0 and engine.epoch == 0


def test_appends_interleaved_with_dimension_ingest_match_a_rebuild():
    """Fact appends x §3.2.3 updates x dimension ingest: every query and
    every cached probe equal an engine rebuilt over the logical state,
    and no padding row ever joins."""
    rng = np.random.default_rng(7)
    tables = generate_ssb(SF, device="cpu")
    engine = SSBEngine(dict(tables), policy=ExecutionPolicy(kernel="cuda"),
                       device="cpu")
    engine.warm_cache()
    n_supp = engine.tables["supplier"].n_rows
    new_supp = np.arange(n_supp, n_supp + 30, dtype=np.int32)
    engine.append_rows("supplier", {
        "suppkey": new_supp, "city": np.full(30, 145, np.int32),
        "nation": np.full(30, 14, np.int32),
        "region": np.full(30, 2, np.int32)}, auto_compact=False)
    for i in range(3):
        b = _batch(engine.tables, rng, 120)
        b["suppkey"][::4] = new_supp[:30]
        assert engine.append_fact_rows(b)["appended"] == 120
    victim = int(engine.tables["part"]["partkey"][11])
    engine.index_update("part", victim, 3)
    doomed = tables["date"]["datekey"][5:9].numpy()
    engine.ingest("date", doomed, op="delete", auto_compact=False)
    for i in range(2):
        b = _batch(engine.tables, rng, 90)
        b["orderdate"][:4] = doomed
        engine.append_fact_rows(b)
    info = engine.fact_append_info()
    assert info["appends"] == 5 and info["fact_epoch"] == 5
    assert info["tail_extensions"] > 0
    trimmed = dict(engine.tables,
                   lineorder=engine.tables["lineorder"].trimmed())
    oracle = SSBEngine(dict(trimmed), device="cpu")
    oracle.index_update("part", victim, 3)
    oracle.ingest("date", doomed, op="delete", auto_compact=False)
    for path in ({}, {"use_cache": False}, {"fusion": "mega"}):
        got = _np({q: engine.run(q, **path) for q in NAMES})
        _assert_same(got, _np(oracle.run_all(fusion="composed")), str(path))
    n = engine.tables["lineorder"].n_rows
    for dim in DIMS:
        fa, ra = (x.numpy() for x in engine.probe_dim(dim))
        fb, rb = (x.numpy() for x in oracle.probe_dim(dim))
        np.testing.assert_array_equal(fa[:n], fb, err_msg=dim)
        np.testing.assert_array_equal(ra[:n][fb], rb[fb], err_msg=dim)
        assert not fa[n:].any(), f"{dim}: capacity padding joined"


def test_skew_drift_replan_matches_jax():
    """A batch that moves the top share past ``TOP_SHARE_DRIFT`` and the
    stream past ``FACT_REMEASURE_FRAC``: both engines (``auto``, planned
    with the CPU costs) re-plan the same dimensions, to the same plans,
    and keep answering alike."""
    tables = generate_ssb(SF, device="cpu")
    jt = jax_generate_ssb(SF)
    engine = SSBEngine(dict(tables), "jspim", "torch", "auto", device="cpu")
    jengine = JaxEngine(dict(jt), "jspim", "xla", "auto")
    for e in (engine, jengine):
        e.warm_cache()
    n = int(tables["lineorder"].n_rows * planner.FACT_REMEASURE_FRAC) + 1
    rows = generate_fact_batch(tables, n, np.random.default_rng(9))
    rows["custkey"][:] = 7  # one customer takes a tenth of the stream
    rows["orderdate"][: n // 2] = 11
    got, want = engine.append_fact_rows(rows), jengine.append_fact_rows(rows)
    assert got == want
    assert "customer" in want["skew_replanned"]
    info = engine.fact_append_info()
    # the port's own count: every dimension at build and at the re-measure
    assert info.pop("skew_measures") == 2 * len(DIMS)
    assert info == jengine.fact_append_info()
    for d in DIMS:
        p, jp = engine.plans[d], jengine.plans[d]
        assert (p.schedule, p.hot_entries, p.hot_slots, p.cold_capacity,
                p.full_map) == (jp.schedule, jp.hot_entries, jp.hot_slots,
                                jp.cold_capacity, jp.full_map), d
        assert engine.indexes[d].stats.fact_skew == \
            build_stats_from(jengine.indexes[d].stats).fact_skew, d
        assert torch.equal(engine._hot_codes[d], torch.as_tensor(
            np.array(jengine._hot_codes[d]))) if d in jengine._hot_codes \
            else d not in engine._hot_codes
    _assert_same(_np(engine.run_all(fusion="composed")),
                 _np(jengine.run_all(fusion="composed")), "after re-plan")
    assert engine._maybe_replan_fact_skew(force=True) == \
        jengine._maybe_replan_fact_skew(force=True)


def test_pricing_matches_jax_on_the_cpu():
    rng = np.random.default_rng(1)
    keys = rng.zipf(1.3, 50_000).astype(np.int32) % 5000
    stats, jstats = measure_skew(keys), jax_measure_skew(keys)
    keys2 = rng.integers(0, 5000, 50_000).astype(np.int32)
    s2, js2 = measure_skew(keys2), jax_measure_skew(keys2)
    assert planner.skew_drift(stats, s2) == jplanner.skew_drift(jstats, js2)
    assert (planner.TOP_SHARE_DRIFT, planner.FACT_REMEASURE_FRAC) == \
        (jplanner.TOP_SHARE_DRIFT, jplanner.FACT_REMEASURE_FRAC)
    for sched in ("gathered", "stream", "deduped", "hot_cold"):
        plan = planner.plan_probe(stats, bucket_width=8, force=sched,
                                  code_space=5000)
        jplan = jplanner.plan_probe(jstats, bucket_width=8, force=sched,
                                    code_space=5000)
        for n_tail, n_cached in ((0, 1000), (256, 10_000),
                                 (1 << 20, 60_000_000), (1 << 20, 1000)):
            for delta_slots in (0, 4096):
                kw = dict(n_tail=n_tail, n_cached=n_cached, distinct=5000,
                          bucket_width=8, delta_slots=delta_slots)
                got = planner.plan_fact_append(plan, **kw)
                want = jplanner.plan_fact_append(jplan, **kw)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
                geom = dict(cold_capacity=plan.cold_capacity,
                            hot_slots=plan.hot_slots)
                kw.pop("n_tail")
                assert costmodel.tail_extend_seconds(
                    sched, n_tail=max(1, n_tail), **kw, **geom) == \
                    jcostmodel.tail_extend_seconds(
                        sched, n_tail=max(1, n_tail), **kw, **geom)
    # the card's entry prices it; a backend without one raises
    for sched in ("gathered", "stream", "deduped", "hot_cold"):
        plan = planner.plan_probe(stats, bucket_width=8, force=sched,
                                  code_space=5000, backend="cuda")
        ap = planner.plan_fact_append(plan, n_tail=1 << 20,
                                      n_cached=60_000_000, distinct=5000,
                                      bucket_width=8, backend="cuda")
        assert ap.extend and 0 < ap.est_tail_s < ap.est_reprobe_s, sched
    with pytest.raises(NotImplementedError, match="tpu"):
        planner.plan_fact_append(plan, n_tail=256, n_cached=1000,
                                 distinct=10, bucket_width=8,
                                 backend="tpu")


def test_a_cuda_engine_extends_unpriced(monkeypatch):
    """Priced now: an engine on the card asks ``_fact_append_plan`` (the
    card's entry) for every cached dimension and follows it (at this tiny
    size the card's fixed launch costs can favour a reprobe; at SF10 it
    extends, ``test_torch_planner.py``), and ``extend_cache=False``
    invalidates."""
    tables = generate_ssb(SF, device="cpu")
    engine = SSBEngine(dict(tables), device="cpu")
    engine.warm_cache(("part", "date"))
    monkeypatch.setattr(engine, "device", torch.device("cuda"))
    asked = []
    real = engine._fact_append_plan

    def spy(dim, n_tail, n_cached):
        ap = real(dim, n_tail, n_cached)
        asked.append((dim, ap))
        return ap
    monkeypatch.setattr(engine, "_fact_append_plan", spy)
    rng = np.random.default_rng(2)
    rep = engine.append_fact_rows(_batch(engine.tables, rng, 50))
    assert [d for d, _ in asked] == ["date", "part"]
    assert rep["dims"] == {d: "extended" if ap.extend else ap.reason
                           for d, ap in asked}
    extended = sum(ap.extend for _, ap in asked)
    engine.warm_cache(("part", "date"))
    idx = engine.indexes["part"]
    want = planner.plan_fact_append(
        engine.plans["part"], n_tail=256, n_cached=1000,
        distinct=idx.stats.fact_skew.distinct, bucket_width=8,
        backend="cuda")
    assert real("part", 256, 1000) == want
    rep = engine.append_fact_rows(_batch(engine.tables, rng, 50),
                                  extend_cache=False)
    assert rep["dims"] == {"date": "invalidated", "part": "invalidated"}
    assert engine.cache_info()["cached_dims"] == []
    info = engine.fact_append_info()
    assert (info["tail_extensions"], info["tail_reprobes"]) == \
        (extended, 4 - extended)
    monkeypatch.undo()
    oracle = SSBEngine(dict(engine.tables,
                            lineorder=engine.tables["lineorder"].trimmed()),
                       device="cpu")
    _assert_same(_np(engine.run_all(fusion="composed")),
                 _np(oracle.run_all(fusion="composed")), "unpriced")


# ---------------------------------------------------------------------------
# aliasing and carried-over state
# ---------------------------------------------------------------------------


def test_held_probes_and_columns_never_change():
    """A ``probe_dim`` tuple and fact columns held before an append are
    unchanged after it, and two engines on one ``tables`` mapping never
    see each other's appends."""
    tables = generate_ssb(SF, device="cpu")
    a = SSBEngine(tables, device="cpu")
    b = SSBEngine(tables, device="cpu")
    rng = np.random.default_rng(5)
    base = {c: v.clone() for c, v in tables["lineorder"].columns.items()}
    held = {d: tuple(x.clone() for x in a.probe_dim(d)) for d in DIMS}
    tuples = {d: a.probe_dim(d) for d in DIMS}
    answers_b = _np(b.run_all(fusion="composed"))
    for i in range(3):
        a.append_fact_rows(_batch(a.tables, rng, 40))
        cols = dict(a.tables["lineorder"].columns)
        n = a.tables["lineorder"].n_rows
        snap = {c: v[:n].clone() for c, v in cols.items()}
        held_tuple = a.probe_dim("part")
        held_copy = tuple(x.clone() for x in held_tuple)
        a.append_fact_rows(_batch(a.tables, rng, 40))
        for x, y in zip(held_tuple, held_copy):
            assert torch.equal(x, y)
        for c, v in cols.items():  # logical rows of the held columns
            assert torch.equal(v[:n], snap[c])
    for d in DIMS:
        for x, y in zip(tuples[d], held[d]):
            assert torch.equal(x, y), d
    for c, v in base.items():
        assert torch.equal(tables["lineorder"][c], v), c
    assert b.tables["lineorder"].n_rows == base["orderkey"].shape[0]
    _assert_same(_np(b.run_all(fusion="composed")), answers_b, "engine b")
    # an engine built on another engine's grown table copies it
    c = SSBEngine(dict(a.tables), device="cpu")
    want = _np(c.run_all(fusion="composed"))
    a.append_fact_rows(_batch(a.tables, rng, 40))
    _assert_same(_np(c.run_all(fusion="composed")), want, "engine c")
    assert c.tables["lineorder"].n_rows < a.tables["lineorder"].n_rows
