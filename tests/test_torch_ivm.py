"""The port's incremental view maintenance against the JAX package's.

The port's ``MaintainedSuite`` and the JAX package's take the same
mutation batches (the same numpy arrays, or the same seeded
``random_mutation`` draws) on engines built from the same seed; after
every event the port's 13 maintained answers must equal the JAX suite's
and the port engine's ``run_all``, bit for bit (no tolerance: the
arithmetic is int32 wraparound with int64 accumulation).  The mutation
hooks deliver the same events (kind, meta, arrays, epochs) as the JAX
engine's.  The cases are ``tests/test_ivm.py``'s.
"""
import dataclasses

import numpy as np
import pytest

from repro.engine import SSBEngine as JaxEngine
from repro.engine import generate_ssb as jax_generate_ssb
from repro.engine.ssb import random_mutation as jax_random_mutation
from repro.ivm import MaintainedSuite as JaxSuite
from repro_torch.engine import SSB_QUERIES, SSBEngine, generate_ssb
from repro_torch.engine.ssb import generate_fact_batch, random_mutation
from repro_torch.ivm import MaintainedSuite, wrap_i32
from repro_torch.serving import LogicalModel

SF = 0.002


@pytest.fixture(scope="module")
def tables():
    return generate_ssb(SF, seed=11, device="cpu")


def _pair(tables, seed=11):
    """(port engine, JAX engine) on the same generated tables."""
    port = SSBEngine(dict(tables), device="cpu")
    ref = JaxEngine(jax_generate_ssb(SF, seed=seed), mode="jspim")
    return port, ref


def _suites(port, ref):
    return MaintainedSuite.attach(port), JaxSuite.attach(ref)


def _both(engines, fn):
    for eng in engines:
        fn(eng)


def _assert_suite_matches(port, suite, jsuite, tag=""):
    """The port suite is fresh and equals the JAX suite and ``run_all``."""
    __tracebackhide__ = True
    assert suite.fresh_at(port.epoch), \
        f"{tag}: suite not fresh (valid={suite.valid}, " \
        f"epoch={suite.epoch} vs {port.epoch})"
    assert jsuite.valid and jsuite.epoch == suite.epoch, tag
    full = port.run_all(fusion="composed")
    got, want = suite.results(), jsuite.results()
    assert sorted(got) == sorted(want) == sorted(SSB_QUERIES)
    for name, (t, g) in full.items():
        mt, mg = got[name]
        assert mt == want[name][0] == int(t), (tag, name)
        assert mg.dtype == np.int32, (tag, name)
        np.testing.assert_array_equal(mg, want[name][1], err_msg=tag)
        np.testing.assert_array_equal(mg, g.numpy(), err_msg=tag)


def _events(eng):
    events = []
    eng.add_mutation_hook(events.append)
    return events


def _same_events(got, want):
    assert [e.kind for e in got] == [e.kind for e in want]
    for a, b in zip(got, want):
        assert (a.meta, a.epoch, a.fact_epoch) == (b.meta, b.epoch,
                                                   b.fact_epoch), a.kind
        assert sorted(a.arrays) == sorted(b.arrays), a.kind
        for k in a.arrays:
            np.testing.assert_array_equal(a.arrays[k],
                                          np.asarray(b.arrays[k]))


# ---------------------------------------------------------------------------
# the mutation-hook fan-out
# ---------------------------------------------------------------------------


def test_hooks_deliver_post_publish_in_order(tables):
    port, ref = _pair(tables)
    ev_port, ev_ref = _events(port), _events(ref)
    ck = tables["customer"]["custkey"].numpy()
    batch = generate_fact_batch(port.tables, 16, np.random.default_rng(0))
    _both((port, ref), lambda e: e.ingest(
        "customer", ck[:2].copy(), np.asarray([0, 1], np.int32),
        auto_compact=False))
    _both((port, ref), lambda e: e.append_fact_rows(batch))
    _both((port, ref), lambda e: e.compact("customer"))
    assert [e.kind for e in ev_port] == ["ingest", "append_fact_rows",
                                         "compact"]
    # every event is stamped with the epoch its effect is visible at
    assert [e.epoch for e in ev_port] == [1, 2, 3]
    _same_events(ev_port, ev_ref)
    port.remove_mutation_hook(ev_port.append)
    port.ingest("customer", ck[:1].copy(), np.asarray([0], np.int32),
                auto_compact=False)
    assert len(ev_port) == 3


def test_nested_mutations_drain_at_final_epoch(tables):
    """``append_rows`` drives an internal ingest (one event) and an
    auto-compaction (its own); all deliver at the outermost publish with
    the final epoch."""
    port, ref = _pair(tables)
    ev_port, ev_ref = _events(port), _events(ref)
    t = port.tables["customer"]
    base = int(t["custkey"].max()) + 1
    rows = {k: t[k][:2].numpy().copy() for k in t.names()}
    rows["custkey"] = np.asarray([base, base + 1], np.int32)
    _both((port, ref), lambda e: e.append_rows("customer", rows,
                                                auto_compact=False))
    assert [e.kind for e in ev_port] == ["append_rows"]
    assert ev_port[0].epoch == port.epoch
    # an ingest the planner folds at once: both events
    # drain at the end, at the compaction's epoch
    ck = port.tables["customer"]["custkey"].numpy()
    keys = ck[:port.indexes["customer"].delta.num_slots].copy()
    pays = np.arange(keys.shape[0], dtype=np.int32)
    plans = [e.ingest("customer", keys, pays) for e in (port, ref)]
    assert plans[0].compact and plans[0].reason == plans[1].reason
    assert [e.kind for e in ev_port[1:]] == ["ingest", "compact"]
    assert {e.epoch for e in ev_port[1:]} == {port.epoch}
    _same_events(ev_port, ev_ref)


def test_failed_mutation_stages_no_phantom_event(tables):
    port, ref = _pair(tables)
    ev_port, ev_ref = _events(port), _events(ref)
    for eng in (port, ref):
        with pytest.raises(ValueError):
            eng.ingest("customer", np.asarray([1], np.int32),
                       np.asarray([0, 1], np.int32))  # length mismatch
    ck = tables["customer"]["custkey"].numpy()
    _both((port, ref), lambda e: e.ingest(
        "customer", ck[:1].copy(), np.asarray([0], np.int32),
        auto_compact=False))
    assert [e.kind for e in ev_port] == ["ingest"]
    _same_events(ev_port, ev_ref)


# ---------------------------------------------------------------------------
# the maintained suite: scripted differentials
# ---------------------------------------------------------------------------


def test_initial_build_matches_full_execution(tables):
    port, ref = _pair(tables)
    suite, jsuite = _suites(port, ref)
    _assert_suite_matches(port, suite, jsuite, "init")
    assert suite.stats == {"events": 0, "maintain_s": 0.0, "rebuilds": 0,
                           "invalidations": 0, "errors": 0,
                           "rows_touched": 0}


def test_requires_jspim_mode(tables):
    from repro_torch.core import ExecutionPolicy
    eng = SSBEngine(dict(tables), policy=ExecutionPolicy(mode="baseline"),
                    device="cpu")
    with pytest.raises(ValueError, match="jspim"):
        MaintainedSuite(eng)
    with pytest.raises(ValueError, match="unknown query"):
        MaintainedSuite(SSBEngine(dict(tables), device="cpu"), ["Q9.9"])


def test_fact_append_and_dim_mutations_stay_bit_identical(tables):
    port, ref = _pair(tables)
    suite, jsuite = _suites(port, ref)
    batch = generate_fact_batch(port.tables, 64, np.random.default_rng(3))
    _both((port, ref), lambda e: e.append_fact_rows(batch))
    _assert_suite_matches(port, suite, jsuite, "fact append")
    ck = tables["customer"]["custkey"].numpy()
    _both((port, ref), lambda e: e.ingest("customer", ck[:7].copy(),
                                          op="delete", auto_compact=False))
    _assert_suite_matches(port, suite, jsuite, "delete")
    _both((port, ref), lambda e: e.ingest(
        "customer", ck[:7].copy(), np.arange(7, dtype=np.int32),
        op="upsert", auto_compact=False))
    _assert_suite_matches(port, suite, jsuite, "re-insert")
    # out-of-range re-point: the maintained clip state must follow
    sk = tables["supplier"]["suppkey"].numpy()
    _both((port, ref), lambda e: e.ingest(
        "supplier", sk[:3].copy(), np.asarray([10 ** 6, 1, 0], np.int32),
        op="upsert", auto_compact=False))
    _assert_suite_matches(port, suite, jsuite, "over-range repoint")
    # dimension growth moves the clip target of over-range rows
    t = port.tables["supplier"]
    rows = {k: t[k][:2].numpy().copy() for k in t.names()}
    rows["suppkey"] = np.asarray([0, 1], np.int32) + int(t["suppkey"].max()) + 1
    _both((port, ref), lambda e: e.append_rows("supplier", rows,
                                                auto_compact=False))
    _assert_suite_matches(port, suite, jsuite, "dim growth")
    _both((port, ref), lambda e: e.compact("customer"))
    _both((port, ref), lambda e: e.compact("supplier"))
    _assert_suite_matches(port, suite, jsuite, "compact")
    assert suite.stats["rows_touched"] == jsuite.stats["rows_touched"]
    assert suite.stats["events"] == jsuite.stats["events"] == 7


def test_raw_update_invalidates_and_rebuild_recovers(tables):
    port, ref = _pair(tables)
    suite, jsuite = _suites(port, ref)
    pk0 = int(tables["part"]["partkey"][0])
    _both((port, ref), lambda e: e.index_update("part", pk0, 3))
    for s in (suite, jsuite):
        assert not s.valid and not s.fresh_at(port.epoch)
        assert s.stats["invalidations"] == 1
    # an invalidated suite ignores further events instead of diverging
    batch = generate_fact_batch(port.tables, 16, np.random.default_rng(1))
    _both((port, ref), lambda e: e.append_fact_rows(batch))
    assert not suite.valid
    suite.rebuild()
    jsuite.rebuild()
    _assert_suite_matches(port, suite, jsuite, "rebuild")
    assert suite.stats["rebuilds"] == 1
    # a fault inside the suite invalidates it and keeps the traceback; the
    # engine's mutation still publishes
    def boom(cols):
        raise RuntimeError("torn state")
    suite._on_append_fact = boom
    epoch = port.epoch
    port.append_fact_rows(generate_fact_batch(port.tables, 8,
                                              np.random.default_rng(6)))
    assert port.epoch == epoch + 1
    assert not suite.valid and suite.stats["errors"] == 1
    assert "torn state" in suite.last_error


# ---------------------------------------------------------------------------
# Z-set weight algebra: int32 weights, through zero, wraparound
# ---------------------------------------------------------------------------


def test_delete_heavy_stream_drives_weights_through_zero(tables):
    port, ref = _pair(tables)
    suite, jsuite = _suites(port, ref)
    view = suite.view("Q3.1")
    assert view.count > 0 and np.any(view.zset.weights != 0)
    before_w = view.zset.weights.copy()
    before_s = view.zset.sums.copy()
    # retract every customer: Q3.x / Q4.x lose every joined record
    ck = tables["customer"]["custkey"].numpy()
    for lo in range(0, ck.shape[0], 97):
        _both((port, ref), lambda e: e.ingest(
            "customer", ck[lo:lo + 97].copy(), op="delete",
            auto_compact=False))
    _assert_suite_matches(port, suite, jsuite, "all customers deleted")
    assert view.count == 0
    assert np.all(view.zset.weights == 0)      # weights through zero...
    assert np.all(view.zset.sums == 0)         # ...retraction is exact
    assert np.all(view.zset.weights_i32() == 0)
    assert suite.view("Q3.1").result()[0] == 0
    # re-inserting the identical mappings restores the exact state
    _both((port, ref), lambda e: e.ingest(
        "customer", ck.copy(), np.arange(ck.shape[0], dtype=np.int32),
        op="upsert", auto_compact=False))
    _assert_suite_matches(port, suite, jsuite, "all customers restored")
    assert np.array_equal(view.zset.weights, before_w)
    assert np.array_equal(view.zset.sums, before_s)
    jview = jsuite.view("Q3.1")
    assert np.array_equal(view.zset.weights, jview.zset.weights)
    assert view.count == jview.count


def test_wraparound_totals_match_engine_and_oracle(tables):
    """int32 per-element measures with int64 accumulation: totals driven
    far past int32 equal the engine's, the JAX suite's and the oracle's."""
    port, ref = _pair(tables)
    model = LogicalModel(port.tables)
    suite, jsuite = _suites(port, ref)
    rng = np.random.default_rng(5)
    for _ in range(3):
        cols = generate_fact_batch(port.tables, 256, rng)
        cols["revenue"] = np.full(256, 2_000_000_000, np.int32)
        cols["extendedprice"] = np.full(256, 2_000_000_000, np.int32)
        cols["supplycost"] = np.full(256, -2_000_000_000, np.int32)
        _both((port, ref), lambda e: e.append_fact_rows(cols))
        model.append_fact(cols)
    _assert_suite_matches(port, suite, jsuite, "wraparound")
    got = suite.results()
    wrapped = False
    for name in SSB_QUERIES:
        ot, og = model.query(name)
        mt, mg = got[name]
        assert ot == mt, name
        assert np.array_equal(og, mg), name
        view = suite.view(name)
        assert view.total == jsuite.view(name).total, name
        wrapped |= view.total != wrap_i32(view.total)
    assert wrapped  # the stream exceeded int32 somewhere


def test_wrap_i32_is_twos_complement():
    from repro.ivm import wrap_i32 as jax_wrap
    for x in (0, 2 ** 31 - 1, 2 ** 31, -2 ** 31 - 1, 5 * 2 ** 32 + 7, -7,
              2 ** 70 + 3, -2 ** 65):
        assert wrap_i32(x) == jax_wrap(x) == int(
            np.asarray(x % 2 ** 64, np.uint64).astype(np.int64)
            .astype(np.int32))
    assert wrap_i32(2 ** 31) == -2 ** 31
    assert wrap_i32(-2 ** 31 - 1) == 2 ** 31 - 1


# ---------------------------------------------------------------------------
# snapshot freeze: maintained answers stamped with their epoch
# ---------------------------------------------------------------------------


def test_snapshot_freezes_fresh_maintained_answers(tables):
    port, ref = _pair(tables)
    suite, jsuite = _suites(port, ref)
    batch = generate_fact_batch(port.tables, 32, np.random.default_rng(2))
    with port.snapshot() as snap, ref.snapshot() as jsnap:
        assert snap.maintained is not None
        frozen = {n: (t, g.copy()) for n, (t, g) in snap.maintained.items()}
        for n, (t, g) in jsnap.maintained.items():
            assert frozen[n][0] == t and np.array_equal(frozen[n][1], g)
        # the engine advances; the frozen answers must not move
        _both((port, ref), lambda e: e.append_fact_rows(batch))
        for name, (t, g) in snap.run_all().items():
            ft, fg = frozen[name]
            assert int(t) == ft and np.array_equal(g.numpy(), fg), name
            assert snap.maintained[name][0] == ft
    # a fresh snapshot freezes the suite's new answers
    with port.snapshot() as snap2:
        assert snap2.maintained is not None
        for name, (t, g) in snap2.run_all().items():
            mt, mg = snap2.maintained[name]
            assert int(t) == mt and np.array_equal(g.numpy(), mg), name
    snap2.release()
    assert snap2.maintained is None
    _assert_suite_matches(port, suite, jsuite, "after the snapshots")


def test_snapshot_skips_stale_or_invalid_suite(tables):
    port, ref = _pair(tables)
    suite, jsuite = _suites(port, ref)
    _both((port, ref), lambda e: e.index_update("date", 0, 0))
    assert not suite.valid and not jsuite.valid
    with port.snapshot() as snap:
        assert snap.maintained is None  # fallback: recompute
    suite.rebuild()
    jsuite.rebuild()
    with port.snapshot() as snap:
        assert snap.maintained is not None
        assert snap.maintained.keys() == jsuite.results().keys()


def test_detached_suite_contributes_nothing(tables):
    port, ref = _pair(tables)
    suite, jsuite = _suites(port, ref)
    suite.detach()
    jsuite.detach()
    batch = generate_fact_batch(port.tables, 16, np.random.default_rng(4))
    _both((port, ref), lambda e: e.append_fact_rows(batch))
    assert suite.epoch < port.epoch  # no longer receiving events
    assert (suite.epoch, suite.stats["events"]) == \
        (jsuite.epoch, jsuite.stats["events"])
    with port.snapshot() as snap:
        assert snap.maintained is None


# ---------------------------------------------------------------------------
# the differential harness: seeded mutation interleavings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [101, 202, 303])
def test_ivm_differential_random_interleavings(seed):
    """Seeded {append_fact_rows, ingest, delete, append_rows, compact}
    interleavings (the same draws in both packages), each episode with a
    snapshot check, bit-identical to full re-execution, to the JAX suite
    and to the JAX engine's own mutation stream."""
    tables = generate_ssb(SF, seed=seed, device="cpu")
    port, ref = _pair(tables, seed)
    suite, jsuite = _suites(port, ref)
    rngs = {"port": np.random.default_rng(seed),
            "jax": np.random.default_rng(seed)}
    kinds = set()
    for episode in range(10):
        n_ops = int(rngs["port"].integers(3, 7))
        assert n_ops == int(rngs["jax"].integers(3, 7))
        for _ in range(n_ops):
            kind, _ = random_mutation(port, rngs["port"], fact_batch=48)
            jkind, _ = jax_random_mutation(ref, rngs["jax"], fact_batch=48)
            assert kind == jkind
            kinds.add(kind)
            assert port.epoch == ref.epoch
        check = int(rngs["port"].integers(0, 2))
        assert check == int(rngs["jax"].integers(0, 2))
        if check:
            with port.snapshot() as snap:
                assert snap.maintained is not None, episode
                for name, (t, g) in snap.run_all().items():
                    mt, mg = snap.maintained[name]
                    assert int(t) == mt, (episode, name)
                    assert np.array_equal(g.numpy(), mg), (episode, name)
        _assert_suite_matches(port, suite, jsuite,
                              f"seed={seed} ep={episode}")
    assert kinds == {"append_fact_rows", "ingest", "append_rows", "compact"}
    assert suite.stats["errors"] == 0 and suite.stats["events"] > 0
    for k in ("events", "rows_touched", "invalidations"):
        assert suite.stats[k] == jsuite.stats[k], k
    assert dataclasses.asdict(port.policy)["fusion"] == "auto"
