"""The program's span recorder (``repro_torch.trace``) and its sites.

Off, it records nothing and costs a flag check; on, the serving tier's
and the engine's spans nest on their thread, carry their dispatch's batch
id, time a wait for the engine lock, and the engine counts the lazy probes
its snapshots make and the fact-side skew measurements it takes, each
measurement and re-plan a span of its own.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest

from repro_torch import trace
from repro_torch.engine import SSBEngine, generate_ssb
from repro_torch.engine.ssb import generate_fact_batch
from repro_torch.serving import QueryScheduler

SF = 0.002


@pytest.fixture(scope="module")
def tables():
    return generate_ssb(SF, seed=3, device="cpu")


@pytest.fixture
def engine(tables):
    eng = SSBEngine(dict(tables), device="cpu")
    eng.warm_cache()
    return eng


@pytest.fixture(autouse=True)
def recorder_off():
    trace.disable()
    yield
    trace.disable()


def _record(fn):
    trace.enable()
    try:
        fn()
    finally:
        spans = trace.disable()
    return spans


def _ancestors(span, by_id):
    out = []
    while span.parent is not None:
        span = by_id[span.parent]
        out.append(span)
    return out


def _new_customers(eng, n):
    t = eng.tables["customer"]
    rows = {c: t[c][:n].numpy().copy() for c in t.names()}
    top = int(t["custkey"].max())
    rows["custkey"] = np.arange(top + 1, top + 1 + n, dtype=np.int32)
    return rows


def test_off_records_nothing(engine):
    assert not trace.enabled()
    assert trace.span("serve.batch", batch=1) is trace.NO_SPAN
    assert trace.begin("serve.queue") is None
    lock = threading.RLock()
    assert trace.locked(lock, "snapshot") is lock
    sched = QueryScheduler(engine)
    try:
        ticket = sched.submit("Q2.1", (1, 2))
        sched.pump()
        engine.ingest("customer", engine.tables["customer"]["custkey"][:3]
                      .numpy(), op="delete")
    finally:
        sched.close()
    assert ticket.response.ok
    assert trace.current() is None
    assert trace.disable() == []


def test_a_dispatch_nests_and_carries_its_batch_id(engine):
    sched = QueryScheduler(engine)
    tickets = []

    def drive():
        for p in ((1, 2), (3, 4), (5, 6)):
            tickets.append(sched.submit("Q2.1", p))
        tickets.append(sched.submit("Q1.1"))
        sched.pump()

    try:
        spans = _record(drive)
    finally:
        sched.close()
    assert all(t.response.ok for t in tickets)
    by_id = {s.id: s for s in spans}
    batches = [s for s in spans if s.name == "serve.batch"]
    assert sorted((s.attrs["query"], s.attrs["width"]) for s in batches) \
        == [("Q1.1", 1), ("Q2.1", 3)]
    ids = {s.attrs["batch"] for s in batches}
    assert len(ids) == 2 and None not in ids
    for b in batches:
        assert b.parent is None
    inner = [s for s in spans if s.name.startswith(("batch.", "snapshot.",
                                                    "serve.refresh"))]
    assert {s.name for s in inner} >= {"serve.refresh", "batch.probes",
                                       "batch.tail", "batch.readback"}
    assert {s.attrs["flavor"] for s in inner
            if s.name == "batch.probes"} == {"batch"}
    for s in inner:
        top = _ancestors(s, by_id)[-1]
        assert top.name == "serve.batch"
        assert s.attrs["batch"] == top.attrs["batch"]
        assert top.start <= s.start <= s.end <= top.end
        assert s.thread == top.thread
    # one queue span per request, ended by the batch that took it
    queued = [s for s in spans if s.name == "serve.queue"]
    assert len(queued) == len(tickets)
    by_batch = {b.attrs["batch"]: b for b in batches}
    for q in queued:
        b = by_batch[q.attrs["batch"]]
        assert q.attrs["query"] == b.attrs["query"]
        assert q.start <= q.end <= b.start


def test_a_refresh_records_its_wait_for_the_engine_lock(engine):
    sched = QueryScheduler(engine)
    engine.ingest("customer", engine.tables["customer"]["custkey"][:3]
                  .numpy(), op="delete", auto_compact=False)
    held, released = threading.Event(), []

    def writer():
        with engine._mu:
            held.set()
            time.sleep(0.15)
            released.append(time.perf_counter())

    def drive():
        t = threading.Thread(target=writer)
        t.start()
        assert held.wait(10.0)
        sched.submit("Q3.1", (1, 2, 1993, 1996))
        sched.pump()
        t.join(10.0)
        assert not t.is_alive()

    try:
        spans = _record(drive)
        assert sched.stats["refreshes"] == 1
    finally:
        sched.close()
    by_id = {s.id: s for s in spans}
    waits = [s for s in spans if s.name == "engine.lock_wait"]
    assert len(waits) == 1
    w = waits[0]
    assert w.attrs["site"] == "snapshot"
    assert by_id[w.parent].name == "serve.refresh"
    assert by_id[w.parent].attrs["taken"] is True
    # the wait covers the writer's hold up to its release
    assert w.end >= released[0] and w.end - w.start >= 0.05
    # an acquisition that does not wait records nothing
    assert not [s for s in _record(lambda: engine.snapshot().release())
                if s.name == "engine.lock_wait"]


def test_snapshots_count_their_lazy_probes(engine):
    keys = engine.tables["customer"]["custkey"][:5].numpy()
    engine.ingest("customer", keys, op="delete", auto_compact=False)
    n0 = engine.snapshot_info()["snapshot_reprobes"]
    snap = engine.snapshot()

    def probe():
        snap.probe_dim("customer")   # dropped by the ingest: a lazy probe
        snap.probe_dim("customer")   # now the snapshot's own
        snap.probe_dim("date")       # frozen from the engine's cache

    spans = _record(probe)
    snap.release()
    assert engine.snapshot_info()["snapshot_reprobes"] == n0 + 1
    reprobes = [s for s in spans if s.name == "snapshot.reprobe"]
    assert [s.attrs["dim"] for s in reprobes] == ["customer"]
    # the live delta's overlay nests in it and takes its dimension
    overlays = [s for s in spans if s.name == "probe.overlay"]
    assert overlays and all(s.parent == reprobes[0].id
                            and s.attrs["dim"] == "customer"
                            for s in overlays)


def test_write_spans_name_the_outermost_call(engine):
    rows = _new_customers(engine, 4)
    keys = engine.tables["customer"]["custkey"][10:13].numpy()
    fact = generate_fact_batch(engine.tables, 64, np.random.default_rng(5))

    def writes():
        engine.append_rows("customer", rows)
        engine.ingest("customer", keys, op="delete", auto_compact=False)
        engine.compact("customer")
        engine.append_fact_rows(fact)

    spans = _record(writes)
    by_id = {s.id: s for s in spans}
    top = [(s.name, s.attrs.get("dim"), s.attrs.get("rows"),
            s.attrs.get("op")) for s in spans if s.parent is None]
    assert top == [("engine.append_rows", "customer", 4, None),
                   ("engine.ingest", "customer", 3, "delete"),
                   ("engine.compact", "customer", None, None),
                   ("engine.append_fact_rows", None, 64, None)]
    # append_rows' own ingest is inside its span, not a span of its own
    assert [s.name for s in spans].count("engine.ingest") == 1
    for s in spans:
        if s.name == "engine.compact":
            assert s.attrs["flavor"] in ("in_place", "swap")
            # an ingest's merge carries its plan's estimate, a direct
            # call's none
            if s.parent is None:
                assert "est_merge_s" not in s.attrs
            else:
                assert by_id[s.parent].name == "engine.append_rows"
                assert s.attrs["est_merge_s"] > 0
    extends = [s for s in spans if s.name == "engine.extend_probe"]
    assert sorted(s.attrs["dim"] for s in extends) == \
        sorted(engine.cache_info()["cached_dims"])
    assert all(s.attrs["decision"] for s in extends)
    assert all(by_id[s.parent].name == "engine.append_fact_rows"
               for s in extends)


def test_a_rejected_request_leaves_the_queue_untaken(engine):
    from repro_torch.serving import ServeConfig

    sched = QueryScheduler(engine, ServeConfig(max_queue=1))
    try:
        spans = _record(lambda: [sched.submit("Q1.1"), sched.submit("Q1.1"),
                                 sched.pump()])
    finally:
        sched.close()
    queued = sorted((s for s in spans if s.name == "serve.queue"),
                    key=lambda s: s.start)
    assert [s.attrs.get("outcome") for s in queued] == [None, "rejected"]
    assert queued[0].attrs["batch"] is not None
    assert "batch" not in queued[1].attrs


SKEW_DIMS = ["customer", "date", "part", "supplier"]


def _plan_key(p):
    return (p.schedule, p.hot_entries, p.hot_slots, p.cold_capacity,
            p.full_map)


def test_skew_measure_spans_at_build_and_on_a_forced_remeasure(tables):
    n = tables["lineorder"].n_rows
    eng = None

    def build():
        nonlocal eng
        eng = SSBEngine(dict(tables), device="cpu")

    spans = _record(build)
    measured = [s for s in spans if s.name == "engine.skew_measure"]
    assert sorted(s.attrs["dim"] for s in measured) == SKEW_DIMS
    for s in measured:
        st = eng.indexes[s.attrs["dim"]].stats.fact_skew
        assert (s.attrs["rows"], s.attrs["distinct"], s.attrs["max_share"]) \
            == (n, st.distinct, st.max_share) and s.parent is None
    info = eng.fact_append_info()
    assert (info["skew_measures"], info["skew_replans"]) == (4, 0)
    # the same rows measured again: four measurements, no drift, no re-plan
    spans = _record(lambda: eng._maybe_replan_fact_skew(force=True))
    assert sorted(s.attrs["dim"] for s in spans
                  if s.name == "engine.skew_measure") == SKEW_DIMS
    assert not [s for s in spans if s.name == "engine.skew_replan"]
    info = eng.fact_append_info()
    assert (info["skew_measures"], info["skew_replans"]) == (8, 0)
    # off, the counter still counts and nothing is recorded
    assert eng._maybe_replan_fact_skew(force=True) == []
    assert eng.fact_append_info()["skew_measures"] == 12
    assert trace.disable() == []
    # adopted indexes were measured where they were built
    assert SSBEngine(dict(tables), indexes=eng.indexes, device="cpu") \
        .fact_append_info()["skew_measures"] == 0


def test_skew_replans_move_with_a_replan_span(tables):
    """An append whose hot customer moves the top share past
    ``TOP_SHARE_DRIFT`` re-plans, and each re-plan is one
    ``engine.skew_replan`` span that says whether the decision changed.
    ``skew_replans`` counts the re-plans, as the JAX package's counter
    does, whether or not the decision changed."""
    from repro_torch.core import planner

    eng = SSBEngine(dict(tables), "jspim", "torch", "auto", device="cpu")
    eng.warm_cache()
    before = {d: _plan_key(p) for d, p in eng.plans.items()}
    n = int(tables["lineorder"].n_rows * planner.FACT_REMEASURE_FRAC) + 1
    rows = generate_fact_batch(eng.tables, n, np.random.default_rng(9))
    rows["custkey"][:] = int(eng.tables["customer"]["custkey"][7])
    report = {}
    spans = _record(lambda: report.update(eng.append_fact_rows(rows)))
    by_id = {s.id: s for s in spans}
    replans = [s for s in spans if s.name == "engine.skew_replan"]
    assert "customer" in report["skew_replanned"]
    assert sorted(s.attrs["dim"] for s in replans) == \
        sorted(report["skew_replanned"])
    assert eng.fact_append_info()["skew_replans"] == len(replans)
    for s in replans:
        d = s.attrs["dim"]
        after = _plan_key(eng.plans[d])
        assert (s.attrs["old"], s.attrs["new"]) == (before[d][0], after[0])
        assert s.attrs["changed"] == (after != before[d])
        assert by_id[s.parent].name == "engine.append_fact_rows"
    measured = [s for s in spans if s.name == "engine.skew_measure"]
    assert sorted(s.attrs["dim"] for s in measured) == SKEW_DIMS
    assert all(s.attrs["rows"] == tables["lineorder"].n_rows + n
               for s in measured)
    # a re-plan that kept its decision kept the old baseline too, so the
    # next measurement re-plans that dimension again, changing nothing
    kept = sorted(s.attrs["dim"] for s in replans if not s.attrs["changed"])
    assert kept == ["customer"]
    spans = _record(lambda: eng._maybe_replan_fact_skew(force=True))
    again = [s for s in spans if s.name == "engine.skew_replan"]
    assert [(s.attrs["dim"], s.attrs["changed"]) for s in again] == \
        [("customer", False)]
    # a stale decision changes: the plan takes the fresh curve, and the
    # next measurement finds no drift
    eng.plans["customer"] = dataclasses.replace(eng.plans["customer"],
                                                schedule="deduped")
    spans = _record(lambda: eng._maybe_replan_fact_skew(force=True))
    changed = [s for s in spans if s.name == "engine.skew_replan"]
    assert [(s.attrs["dim"], s.attrs["old"], s.attrs["new"],
             s.attrs["changed"]) for s in changed] == \
        [("customer", "deduped", "gathered", True)]
    assert eng._maybe_replan_fact_skew(force=True) == []
    info = eng.fact_append_info()
    assert (info["skew_measures"], info["skew_replans"]) == \
        (20, len(replans) + 2)
