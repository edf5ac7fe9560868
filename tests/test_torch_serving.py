"""The port's serving tier against the JAX package's, on the CPU.

Everything here is deterministic: the scheduler is driven by ``pump()`` on
the test thread, with a fake clock where deadlines matter (the threaded
and randomized evidence is ``test_torch_serving_chaos.py``).  Covered:

* parameterized queries: the registry and its draws equal the JAX
  package's; binding the defaults reproduces the canonical queries; the
  "batch", "mega" and "composed" flavors, the host oracle and the JAX
  package's ``BatchRunner`` give the same answers on the same parameters,
  with and without live deltas, and whatever the batch is split into;
* admission with ``retry_after_s`` equal to the JAX scheduler's, closing,
  deadlines at queue exit and at the batch boundary;
* ``plan_batch`` and ``batch_serve_seconds`` equal to the JAX package's,
  and the scheduler pricing on the ``"cpu"`` entry whatever the device;
* a worker crash retried on a fresh worker, the retry budget, the circuit
  breaker's ladder, the worker pool;
* a failed snapshot refresh served stale with its lag;
* background compaction off the serving path, and the publish conflict;
* the kernel wrappers launching on the operands' own device's stream.
"""
import dataclasses
import importlib
import inspect
import os
import time

import numpy as np
import pytest
import torch

from repro.core import costmodel as jcostmodel
from repro.core import planner as jplanner
from repro.engine import SSBEngine as JaxEngine
from repro.engine import generate_ssb as jax_generate_ssb
from repro.serving import PARAM_QUERIES as JAX_PARAM_QUERIES
from repro.serving import BatchRunner as JaxBatchRunner
from repro.serving import LogicalModel as JaxLogicalModel
from repro.serving import QueryScheduler as JaxScheduler
from repro.serving import ServeConfig as JaxServeConfig
from repro_torch.core import ExecutionPolicy, costmodel, planner
from repro_torch.durability import FaultRegistry
from repro_torch.engine import SSB_QUERIES, SSBEngine, generate_ssb
from repro_torch.kernels import bucket_probe, coalesce_window
from repro_torch.serving import (PARAM_QUERIES, BatchRunner, LogicalModel,
                                 QueryScheduler, ServeConfig, WorkerCrash,
                                 WorkerPool)
from repro_torch.serving import batch as pbatch
from repro_torch.serving import scheduler as pscheduler

# the package exports the function ``fused_query`` under the module's name
fused_query = importlib.import_module("repro_torch.kernels.fused_query")
SF = 0.002
NAMES = sorted(SSB_QUERIES)
FLAVORS = ("batch", "mega", "composed")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread_when_parallel():
    """In a parallel run (pytest-xdist workers share the cores) this
    module's torch ops take one thread each."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        yield
        return
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tables():
    return generate_ssb(SF, seed=11, device="cpu")


@pytest.fixture(scope="module")
def engine(tables):
    eng = SSBEngine(dict(tables), device="cpu")
    eng.warm_cache()
    return eng


@pytest.fixture(scope="module")
def model(tables):
    return LogicalModel(tables)


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _check(resp, model):
    t, g = model.param_query(resp.name, resp.params)
    assert resp.total == t, (resp.name, resp.params)
    np.testing.assert_array_equal(resp.groups, g,
                                  err_msg=f"{resp.name}{resp.params}")


def _raise(msg):
    def hook(site):
        raise RuntimeError(msg)
    return hook


# ---------------------------------------------------------------------------
# parameterized queries and batched execution
# ---------------------------------------------------------------------------


def test_param_registry_matches_jax():
    assert sorted(PARAM_QUERIES) == sorted(JAX_PARAM_QUERIES) == NAMES
    for name, pq in PARAM_QUERIES.items():
        jpq = JAX_PARAM_QUERIES[name]
        assert (pq.params, pq.defaults) == (jpq.params, jpq.defaults)
        assert pq.bind(pq.defaults).joined_dims() == \
            SSB_QUERIES[name].joined_dims()
        assert sorted(pq.dim_filters) == sorted(jpq.dim_filters)
        assert (pq.fact_filter is None) == (jpq.fact_filter is None)


def test_samples_are_the_jax_draws():
    rng, jrng = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):
        for name in NAMES:
            assert PARAM_QUERIES[name].sample(rng) == \
                JAX_PARAM_QUERIES[name].sample(jrng)


def test_defaults_reproduce_canonical_results(engine):
    """Binding the defaults is bit-identical to the constant-predicate
    queries, on every flavor."""
    br = BatchRunner()
    for name in NAMES:
        ref_t, ref_g = engine.run(name)
        for flavor in FLAVORS:
            [(t, g)] = br.run_batch(engine, name,
                                    [PARAM_QUERIES[name].defaults],
                                    flavor=flavor)
            assert t == int(ref_t), (name, flavor)
            np.testing.assert_array_equal(g, ref_g.numpy(),
                                          err_msg=f"{name} {flavor}")


@pytest.mark.parametrize("seed", [7, 8])
def test_flavors_equal_each_other_and_the_oracle(engine, model, seed):
    rng = np.random.default_rng(seed)
    for name in NAMES:
        pq = PARAM_QUERIES[name]
        ps = [pq.sample(rng) for _ in range(5)]
        outs = {f: BatchRunner().run_batch(engine, name, ps, flavor=f)
                for f in FLAVORS}
        for i, p in enumerate(ps):
            ot, og = model.param_query(name, p)
            for f in FLAVORS:
                assert outs[f][i][0] == ot, (name, p, f)
                np.testing.assert_array_equal(outs[f][i][1], og,
                                              err_msg=f"{name}{p} {f}")


def test_flavors_equal_the_jax_batch_runner_and_oracle(tables):
    """The port's three flavors, the JAX package's batched flavor and its
    numpy oracle on the same parameters, over live deltas on two
    dimensions (the mega flavor's lookups overlay them)."""
    jtables = jax_generate_ssb(sf=SF, seed=11)
    port = SSBEngine(dict(tables), device="cpu")
    jax_eng = JaxEngine(dict(jtables), mode="jspim")
    rng = np.random.default_rng(3)
    doomed = {d: rng.choice(np.asarray(tables[d][k]), 7, replace=False)
              for d, k in (("customer", "custkey"), ("supplier", "suppkey"))}
    for e in (port, jax_eng):
        for d, keys in doomed.items():
            e.ingest(d, keys, op="delete", auto_compact=False)
    model = JaxLogicalModel(jtables)
    for d, keys in doomed.items():
        model.delete_keys(d, keys)
    pmodel = LogicalModel(tables)
    for d, keys in doomed.items():
        pmodel.delete_keys(d, keys)
    jbr, pbr = JaxBatchRunner(), BatchRunner()
    for name in ("Q1.1", "Q2.1", "Q3.2", "Q4.3"):
        pq = PARAM_QUERIES[name]
        ps = [pq.sample(rng) for _ in range(4)]
        want = jbr.run_batch(jax_eng, name, ps)
        for f in FLAVORS:
            got = pbr.run_batch(port, name, ps, flavor=f)
            for p, (t, g), (wt, wg) in zip(ps, got, want):
                assert t == wt, (name, p, f)
                np.testing.assert_array_equal(g, np.asarray(wg))
        for p, (wt, wg) in zip(ps, want):
            for m in (model, pmodel):
                ot, og = m.param_query(name, p)
                assert wt == ot
                np.testing.assert_array_equal(np.asarray(wg), og)


def test_batch_split_into_groups_gives_the_same_answers(engine,
                                                        monkeypatch):
    """A batch wider than the working-memory bound runs group by group
    with the same answers."""
    rng = np.random.default_rng(9)
    n = engine.tables["lineorder"].n_physical
    for name in ("Q1.2", "Q3.3", "Q4.1"):
        ps = [PARAM_QUERIES[name].sample(rng) for _ in range(7)]
        whole = BatchRunner().run_batch(engine, name, ps, flavor="batch")
        monkeypatch.setattr(pbatch, "MAX_BATCH_CELLS", 3 * n)
        split = BatchRunner().run_batch(engine, name, ps, flavor="batch")
        monkeypatch.undo()
        for (t1, g1), (t2, g2) in zip(whole, split):
            assert t1 == t2
            np.testing.assert_array_equal(g1, g2)


def test_batch_rejects_wrong_arity_and_flavor(engine):
    with pytest.raises(ValueError, match="params"):
        BatchRunner().run_batch(engine, "Q1.1", [(1993, 1)])
    with pytest.raises(ValueError, match="flavor"):
        BatchRunner().run_batch(engine, "Q1.1", [(1993, 1, 3, 25)],
                                flavor="vmap")
    assert BatchRunner().run_batch(engine, "Q1.1", []) == []


def test_policy_picks_the_flavor(tables):
    runner = BatchRunner(ExecutionPolicy(fusion="mega"))
    eng = SSBEngine(dict(tables), device="cpu")
    assert runner._resolve_flavor(eng, None, False) == "mega"
    assert runner._resolve_flavor(eng, None, True) == "composed"
    assert BatchRunner()._resolve_flavor(eng, None, False) == "batch"
    base = SSBEngine(dict(tables), mode="baseline", device="cpu")
    assert runner._resolve_flavor(base, "mega", False) == "batch"


def test_faults_fire_before_anything_launches(engine, monkeypatch):
    """The fault site fires once per batched dispatch (once per request on
    the composed flavor), before any probe."""
    faults = FaultRegistry()
    calls = []
    monkeypatch.setattr(pbatch.BatchRunner, "_probes", staticmethod(
        lambda *a: calls.append(a) or (_ for _ in ()).throw(AssertionError)))
    faults.on("kernel_", _raise("poisoned"))
    p = PARAM_QUERIES["Q2.1"].defaults
    for f in FLAVORS:
        with pytest.raises(RuntimeError, match="poisoned"):
            BatchRunner().run_batch(engine, "Q2.1", [p, p], flavor=f,
                                    faults=faults)
    assert calls == []
    assert faults.hits == {"kernel_batch:Q2.1": 1, "kernel_mega:Q2.1": 1,
                           "kernel_composed:Q2.1": 1}


# ---------------------------------------------------------------------------
# admission control and deadlines
# ---------------------------------------------------------------------------


def test_admission_sheds_overflow_as_jax_does(engine, model):
    """4 admitted, 6 rejected at the door with the JAX scheduler's
    ``retry_after_s``; what is admitted is served exactly."""
    jax_eng = JaxEngine(dict(jax_generate_ssb(sf=SF, seed=11)),
                        mode="jspim")
    clock, jclock = _FakeClock(), _FakeClock()
    sched = QueryScheduler(engine, ServeConfig(max_queue=4, max_batch=4,
                                               clock=clock))
    jsched = JaxScheduler(jax_eng, JaxServeConfig(max_queue=4, max_batch=4,
                                                  clock=jclock))
    try:
        tickets = [sched.submit("Q1.1", deadline_s=3.0 if i == 2 else None)
                   for i in range(10)]
        jtickets = [jsched.submit("Q1.1",
                                  deadline_s=3.0 if i == 2 else None)
                    for i in range(10)]
        shed = [t for t in tickets if t.done]
        assert len(shed) == 6
        for t, jt in zip(tickets, jtickets):
            assert t.done == jt.done
            if t.done:
                r = t.response
                assert r.status == "rejected" and r.reason == "queue full"
                assert r.retry_after_s == jt.response.retry_after_s >= 3.0
        assert sched.info()["queue_depth"] == 4
        sched.pump()
        for t in tickets:
            if t.response.status == "ok":
                _check(t.response, model)
        assert sched.info()["completed"] == 4
    finally:
        sched.close()
        jsched.close()


def test_retry_after_clamped_to_tightest_admitted_slack(engine):
    clock = _FakeClock()
    sched = QueryScheduler(engine, ServeConfig(max_queue=2, clock=clock))
    try:
        sched.submit("Q1.1", deadline_s=7.0)
        sched.submit("Q1.1", deadline_s=12.0)
        t = sched.submit("Q1.1")
        assert t.response.status == "rejected"
        assert t.response.retry_after_s >= 7.0
        sched.pump()
        sched.submit("Q2.1")
        sched.submit("Q2.1")
        t2 = sched.submit("Q2.1")
        assert t2.response.status == "rejected"
        assert t2.response.retry_after_s >= 0.0
    finally:
        sched.close()


def test_close_rejects_residue_and_refuses_new(engine):
    sched = QueryScheduler(engine, ServeConfig())
    t = sched.submit("Q1.1")
    live = engine.snapshot_info()["live_snapshots"]
    sched.close()
    assert t.response.status == "rejected" and "closed" in t.response.reason
    assert sched.submit("Q1.1").response.status == "rejected"
    assert engine.snapshot_info()["live_snapshots"] == live - 1
    with pytest.raises(KeyError):
        sched.submit("Q9.9")
    with pytest.raises(ValueError, match="params"):
        sched.submit("Q1.1", (1,))


def test_deadline_expires_in_queue(engine):
    clock = _FakeClock()
    sched = QueryScheduler(engine, ServeConfig(clock=clock))
    try:
        t = sched.submit("Q1.1", deadline_s=1.0)
        clock.t = 2.0
        sched.pump()
        assert t.response.status == "timed_out"
        assert "queue" in t.response.reason
    finally:
        sched.close()


def test_deadline_survivors_still_serve(engine, model):
    clock = _FakeClock()
    sched = QueryScheduler(engine, ServeConfig(clock=clock))
    try:
        doomed = sched.submit("Q1.1", deadline_s=1.0)
        alive = sched.submit("Q1.1", deadline_s=100.0)
        clock.t = 2.0
        sched.pump()
        assert doomed.response.status == "timed_out"
        assert alive.response.status == "ok"
        _check(alive.response, model)
    finally:
        sched.close()


def test_deadline_rechecked_at_the_batch_boundary(engine, monkeypatch):
    """A request whose deadline passes between batch formation and
    execution times out at the boundary, never mid-dispatch."""
    clock = _FakeClock()
    sched = QueryScheduler(engine, ServeConfig(clock=clock))
    try:
        t = sched.submit("Q2.1", deadline_s=1.0)
        batch = sched._next_batch()
        clock.t = 5.0
        sched._execute(batch)
        assert t.response.status == "timed_out"
        assert "batch boundary" in t.response.reason
        assert sched.info()["batches"] == 0
    finally:
        sched.close()


# ---------------------------------------------------------------------------
# pricing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth,slack,n_rows,max_batch", [
    (16, None, 1_000_000, 16), (16, 1e-12, 1_000_000, 16),
    (16, 0.4, 1_000_000, 16), (3, 0.05, 60_000_000, 16),
    (40, 2.0, 12_000, 8), (1, None, 0, 4), (9, 0.9, 60_000_000, 16)])
def test_plan_batch_matches_jax(depth, slack, n_rows, max_batch):
    kw = dict(queue_depth=depth, slack_s=slack, n_rows=n_rows,
              max_batch=max_batch)
    assert dataclasses.asdict(planner.plan_batch(**kw)) == \
        dataclasses.asdict(jplanner.plan_batch(**kw))
    assert planner.BATCH_SLACK_FACTOR == jplanner.BATCH_SLACK_FACTOR


def test_plan_batch_halves_under_tight_deadline():
    n_rows = 1_000_000
    wide = planner.plan_batch(queue_depth=16, slack_s=None, n_rows=n_rows,
                              max_batch=16)
    assert wide.size == 16 and wide.reason == "depth"
    single = costmodel.batch_serve_seconds(1, n_rows)
    tight = planner.plan_batch(queue_depth=16, slack_s=single * 4,
                               n_rows=n_rows, max_batch=16)
    assert tight.size < 16 and tight.reason == "deadline"
    assert tight.est_batch_s * 2.0 <= single * 4
    assert planner.plan_batch(queue_depth=16, slack_s=1e-12, n_rows=n_rows,
                              max_batch=16).size == 1


def test_batch_serve_seconds_matches_jax():
    assert (costmodel.SERVE_PASSES_PER_REQUEST,
            costmodel.SERVE_OPS_PER_DISPATCH) == \
        (jcostmodel.SERVE_PASSES_PER_REQUEST,
         jcostmodel.SERVE_OPS_PER_DISPATCH)
    for b, n in ((1, 10_000), (8, 10_000), (1, 80_000), (16, 60_000_000),
                 (0, 0)):
        assert costmodel.batch_serve_seconds(b, n) == \
            jcostmodel.batch_serve_seconds(b, n)
    one = costmodel.batch_serve_seconds(1, 10_000)
    assert costmodel.batch_serve_seconds(8, 10_000) < 8 * one
    with pytest.raises(NotImplementedError, match="planner slice"):
        costmodel.batch_serve_seconds(1, 10, backend="cuda")
    with pytest.raises(NotImplementedError):
        planner.plan_batch(queue_depth=1, slack_s=None, n_rows=1,
                           max_batch=1, backend="cuda")


def test_scheduler_prices_on_the_cpu_entry(engine, monkeypatch):
    """Both pricing sites pass ``backend="cpu"``, whatever the engine's
    device: no call reaches the card's missing cost entry."""
    seen = []
    real_serve = costmodel.batch_serve_seconds
    real_plan = pscheduler.plan_batch

    def serve(*a, backend, **k):
        seen.append(("serve", backend))
        return real_serve(*a, backend=backend, **k)

    def plan(**k):
        seen.append(("plan", k["backend"]))
        return real_plan(**k)

    monkeypatch.setattr(pscheduler.costmodel, "batch_serve_seconds", serve)
    monkeypatch.setattr(pscheduler, "plan_batch", plan)
    sched = QueryScheduler(engine, ServeConfig(max_queue=1))
    try:
        sched.submit("Q1.1")
        sched.submit("Q1.1")  # rejected: prices retry_after_s
        sched.pump()
    finally:
        sched.close()
    assert ("serve", "cpu") in seen and ("plan", "cpu") in seen
    assert {b for _, b in seen} == {"cpu"}


# ---------------------------------------------------------------------------
# fault isolation, retries, the circuit breaker
# ---------------------------------------------------------------------------


def test_worker_crash_is_isolated_and_batch_retries(engine, model):
    faults = FaultRegistry()
    sched = QueryScheduler(engine, ServeConfig(max_batch=4, backoff_s=0.0),
                           faults=faults)
    try:
        faults.crash_on("worker:", nth=1)
        tickets = [sched.submit("Q3.2") for _ in range(3)]
        sched.pump()
        for t in tickets:
            assert t.response.status == "ok" and t.response.retries == 1
            _check(t.response, model)
        assert sched.pool.deaths == 1
        assert sched.pool.width == sched.config.n_workers
    finally:
        sched.close()


def test_batch_fails_explicitly_after_retry_budget(engine):
    faults = FaultRegistry()
    faults.on("worker:", _raise("wedged executor"))
    sched = QueryScheduler(engine, ServeConfig(max_retries=2,
                                               backoff_s=0.0),
                           faults=faults)
    try:
        t = sched.submit("Q1.2")
        sched.pump()
        assert t.response.status == "failed"
        assert "3 attempts" in t.response.reason
        assert sched.info()["failed"] == 1
    finally:
        sched.close()


@pytest.mark.parametrize("fusion", ["composed", "mega"])
def test_breaker_degrades_to_composed_then_heals(tables, model, fusion):
    """Persistent faults in the engine policy's flavor trip the breaker:
    composed serves (degraded, still exact), then half-open, then heal."""
    eng = SSBEngine(dict(tables), device="cpu",
                    policy=ExecutionPolicy(fusion=fusion))
    faults = FaultRegistry()
    sched = QueryScheduler(
        eng, ServeConfig(breaker_threshold=3, breaker_cooldown=2,
                         max_retries=2, backoff_s=0.0), faults=faults)
    site = "kernel_mega:Q4.1" if fusion == "mega" else "kernel_batch:Q4.1"
    try:
        faults.on(site, _raise("poisoned kernel"))
        first = sched.submit("Q4.1")
        sched.pump()
        assert first.response.status == "failed"
        assert sched.info()["breakers_open"] == ["Q4.1"]
        for _ in range(2):
            t = sched.submit("Q4.1")
            sched.pump()
            assert t.response.status == "ok" and t.response.degraded
            _check(t.response, model)
        faults.clear()
        t = sched.submit("Q4.1")
        sched.pump()
        assert t.response.status == "ok" and not t.response.degraded
        _check(t.response, model)
        info = sched.info()
        assert info["breakers_open"] == [] and info["breaker_trips"] == 1
        assert info["composed_batches"] == 2
    finally:
        sched.close()


def test_worker_pool_checkout_timeout_and_renewal():
    pool = WorkerPool(1)
    w = pool.checkout()
    assert pool.checkout(timeout=0.01) is None
    with pytest.raises(WorkerCrash):
        w.run(lambda: (_ for _ in ()).throw(ValueError("boom")))
    assert not w.alive
    with pytest.raises(WorkerCrash, match="dead"):
        w.run(lambda: 1)
    pool.checkin(w)
    w2 = pool.checkout()
    assert w2.alive and w2.wid != w.wid
    pool.checkin(w2)
    assert pool.deaths == 1
    with pytest.raises(ValueError):
        WorkerPool(0)


# ---------------------------------------------------------------------------
# degraded staleness, rebind
# ---------------------------------------------------------------------------


def test_refresh_failure_serves_stale_with_lag():
    tables = generate_ssb(0.001, seed=2, device="cpu")
    eng = SSBEngine(dict(tables), device="cpu")
    model = LogicalModel(tables)
    faults = FaultRegistry()
    sched = QueryScheduler(eng, ServeConfig(), faults=faults)
    try:
        faults.on("snapshot_refresh", _raise("refresh blocked"))
        pinned = sched.info()["pinned_epoch"]
        eng.ingest("supplier", np.array([10_000_001], np.int32),
                   np.array([0], np.int32))
        assert eng.epoch > pinned
        t = sched.submit("Q1.1")
        sched.pump()
        r = t.response
        assert r.status == "ok" and r.stale and r.degraded
        assert r.epoch == pinned and r.epoch_lag == eng.epoch - pinned
        _check(r, model)   # exact at the reported (pre-ingest) epoch
        assert sched.info()["refresh_failures"] > 0
        faults.clear()
        t2 = sched.submit("Q1.1")
        sched.pump()
        assert t2.response.epoch == eng.epoch and not t2.response.stale
    finally:
        sched.close()


def test_rebind_serves_the_new_engine(tables, model):
    eng = SSBEngine(dict(tables), device="cpu")
    sched = QueryScheduler(eng, ServeConfig())
    try:
        other = SSBEngine(dict(tables), device="cpu",
                          policy=ExecutionPolicy(fusion="mega"))
        other.ingest("part", np.array([9_900_001], np.int32),
                     np.array([0], np.int32), auto_compact=False)
        sched.rebind(other)
        assert sched.runner.policy.fusion == "mega"
        assert eng.snapshot_info()["live_snapshots"] == 0
        t = sched.submit("Q2.1")
        sched.pump()
        assert t.response.epoch == other.epoch == 1
        _check(t.response, model)  # the new key joins no fact row
    finally:
        sched.close()


# ---------------------------------------------------------------------------
# background compaction off the serving path
# ---------------------------------------------------------------------------


def _grow_delta(eng, dim="supplier", n=64, base=20_000_000):
    keys = np.arange(base, base + n, dtype=np.int32)
    eng.ingest(dim, keys, np.zeros(n, np.int32), auto_compact=False)


def test_background_compaction_never_blocks_queries(tables, model):
    """A slow merge (0.4 s injected in ``compact_prepare``) does not stall
    serving: queries pumped meanwhile complete before it publishes."""
    eng = SSBEngine(dict(tables), device="cpu")
    faults = FaultRegistry()
    sched = QueryScheduler(eng, ServeConfig(), faults=faults)
    try:
        _grow_delta(eng)
        delta0 = eng.indexes["supplier"].delta
        faults.delay_on("compact_prepare:supplier", 0.4)
        bg = sched.compact_in_background("supplier")
        served = 0
        t0 = time.monotonic()
        while time.monotonic() - t0 < 0.3:   # inside the merge window
            tk = sched.submit("Q2.1")
            sched.pump()
            assert tk.response.status == "ok"
            served += 1
        bg.join(timeout=30.0)
        assert not bg.is_alive()
        assert served >= 3, "queries stalled behind the merge"
        assert sched.info()["bg_compactions"] == 1
        assert eng.indexes["supplier"].delta is None is not delta0
        tk = sched.submit("Q2.1")
        sched.pump()
        assert tk.response.status == "ok" and tk.response.epoch == eng.epoch
        _check(tk.response, model)
    finally:
        sched.close()


def test_publish_compact_conflict_is_detected(tables):
    eng = SSBEngine(dict(tables), device="cpu")
    _grow_delta(eng, base=21_000_000)
    epoch = eng.epoch
    prepared = eng.prepare_compact("supplier")
    assert prepared is not None and eng.epoch == epoch
    eng.compact("supplier")            # someone else folds first
    assert eng.publish_compact(prepared) is False
    assert eng.epoch == epoch + 1
    assert eng.prepare_compact("supplier") is None   # nothing left to fold
    assert eng.publish_compact(None) is False
    with pytest.raises(ValueError, match="dimension"):
        eng.prepare_compact("nation")
    _grow_delta(eng, base=21_100_000)
    prepared = eng.prepare_compact("supplier")
    _grow_delta(eng, base=21_200_000)  # a newer op lands before the publish
    assert eng.publish_compact(prepared) is False
    assert eng.indexes["supplier"].delta is not None
    assert eng.publish_compact(eng.prepare_compact("supplier")) is True
    assert eng.indexes["supplier"].delta is None


def test_background_compaction_restages_on_conflict(tables):
    eng = SSBEngine(dict(tables), device="cpu")
    faults = FaultRegistry()
    sched = QueryScheduler(eng, ServeConfig(), faults=faults)
    try:
        _grow_delta(eng, base=22_000_000)
        fired = []

        def steal(site):
            if not fired:
                fired.append(site)
                eng.compact("supplier")

        faults.on("compact_publish:supplier", steal)
        bg = sched.compact_in_background("supplier")
        bg.join(timeout=30.0)
        assert not bg.is_alive()
        assert sched.info()["bg_compact_conflicts"] == 1
        assert sched.info()["bg_compactions"] == 0
    finally:
        sched.close()


# ---------------------------------------------------------------------------
# kernel wrappers launch on the operands' own device's stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", [
    bucket_probe.pack_bits, bucket_probe.probe_rows,
    bucket_probe.bucket_probe_stream, bucket_probe.probe_filter_rows,
    bucket_probe.probe_filter_rows_delta, fused_query.pack_query_bits,
    fused_query.fused_query, coalesce_window.coalesce_window_mask],
    ids=lambda f: f.__name__)
def test_wrappers_take_the_operand_device_stream(fn):
    """Serving threads launch kernels too: each wrapper takes the stream of
    its operands' device, never the calling thread's current device."""
    src = inspect.getsource(fn)
    calls = [line for line in src.splitlines()
             if "_stream(" in line or "current_stream(" in line]
    assert calls, fn.__name__
    for line in calls:
        assert "_stream()" not in line and "current_stream()" not in line, \
            line
    stream_src = inspect.getsource(bucket_probe._stream)
    assert "current_stream(device)" in stream_src
