"""Chaos harness for the port's serving tier: degraded or rejected, never
wrong.

The JAX package's chaos suite on the port's engine (CPU): randomized
timelines of {submit, pump, ingest, append, delete, compact, fault-arm,
fault-clear} with faults injected at every serving site (worker crashes
mid-batch, poisoned batched kernels, slow-worker stragglers,
snapshot-refresh failures, background-compaction races), an ingest
thread killed mid-stream, and crash recovery (``SSBEngine.open``) running
beside a scheduler that keeps serving the dead incarnation's snapshot
until it is rebound to the recovered engine.

The single gate every scenario ends with: each **completed** response is
bit-identical to the single-threaded numpy oracle frozen at the epoch
the response *reports* (stale is fine, wrong is not); everything else is
an *explicit* rejection / timeout / failure — no silent drops, no
unbounded queues, no response from a half-applied epoch.
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import ExecutionPolicy
from repro_torch.durability import FaultRegistry
from repro_torch.engine import SSBEngine, generate_ssb
from repro_torch.engine.queries import DIM_PK
from repro_torch.serving import (PARAM_QUERIES, LogicalModel, QueryScheduler,
                                 ServeConfig)

QUERY_POOL = ("Q1.1", "Q1.3", "Q2.1", "Q2.2", "Q3.2", "Q3.3", "Q4.2",
              "Q4.3")


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
    return generate_ssb(0.001, seed=13, device="cpu")


def _engine(tables, fusion="composed"):
    """A CPU engine; its fusion policy picks the serving flavor ("batch"
    for composed, "mega" for mega)."""
    return SSBEngine(dict(tables), device="cpu",
                     policy=ExecutionPolicy(fusion=fusion))


# ---------------------------------------------------------------------------
# mirror: engine + logical model in lockstep, oracle frozen per epoch
# ---------------------------------------------------------------------------


class ChaosMirror:
    """Mirrors every engine mutation into the numpy model and freezes
    one oracle per published epoch (auto-compaction may publish several
    epochs per mutation — compaction is result-invisible, so the extra
    epochs freeze the same logical state)."""

    def __init__(self, tables, eng):
        self.eng = eng
        self.model = LogicalModel(tables)
        self.frozen = {eng.epoch: self.model.freeze()}
        self._recorded = eng.epoch
        self.next_fact_key = 60_000_000
        self.next_dim_key = {d: 30_000_000 + i * 1_000_000
                             for i, d in enumerate(DIM_PK)}

    def _record(self):
        while self._recorded < self.eng.epoch:
            self._recorded += 1
            self.frozen[self._recorded] = self.model.freeze()

    def append_fact(self, rng, n):
        src = rng.integers(0, self.model.fact["orderkey"].shape[0], n)
        cols = {k: v[src].copy() for k, v in self.model.fact.items()}
        cols["orderkey"] = np.arange(self.next_fact_key,
                                     self.next_fact_key + n,
                                     dtype=np.int32)
        self.next_fact_key += n
        self.eng.append_fact_rows(cols)
        self.model.append_fact(cols)
        self._record()

    def append_dim(self, rng, d, n):
        k0 = self.next_dim_key[d]
        self.next_dim_key[d] += n
        cols = {c: rng.integers(0, 5, n).astype(np.int32)
                for c in self.model.dims[d] if c != DIM_PK[d]}
        cols[DIM_PK[d]] = np.arange(k0, k0 + n, dtype=np.int32)
        self.eng.append_rows(d, cols)
        self.model.append_dim(d, cols)
        self._record()

    def delete_dim(self, rng, d, n):
        pk = self.model.dims[d][DIM_PK[d]]
        alive = np.asarray([k for k in pk
                            if int(k) not in self.model.deleted[d]],
                           np.int32)
        if alive.size < 2 * n:
            return
        doomed = rng.choice(alive, n, replace=False)
        self.eng.ingest(d, doomed, op="delete", auto_compact=False)
        self.model.delete_keys(d, doomed)
        self._record()

    def compact(self, d):
        self.eng.compact(d)
        self._record()

    def verify(self, resp) -> bool:
        """True iff an ok response matches the oracle at its epoch."""
        oracle = self.frozen[resp.epoch]
        t, g = oracle.param_query(resp.name, resp.params)
        return resp.total == t and np.array_equal(resp.groups, g)


def _verify_all(mirror, tickets, *, allow=("rejected", "timed_out",
                                           "failed")):
    """The never-wrong gate over a finished trial's tickets."""
    counts = {"ok": 0}
    for t in tickets:
        r = t.response
        assert r is not None, "ticket never resolved"
        if r.status == "ok":
            assert mirror.verify(r), \
                f"WRONG response: {r.name}{r.params} at epoch {r.epoch}"
            counts["ok"] += 1
        else:
            assert r.status in allow, r.status
            counts[r.status] = counts.get(r.status, 0) + 1
    return counts


# ---------------------------------------------------------------------------
# randomized chaos trials (deterministic pump-mode: the oracle gate)
# ---------------------------------------------------------------------------


def _chaos_trial(tables, seed: int, fusion: str) -> dict:
    rng = np.random.default_rng(seed)
    eng = _engine(tables, fusion)
    flavor = "mega" if fusion == "mega" else "batch"
    faults = FaultRegistry()
    cfg = ServeConfig(max_queue=12, max_batch=4, n_workers=2,
                      max_retries=2, backoff_s=0.0,
                      breaker_threshold=2, breaker_cooldown=3,
                      checkout_timeout_s=2.0)
    sched = QueryScheduler(eng, cfg, faults=faults)
    mirror = ChaosMirror(tables, eng)
    tickets = []
    bg_threads = []
    try:
        for _ in range(int(rng.integers(25, 45))):
            roll = rng.random()
            if roll < 0.45:
                name = QUERY_POOL[rng.integers(0, len(QUERY_POOL))]
                p = PARAM_QUERIES[name].sample(rng)
                dl = None if rng.random() < 0.7 else \
                    float(rng.uniform(0.001, 5.0))
                tickets.append(sched.submit(name, p, deadline_s=dl))
            elif roll < 0.60:
                sched.pump(int(rng.integers(1, 4)))
            elif roll < 0.72:
                mirror.append_fact(rng, int(rng.integers(1, 60)))
            elif roll < 0.80:
                d = list(DIM_PK)[rng.integers(0, 4)]
                mirror.append_dim(rng, d, int(rng.integers(1, 10)))
            elif roll < 0.85:
                d = list(DIM_PK)[rng.integers(0, 4)]
                mirror.delete_dim(rng, d, int(rng.integers(1, 3)))
            elif roll < 0.90:
                d = list(DIM_PK)[rng.integers(0, 4)]
                bg_threads.append(sched.compact_in_background(d))
                mirror._record()   # publish may land later; see below
            else:
                faults.clear()
                site = rng.random()
                if site < 0.4:
                    faults.crash_on("worker:",
                                    nth=int(rng.integers(1, 3)))
                elif site < 0.6:
                    q = QUERY_POOL[rng.integers(0, len(QUERY_POOL))]
                    faults.crash_on(f"kernel_{flavor}:{q}",
                                    nth=int(rng.integers(1, 3)))
                elif site < 0.8:
                    faults.crash_on("snapshot_refresh",
                                    nth=int(rng.integers(1, 3)))
                else:
                    faults.delay_on("worker:", float(rng.uniform(0, 0.01)))
        faults.clear()
        for t in bg_threads:
            t.join(timeout=30.0)
        # a background publish after the last mirror step bumps the
        # engine past the recorded epochs; compaction is logically
        # invisible, so record those epochs now (same frozen state)
        mirror._record()
        sched.pump()
        return _verify_all(mirror, tickets)
    finally:
        sched.close()


@pytest.mark.parametrize("fusion", ["composed", "mega"])
@pytest.mark.parametrize("seed", range(8))
def test_chaos_randomized_trials(tables, seed, fusion):
    """Randomized fault/mutation/serve interleavings: every completed
    response oracle-exact at its reported epoch."""
    counts = _chaos_trial(tables, seed * 7919 + 3, fusion)
    assert counts["ok"] > 0, "trial served nothing — no evidence"


# ---------------------------------------------------------------------------
# targeted scenarios
# ---------------------------------------------------------------------------


def test_straggler_and_crash_under_threaded_serving(tables):
    """Threaded dispatchers + concurrent ingest + a straggling worker +
    periodic worker crashes: everything that completes is exact."""
    eng = _engine(tables)
    faults = FaultRegistry()
    sched = QueryScheduler(
        eng, ServeConfig(max_queue=32, max_batch=4, n_workers=3,
                         backoff_s=0.0, checkout_timeout_s=5.0),
        faults=faults)
    mirror = ChaosMirror(tables, eng)
    rng = np.random.default_rng(21)
    mut_mu = threading.Lock()   # mirror mirror is not thread-safe
    stop = threading.Event()

    def ingest_loop():
        while not stop.is_set():
            with mut_mu:
                mirror.append_fact(rng, 16)
            time.sleep(0.002)

    faults.delay_on("worker:", 0.004, every=True)   # everyone straggles
    sched.start(n_dispatchers=2)
    ing = threading.Thread(target=ingest_loop, daemon=True)
    ing.start()
    tickets = []
    try:
        for i in range(60):
            if i % 20 == 10:
                faults.crash_on("worker:", nth=1)
            name = QUERY_POOL[i % len(QUERY_POOL)]
            tickets.append(sched.submit(
                name, PARAM_QUERIES[name].sample(rng)))
            time.sleep(0.001)
        for t in tickets:
            assert t.wait(timeout=60.0) is not None
    finally:
        stop.set()
        ing.join(timeout=10.0)
        sched.stop()
    with mut_mu:
        counts = _verify_all(mirror, tickets)
    # under a universal straggler much of the load sheds — that is the
    # design; the gate is that what completed is exact and the rest
    # (checked by _verify_all) was explicitly rejected/timed out/failed
    assert counts["ok"] >= 15
    sched.close()


def test_snapshot_release_races_refresh(tables):
    """Rapid epoch churn swaps the pin while batches execute on retired
    pins — refcounts must keep every in-flight snapshot alive exactly
    until its last batch finishes, and results stay exact."""
    eng = _engine(tables)
    sched = QueryScheduler(eng, ServeConfig(max_queue=64, max_batch=2,
                                            n_workers=2))
    mirror = ChaosMirror(tables, eng)
    rng = np.random.default_rng(5)
    sched.start(n_dispatchers=2)
    tickets = []
    try:
        for i in range(40):
            name = QUERY_POOL[i % len(QUERY_POOL)]
            tickets.append(sched.submit(
                name, PARAM_QUERIES[name].sample(rng)))
            if i % 3 == 0:   # churn: every refresh retires the old pin
                mirror.append_fact(rng, 8)
        for t in tickets:
            assert t.wait(timeout=60.0) is not None
    finally:
        sched.stop()
    counts = _verify_all(mirror, tickets)
    assert counts["ok"] >= 30
    # live snapshots are bounded: scheduler pin (+ maybe in-flight)
    sched.close()


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_ingest_thread_killed_serving_degrades_not_wrong(tables):
    """The ingest thread dies mid-stream; serving keeps answering from
    the last published epoch — stale/lag-stamped once refresh fails,
    and still oracle-exact at every reported epoch."""
    eng = _engine(tables)
    faults = FaultRegistry()
    sched = QueryScheduler(eng, ServeConfig(), faults=faults)
    mirror = ChaosMirror(tables, eng)
    rng = np.random.default_rng(17)

    died = threading.Event()

    def doomed_ingest():
        for i in range(5):
            mirror.append_fact(rng, 8)
        died.set()
        raise RuntimeError("ingest thread killed")   # daemon dies here

    ing = threading.Thread(target=doomed_ingest, daemon=True)
    # serve before, during, and after the ingest thread's death
    tickets = [sched.submit("Q2.1", PARAM_QUERIES["Q2.1"].sample(rng))]
    sched.pump()
    ing.start()
    died.wait(timeout=30.0)
    ing.join(timeout=10.0)
    # ingest is gone; epoch frozen at its last publish.  Refresh also
    # starts failing (recovery in flight, say): serving must degrade.
    faults.on("snapshot_refresh", lambda s: (_ for _ in ()).throw(
        RuntimeError("refresh blocked")))
    stale_seen = False
    for _ in range(6):
        t = sched.submit("Q3.2", PARAM_QUERIES["Q3.2"].sample(rng))
        tickets.append(t)
        sched.pump()
        r = t.response
        if r.status == "ok" and r.stale:
            stale_seen = True
    counts = _verify_all(mirror, tickets)
    assert counts["ok"] == len(tickets)   # nothing was wrong or dropped
    # whether lag appeared depends on refresh timing vs the kill; the
    # invariant that matters is exactness above, but the degraded path
    # must have been exercised when the pin lagged the head
    if sched.info()["pinned_epoch"] < eng.epoch:
        assert stale_seen
    sched.close()


def test_recovery_concurrent_with_serving(tables, tmp_path):
    """Crash-recover the engine while a scheduler keeps serving pinned
    snapshots from the dead incarnation, then rebind: pre-rebind answers
    are stale-exact at their reported epochs, post-rebind answers serve
    the recovered head."""
    eng = _engine(tables)
    root = os.fspath(tmp_path / "root")
    eng.persist(root)
    mirror = ChaosMirror(tables, eng)
    rng = np.random.default_rng(29)
    mirror.append_fact(rng, 20)
    sched = QueryScheduler(eng, ServeConfig())
    tickets = [sched.submit("Q1.1", PARAM_QUERIES["Q1.1"].sample(rng))]
    sched.pump()
    # simulate process death: the WAL handle closes, mutations stop, but
    # the scheduler still holds the old incarnation's snapshot
    eng.close()
    t = sched.submit("Q2.2", PARAM_QUERIES["Q2.2"].sample(rng))
    tickets.append(t)
    sched.pump()
    assert t.response.status == "ok"   # the pinned snapshot outlives close
    # recovery runs beside serving on the recovered root
    recovered = {}

    def recover():
        recovered["eng"] = SSBEngine.open(
            root, device="cpu", policy=ExecutionPolicy(fusion="composed"))

    rec = threading.Thread(target=recover)
    rec.start()
    t2 = sched.submit("Q3.3", PARAM_QUERIES["Q3.3"].sample(rng))
    tickets.append(t2)
    sched.pump()
    rec.join(timeout=120.0)
    eng2 = recovered["eng"]
    assert eng2.epoch == eng.epoch   # every published epoch recovered
    # cut over: serving continues against the recovered incarnation
    sched.rebind(eng2)
    t3 = sched.submit("Q4.2", PARAM_QUERIES["Q4.2"].sample(rng))
    tickets.append(t3)
    sched.pump()
    assert t3.response.status == "ok"
    assert t3.response.epoch == eng2.epoch and not t3.response.stale
    # post-rebind mutations publish new epochs and serve exactly
    mirror.eng = eng2
    mirror.append_fact(rng, 10)
    t4 = sched.submit("Q4.3", PARAM_QUERIES["Q4.3"].sample(rng))
    tickets.append(t4)
    sched.pump()
    assert t4.response.epoch == eng2.epoch
    counts = _verify_all(mirror, tickets)
    assert counts["ok"] == len(tickets)
    sched.close()
    eng2.close()


# ---------------------------------------------------------------------------
# the fault machinery against the JAX package's, and a lock stress test
# ---------------------------------------------------------------------------


def test_fault_registry_matches_jax():
    """``FaultRegistry``, ``NULL_FAULTS`` and ``boom_on`` behave as the
    JAX package's on the same sequence of sites."""
    from repro.durability import faults as jfaults
    from repro_torch.durability import faults as pfaults

    for pkg in (pfaults, jfaults):
        reg = pkg.FaultRegistry()
        seen = []
        reg.on("kernel_", seen.append)
        reg.crash_on("worker:", nth=2)
        reg.hit("worker:1")
        reg.hit("kernel_mega:Q2.1")
        with pytest.raises(pkg.CrashPoint, match="worker:2"):
            reg.hit("worker:2")
        assert seen == ["kernel_mega:Q2.1"] and reg.armed
        assert dict(reg.hits) == {"worker:1": 1, "kernel_mega:Q2.1": 1,
                                  "worker:2": 1}
        reg.clear()
        assert not reg.armed and not reg.hits
        with pytest.raises(RuntimeError, match="shared"):
            pkg.NULL_FAULTS.on("x", print)
        pkg.NULL_FAULTS.hit("anything")
        hook = pkg.boom_on("fsync", nth=2, exc=ValueError)
        hook("fsync")
        hook("write")
        with pytest.raises(ValueError):
            hook("fsync")


def test_release_on_other_threads_never_breaks_a_pin_scan(tables):
    """Snapshots released on many threads while another thread scans the
    engine's live snapshots (the scan every pin check makes): the scan
    never sees the set change under it, and every release is counted."""
    import sys

    eng = _engine(tables)
    rounds, n_threads, per = 6, 8, 16
    errors = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(rounds):
            snaps = [eng.snapshot() for _ in range(n_threads * per)]
            done = threading.Event()

            def releaser(i):
                try:
                    for s in snaps[i * per:(i + 1) * per]:
                        s.release()
                except Exception as e:  # reported below
                    errors.append(e)

            def scanner():
                try:
                    while not done.is_set():
                        eng.snapshot_info()
                        eng._fact_pinned()
                except Exception as e:  # reported below
                    errors.append(e)

            scan = threading.Thread(target=scanner, daemon=True)
            scan.start()
            threads = [threading.Thread(target=releaser, args=(i,),
                                        daemon=True)
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60.0)
            done.set()
            scan.join(timeout=60.0)
            assert not scan.is_alive()
            assert not any(t.is_alive() for t in threads)
            assert eng.snapshot_info()["live_snapshots"] == 0
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    assert eng.snapshot_info()["snapshots_taken"] == \
        rounds * n_threads * per


def test_snapshots_and_mutations_under_thread_stress(tables):
    """More threads than cores take and release snapshots, and query them,
    while others append and ingest, with a short switch interval: the
    counters guarded by the engine lock lose no update, every epoch is
    published once, and every snapshot answers as the oracle at its
    epoch."""
    import sys

    eng = _engine(tables)
    eng.warm_cache()
    mirror = ChaosMirror(tables, eng)
    mut_mu = threading.Lock()
    errors, answers = [], []
    n_readers, n_snaps = 12, 6
    rng = np.random.default_rng(41)

    def reader(i):
        try:
            for j in range(n_snaps):
                with eng.snapshot() as snap:
                    name = ("Q1.1", "Q2.1", "Q3.2")[(i + j) % 3]
                    p = PARAM_QUERIES[name].defaults
                    t, g = snap.run(name)
                    answers.append((snap.epoch, name, p, int(t),
                                    g.numpy().copy()))
        except Exception as e:  # reported below, never swallowed
            errors.append(e)

    def writer():
        try:
            for k in range(4):
                with mut_mu:
                    mirror.append_fact(rng, 24)
                    mirror.append_dim(rng, ("customer", "part")[k % 2], 3)
        except Exception as e:
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=reader, args=(i,), daemon=True)
                   for i in range(n_readers)]
        threads.append(threading.Thread(target=writer, daemon=True))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    info = eng.snapshot_info()
    assert info["snapshots_taken"] == n_readers * n_snaps
    assert info["live_snapshots"] == 0
    assert sorted(mirror.frozen) == list(range(eng.epoch + 1))
    assert len(answers) == n_readers * n_snaps
    for epoch, name, p, t, g in answers:
        want_t, want_g = mirror.frozen[epoch].param_query(name, p)
        assert t == want_t, (epoch, name)
        np.testing.assert_array_equal(g, want_g)
