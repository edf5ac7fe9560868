"""The port's epoch snapshots against the JAX package's, bit for bit.

A port engine and a JAX engine on the same tables take the same seeded
timeline of {snapshot, query, fact append, dimension append, delete,
compact, release}; every query on a live snapshot equals the JAX
snapshot's at the same epoch and a host numpy oracle frozen with it, and
both engines report the same epochs and pin counters
(``snapshot_info()``) after every step.  Then the in-place hazards: a
snapshot pinned across appends and compactions that would write its
tensors, release re-arming the in-place writes, a released snapshot
refusing queries, the empty compact as a strict no-op, both compaction
flavors (grow fallback included) against a dict oracle and the JAX
package, and the snapshot-aware compaction pricing.
"""
import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import costmodel as jcostmodel
from repro.core import planner as jplanner
from repro.engine import SSBEngine as JaxEngine
from repro.engine import compact_index as jax_compact_index
from repro.engine import build_dim_index as jax_build_dim_index
from repro.engine import ingest_index as jax_ingest_index
from repro.engine import generate_ssb as jax_generate_ssb
from repro_torch.core import costmodel, planner
from repro_torch.core.delta import delta_is_empty, empty_delta
from repro_torch.engine import (EpochSnapshot, SSBEngine, Table,
                                build_dim_index, compact_index,
                                generate_ssb, ingest_index, lookup)
from repro_torch.engine.queries import DIM_PK, FACT_FK
from repro_torch.serving import LogicalModel

SF = 0.002
QUERY_SAMPLE = ("Q1.1", "Q2.1", "Q3.2", "Q4.2", "Q4.3")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread_when_parallel():
    """In a parallel run (pytest-xdist workers share the cores) this
    module's torch ops take one thread each: OpenMP regions, which wait
    for every thread, stall when the cores are oversubscribed."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        yield
        return
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tables():
    return generate_ssb(SF, seed=5, device="cpu")


@pytest.fixture(scope="module")
def jtables():
    return jax_generate_ssb(sf=SF, seed=5)


def _assert_answers(got, want, tag):
    for q, (t, g) in want.items():
        assert int(got[q][0]) == int(t), f"{tag}{q}: total"
        np.testing.assert_array_equal(np.asarray(got[q][1]), np.asarray(g),
                                      err_msg=f"{tag}{q}: groups")


def _oracle(model, names):
    return {q: model.query(q) for q in names}


def _fact_batch(model, rng, n, start_key, hot_dim=None, hot_keys=()):
    src = rng.integers(0, model.fact["orderkey"].shape[0], n)
    cols = {k: v[src].copy() for k, v in model.fact.items()}
    cols["orderkey"] = np.arange(start_key, start_key + n, dtype=np.int32)
    if hot_dim is not None and len(hot_keys):
        pick = rng.random(n) < 0.4
        cols[FACT_FK[hot_dim]] = np.where(
            pick, rng.choice(np.asarray(hot_keys, np.int32), n),
            cols[FACT_FK[hot_dim]]).astype(np.int32)
    return cols


class Lockstep:
    """A port engine, a JAX engine and the numpy oracle, mutated together.

    Every mutation goes to all three; ``snap()`` freezes all three.  After
    each step both engines must report the same epoch and the same
    snapshot counters (pins, pinned copies, fact generation)."""

    def __init__(self, tables, jtables, schedule="gathered"):
        self.port = SSBEngine(dict(tables), schedule=schedule, device="cpu")
        self.jax = JaxEngine(dict(jtables), mode="jspim", schedule=schedule)
        self.model = LogicalModel(tables)

    def check(self):
        assert self.port.epoch == self.jax.epoch
        # ``snapshot_reprobes`` is the port's own: the JAX engine does not
        # count its snapshots' lazy probes
        info = self.port.snapshot_info()
        assert info.pop("snapshot_reprobes") >= 0
        assert info == self.jax.snapshot_info()

    def snap(self):
        out = (self.port.snapshot(), self.jax.snapshot(),
               self.model.freeze())
        assert out[0].epoch == out[1].epoch == self.port.epoch
        self.check()
        return out

    def warm(self):
        self.port.warm_cache()
        self.jax.warm_cache()

    def append_fact(self, cols):
        rp = self.port.append_fact_rows({k: v.copy() for k, v in
                                         cols.items()})
        rj = self.jax.append_fact_rows({k: v.copy() for k, v in
                                        cols.items()})
        assert rp["dims"] == rj["dims"]
        self.model.append_fact(cols)
        self.check()
        return rp

    def append_dim(self, dim, cols):
        self.port.append_rows(dim, cols)
        self.jax.append_rows(dim, cols)
        self.model.append_dim(dim, cols)
        self.check()

    def delete(self, dim, keys):
        self.port.ingest(dim, keys, op="delete", auto_compact=False)
        self.jax.ingest(dim, keys, op="delete", auto_compact=False)
        self.model.delete_keys(dim, keys)
        self.check()

    def insert(self, dim, keys, rows):
        self.port.ingest(dim, keys, rows, op="insert", auto_compact=False)
        self.jax.ingest(dim, keys, rows, op="insert", auto_compact=False)
        for k, r in zip(keys, rows):
            self.model.repoint(dim, k, r)
        self.check()

    def compact(self, dim):
        self.port.compact(dim)
        self.jax.compact(dim)
        self.check()


def _check_image(psnap, jsnap, frozen, names, tag, paths=("cached",)):
    """The port snapshot's answers on each path equal the JAX snapshot's
    and the frozen oracle's."""
    want = _oracle(frozen, names)
    _assert_answers({q: jsnap.run(q) for q in names}, want, f"{tag} jax ")
    for path in paths:
        if path == "cached":
            got = psnap.run_all(list(names))
        elif path == "cold":
            got = {q: psnap.run(q, use_cache=False) for q in names}
        else:
            got = {q: psnap.run(q, fusion="mega") for q in names}
        _assert_answers(got, want, f"{tag} {path} ")


# ---------------------------------------------------------------------------
# seeded interleavings: the port's snapshots answer as the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule,seed", [("gathered", 3), ("deduped", 11),
                                           ("hot_cold", 7), ("auto", 19)])
def test_snapshot_interleavings_match_jax(tables, jtables, schedule, seed):
    """Every query on every live snapshot equals the JAX snapshot at the
    same epoch and the oracle frozen with it, through a seeded timeline,
    under each forced schedule and the CPU planner's own pick; epochs and
    pin counters agree after every step."""
    rng = np.random.default_rng(seed)
    ls = Lockstep(tables, jtables, schedule)
    ls.warm()
    live = []
    next_key = 50_000_000
    next_dim_key = {d: 10_000_000 + i * 100_000 for i, d in enumerate(DIM_PK)}
    new_dim_keys = {d: [] for d in DIM_PK}

    def do_snapshot():
        live.append(ls.snap())

    def do_query():
        q = QUERY_SAMPLE[rng.integers(0, len(QUERY_SAMPLE))]
        if live and rng.random() < 0.7:
            psnap, jsnap, frozen = live[rng.integers(0, len(live))]
            _check_image(psnap, jsnap, frozen, (q,), f"snap@{psnap.epoch}")
        else:
            want = _oracle(ls.model, (q,))
            _assert_answers(ls.port.run_all([q]), want, "head ")
            _assert_answers({q: ls.jax.run(q)}, want, "head jax ")
            ls.check()

    def do_append():
        nonlocal next_key
        n = int(rng.integers(1, 200))
        dims = [d for d in DIM_PK if new_dim_keys[d]]
        hot = dims[rng.integers(0, len(dims))] if dims else None
        batch = _fact_batch(ls.model, rng, n, next_key, hot,
                            new_dim_keys.get(hot, []))
        next_key += n
        ls.append_fact(batch)

    def do_dim_append():
        d = list(DIM_PK)[rng.integers(0, 4)]
        n = int(rng.integers(1, 40))
        k0 = next_dim_key[d]
        next_dim_key[d] += n
        cols = {c: rng.integers(0, 5, n).astype(np.int32)
                for c in ls.model.dims[d] if c != DIM_PK[d]}
        cols[DIM_PK[d]] = np.arange(k0, k0 + n, dtype=np.int32)
        ls.append_dim(d, cols)
        new_dim_keys[d].extend(cols[DIM_PK[d]].tolist())

    def do_delete():
        d = list(DIM_PK)[rng.integers(0, 4)]
        pk = ls.model.dims[d][DIM_PK[d]]
        alive = np.asarray([k for k in pk if int(k) not in
                            ls.model.deleted[d]], np.int32)
        if alive.size >= 8:
            ls.delete(d, rng.choice(alive, int(rng.integers(1, 6)),
                                    replace=False))

    def do_compact():
        ls.compact(list(DIM_PK)[rng.integers(0, 4)])

    def do_release():
        if live:
            for s in live.pop(rng.integers(0, len(live)))[:2]:
                s.release()
                assert s.released
            ls.check()

    actions = [do_snapshot, do_query, do_append, do_dim_append, do_delete,
               do_compact, do_release]
    weights = np.asarray([2, 4, 3, 2, 1.5, 1, 1], np.float64)
    do_snapshot()  # at least one long-lived snapshot
    for _ in range(14):
        actions[rng.choice(len(actions), p=weights / weights.sum())]()
    want = _oracle(ls.model, QUERY_SAMPLE)
    _assert_answers(ls.port.run_all(list(QUERY_SAMPLE)), want, "final head ")
    for psnap, jsnap, frozen in live:
        _check_image(psnap, jsnap, frozen, QUERY_SAMPLE,
                     f"final snap@{psnap.epoch}",
                     paths=("cached", "cold", "mega"))
        psnap.release()
        jsnap.release()
    ls.check()


# ---------------------------------------------------------------------------
# the in-place hazards
# ---------------------------------------------------------------------------


def _steady(tables, jtables, rng, n_appends=4, batch=100):
    """Lockstep engines whose fact buffers and cached probes are written
    in place by the next append."""
    ls = Lockstep(tables, jtables)
    ls.warm()
    for i in range(n_appends):
        ls.append_fact(_fact_batch(ls.model, rng, batch,
                                   20_000_000 + i * batch))
    assert ls.port.tables["lineorder"].tail_owned
    assert ls.port._cache_owned == set(DIM_PK)
    return ls


def test_pinned_snapshot_survives_in_place_appends(tables, jtables):
    """A snapshot pinned at steady state, read after appends that would
    have written its tensors: the first append copies (``pin_copies``
    grows as in the JAX package), the next ones write the fresh
    generation in place, and the snapshot's answers and raw cached probes
    stay bit-identical."""
    rng = np.random.default_rng(17)
    ls = _steady(tables, jtables, rng)
    psnap, jsnap, frozen = ls.snap()
    base = {d: tuple(t.clone() for t in psnap.probe_dim(d)) for d in DIM_PK}
    col = ls.port.tables["lineorder"]["custkey"]
    _check_image(psnap, jsnap, frozen, QUERY_SAMPLE, "pre-append")
    pc0, gen0 = (ls.port.snapshot_info()[k] for k in ("pin_copies",
                                                      "fact_gen"))
    ptrs = []
    for i in range(3):
        rep = ls.append_fact(_fact_batch(ls.model, rng, 100,
                                         30_000_000 + i * 100))
        assert all(v == "extended" for v in rep["dims"].values())
        ptrs.append(ls.port.tables["lineorder"]["custkey"].data_ptr())
    info = ls.port.snapshot_info()
    assert info["pin_copies"] == pc0 + 1 + len(DIM_PK)  # fact + 4 caches
    assert info["fact_gen"] == gen0 + 1
    assert ptrs[0] != col.data_ptr() and ptrs[0] == ptrs[1] == ptrs[2]
    _check_image(psnap, jsnap, frozen, QUERY_SAMPLE, "post-append",
                 paths=("cached", "cold", "mega"))
    for d, (f0, r0) in base.items():
        f1, r1 = psnap.probe_dim(d)
        assert torch.equal(f0, f1) and torch.equal(r0, r1), d
    want = _oracle(ls.model, QUERY_SAMPLE)
    _assert_answers(ls.port.run_all(list(QUERY_SAMPLE)), want, "head ")
    assert ls.port.epoch > psnap.epoch and psnap.epoch_lag() == 3
    psnap.release()
    jsnap.release()


def test_release_rearms_in_place_writes(tables, jtables):
    """Once the last snapshot pinning a generation is released, appends
    write in place again: no further copies, the same buffers."""
    rng = np.random.default_rng(23)
    ls = _steady(tables, jtables, rng)
    s1, s2 = ls.snap(), ls.snap()
    ls.append_fact(_fact_batch(ls.model, rng, 100, 40_000_000))  # copies
    pc = ls.port.snapshot_info()["pin_copies"]
    assert pc > 0
    for s in (*s1[:2], *s2[:2]):
        s.release()
    ls.check()
    ptr = ls.port.tables["lineorder"]["orderkey"].data_ptr()
    cache_ptr = ls.port._probe_cache["part"][0].data_ptr()
    gen = ls.port.snapshot_info()["fact_gen"]
    for i in range(2):
        ls.append_fact(_fact_batch(ls.model, rng, 100, 41_000_000 + i * 100))
    info = ls.port.snapshot_info()
    assert info["pin_copies"] == pc and info["fact_gen"] == gen
    assert info["live_snapshots"] == 0
    assert ls.port.tables["lineorder"]["orderkey"].data_ptr() == ptr
    assert ls.port._probe_cache["part"][0].data_ptr() == cache_ptr


def test_unreferenced_snapshot_stops_pinning(tables):
    """Pins are held weakly: a snapshot nobody references pins nothing,
    released or not."""
    eng = SSBEngine(dict(tables), device="cpu")
    snap = eng.snapshot()
    assert eng.snapshot_info()["live_snapshots"] == 1
    del snap
    assert eng.snapshot_info()["live_snapshots"] == 0


def test_pinned_snapshot_survives_swap_compaction(tables, jtables):
    """Compaction under a pin writes fresh planes (the swap flavor): the
    snapshot's lazy probes, cold and mega queries keep reading the old
    table.  Released, the next compaction writes the planes in place."""
    ls = Lockstep(tables, jtables)
    psnap, jsnap, frozen = ls.snap()   # no cached probes: lazy path only
    n0 = ls.port.tables["supplier"].n_rows
    keys = np.arange(7_000_000, 7_000_020, dtype=np.int32)
    ls.insert("supplier", keys, np.arange(n0 - 20, n0, dtype=np.int32))
    plan = ls.port.compaction_plan("supplier")
    assert plan.swap and dataclasses.asdict(plan) == dataclasses.asdict(
        ls.jax.compaction_plan("supplier"))
    planes = ls.port.indexes["supplier"].table.keys
    before = planes.clone()
    ls.compact("supplier")
    assert ls.port.indexes["supplier"].delta is None
    assert ls.port.indexes["supplier"].table.keys is not planes
    assert torch.equal(planes, before)  # the pinned planes are untouched
    _check_image(psnap, jsnap, frozen, ("Q3.2", "Q4.2"), "swap",
                 paths=("cached", "cold", "mega"))
    psnap.release()
    jsnap.release()
    assert not ls.port.compaction_plan("supplier").swap
    keys = np.arange(7_100_000, 7_100_010, dtype=np.int32)
    ls.insert("supplier", keys, np.arange(10, dtype=np.int32))
    planes = ls.port.indexes["supplier"].table.keys
    ls.compact("supplier")
    assert ls.port.indexes["supplier"].table.keys is planes  # in place
    want = _oracle(ls.model, ("Q3.2", "Q4.2"))
    _assert_answers(ls.port.run_all(["Q3.2", "Q4.2"]), want, "in place ")
    _assert_answers(ls.jax.run_all(["Q3.2", "Q4.2"]), want, "jax ")


def test_snapshot_survives_update_command_then_compaction(tables,
                                                         jtables):
    """An Index Update writes a new table generation (fresh key and value
    planes), so the in-place compaction that follows it under a snapshot
    leaves the planes the snapshot reads untouched.  The snapshot answers
    as the oracle frozen with it on every path; the head answers as the
    JAX engine and the oracle, with the same pin counters.  (The JAX
    package's own snapshot shares its keys plane with the updated table
    and loses it to the donated compaction, so it is not read here.)"""
    ls = Lockstep(tables, jtables)
    psnap, jsnap, frozen = ls.snap()
    dim, names = "supplier", ("Q2.1", "Q3.2", "Q4.2")
    keys = np.asarray(tables[dim]["suppkey"])
    for eng in (ls.port, ls.jax):
        eng.index_update(dim, int(keys[3]), 7)
    ls.model.repoint(dim, int(keys[3]), 7)
    ls.check()
    pinned = psnap.indexes[dim].table.keys
    before = pinned.clone()
    head = ls.port.indexes[dim].table.keys
    assert head is not pinned
    ls.delete(dim, keys[10:30])
    n0 = ls.port.tables[dim].n_rows
    ls.insert(dim, np.arange(7_000_000, 7_000_020, dtype=np.int32),
              np.arange(n0 - 20, n0, dtype=np.int32))
    ls.compact(dim)   # an unpinned generation: the in-place flavor
    assert ls.port.indexes[dim].table.keys is head
    assert ls.port.snapshot_info()["pin_copies"] == 0
    assert torch.equal(pinned, before)
    want = _oracle(frozen, names)
    for path in ("cached", "cold", "mega"):
        if path == "cached":
            got = psnap.run_all(list(names))
        elif path == "cold":
            got = {q: psnap.run(q, use_cache=False) for q in names}
        else:
            got = {q: psnap.run(q, fusion="mega") for q in names}
        _assert_answers(got, want, f"snap {path} ")
    want = _oracle(ls.model, names)
    _assert_answers(ls.port.run_all(list(names)), want, "head ")
    _assert_answers(ls.jax.run_all(list(names)), want, "jax head ")
    psnap.release()
    jsnap.release()


def test_snapshot_spans_delete_compact_append_interleaving(tables,
                                                           jtables):
    """A snapshot pinned across delete, compact, dimension append and
    compact (hot/cold full maps sized by the dictionary) keeps serving
    the pre-delete image, as the JAX package's does."""
    ls = Lockstep(tables, jtables, "hot_cold")
    ls.warm()
    psnap, jsnap, frozen = ls.snap()
    dim = "date"
    ls.delete(dim, np.asarray(tables[dim]["datekey"][5:12]))
    ls.compact(dim)
    new = np.arange(30_000_000, 30_000_010, dtype=np.int32)
    cols = {c: np.zeros(10, np.int32) for c in ls.model.dims[dim]
            if c != DIM_PK[dim]}
    cols[DIM_PK[dim]] = new
    ls.append_dim(dim, cols)
    ls.compact(dim)
    _check_image(psnap, jsnap, frozen, ("Q1.1", "Q4.2"), "snap",
                 paths=("cached", "cold", "mega"))
    want = _oracle(ls.model, ("Q1.1", "Q4.2"))
    _assert_answers(ls.port.run_all(["Q1.1", "Q4.2"]), want, "head ")
    psnap.release()
    jsnap.release()


def test_released_snapshot_refuses_queries(tables):
    eng = SSBEngine(dict(tables), device="cpu")
    with eng.snapshot() as snap:
        assert isinstance(snap, EpochSnapshot)
        snap.run("Q1.1")
    assert snap.released
    snap.release()  # idempotent
    for call in (lambda: snap.run("Q1.1"), lambda: snap.probe_dim("date"),
                 lambda: snap.run_all(["Q1.1"], use_cache=False),
                 lambda: snap.epoch_lag()):
        with pytest.raises(RuntimeError, match="released"):
            call()
    assert snap.cache_info()["released"]
    assert eng.snapshot_info()["live_snapshots"] == 0


def test_snapshot_freezes_only_current_probes_and_keeps_its_own(tables):
    """The freeze takes only probe entries stamped with the fact epoch;
    the snapshot's lazy probes land in its own cache, never the
    engine's."""
    eng = SSBEngine(dict(tables), device="cpu")
    eng.warm_cache(["date"])
    eng._probe_epoch["date"] = -1  # a stale stamp reads as a miss
    snap = eng.snapshot()
    assert snap.cache_info()["cached_dims"] == []
    snap.warm_cache()
    assert snap.cache_info()["cached_dims"] == sorted(DIM_PK)
    assert eng.cache_info()["cached_dims"] == ["date"]
    assert not snap.tables["lineorder"].tail_owned
    snap.release()


def test_empty_compact_is_a_strict_noop(tables):
    """``compact`` with nothing buffered publishes no epoch, drops no
    cached probe, re-plans nothing and touches no pin counter; a zero-op
    ingest mints no delta; a hollow delta is stripped without an epoch."""
    eng = SSBEngine(dict(tables), device="cpu")
    eng.warm_cache()
    snap = eng.snapshot()
    before = (eng.cache_info(), eng.plans["part"], eng.epoch,
              eng.ingest_info()["compactions"], eng.snapshot_info())
    eng.compact("part")
    assert (eng.cache_info(), eng.plans["part"], eng.epoch,
            eng.ingest_info()["compactions"], eng.snapshot_info()) == before
    assert eng.plans["part"] is before[1]
    plan = eng.ingest("part", np.zeros(0, np.int32), np.zeros(0, np.int32),
                      op="insert", auto_compact=False)
    assert plan.reason == "empty" and not plan.compact
    assert eng.indexes["part"].delta is None and eng.epoch == before[2]
    eng.indexes["part"] = dataclasses.replace(
        eng.indexes["part"],
        delta=empty_delta(256, eng.indexes["part"].table.bucket_width))
    assert delta_is_empty(eng.indexes["part"].delta)
    eng.compact("part")
    assert eng.indexes["part"].delta is None
    assert eng.cache_info() == before[0] and eng.epoch == before[2]
    assert eng.plans["part"] is before[1]
    eng.ingest("part", np.asarray([8_111_111], np.int32),
               np.asarray([0], np.int32), op="insert", auto_compact=False)
    eng.compact("part")
    assert eng.ingest_info()["compactions"] == before[3] + 1
    assert eng.snapshot_info()["pin_copies"] == before[4]["pin_copies"] + 1
    snap.release()


# ---------------------------------------------------------------------------
# the two compaction flavors
# ---------------------------------------------------------------------------


def _index_arrays(ix):
    t = ix.table
    return [np.asarray(x) for x in (t.keys, t.values, t.n_unique, t.n_build,
                                    ix.dictionary.keys, ix.dictionary.n)]


@pytest.mark.parametrize("donate", [False, True])
def test_compaction_flavors_and_grow_fallback_match_oracle(donate):
    """A burst that overflows width-2 buckets forces the grow fallback
    mid-merge; it rebuilds from the merged table, so both flavors give
    the JAX package's index and a dict oracle's answers."""
    base = np.arange(64, dtype=np.int32)
    new = np.arange(1000, 1200, dtype=np.int32)
    ops = [(new, np.arange(64, 264, dtype=np.int32), "insert"),
           (base[:10], None, "delete"),
           (base[10:20], np.full(10, 7, np.int32), "upsert")]
    ix = build_dim_index(torch.as_tensor(base), bucket_width=2, load=1.0)
    jx = jax_build_dim_index(jnp.asarray(base), bucket_width=2, load=1.0)
    nb0 = ix.table.num_buckets
    for keys, pays, op in ops:
        ix = ingest_index(ix, keys, pays, op=op)
        jx = jax_ingest_index(jx, keys, pays, op=op)
    c = compact_index(ix, donate=donate)
    jc = jax_compact_index(jx, donate=donate)
    assert c.delta is None and c.table.num_buckets > nb0
    for got, want in zip(_index_arrays(c), _index_arrays(jc)):
        np.testing.assert_array_equal(got, want)
    mp = {int(k): i for i, k in enumerate(base)}
    mp.update(zip(new.tolist(), range(64, 264)))
    for k in base[:10].tolist():
        del mp[k]
    for k in base[10:20].tolist():
        mp[k] = 7
    stream = np.concatenate([base, new, [999_999]]).astype(np.int32)
    pr = lookup(c, torch.as_tensor(stream), impl="torch")
    f, p = pr.found.numpy(), pr.payload.numpy()
    np.testing.assert_array_equal(f, [int(k) in mp for k in stream])
    np.testing.assert_array_equal(p[f], [mp[int(k)] for k in stream[f]])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_in_place_merge_writes_the_planes_and_equals_the_swap(seed):
    """Without growth the in-place flavor writes the input's own planes
    (O(delta)) and gives the swap flavor's index, which leaves its input
    untouched; both equal the JAX package's."""
    rng = np.random.default_rng(seed)
    keys = rng.choice(100_000, 3000, replace=False).astype(np.int32)
    ix = build_dim_index(torch.as_tensor(keys))
    jx = jax_build_dim_index(jnp.asarray(keys))
    ops = [(rng.choice(keys, 40, replace=False), None, "delete"),
           (rng.choice(keys, 40, replace=False),
            rng.integers(0, 3000, 40).astype(np.int32), "upsert"),
           (np.arange(200_000, 200_050, dtype=np.int32),
            np.arange(3000, 3050, dtype=np.int32), "insert")]
    for k, p, op in ops:
        ix = ingest_index(ix, k, p, op=op)
        jx = jax_ingest_index(jx, k, p, op=op)
    before = ix.table.keys.clone(), ix.table.values.clone()
    swap = compact_index(ix, donate=False)
    assert torch.equal(ix.table.keys, before[0])
    assert torch.equal(ix.table.values, before[1])
    planes = ix.table.keys, ix.table.values
    inplace = compact_index(ix, donate=True)
    assert inplace.table.keys is planes[0]
    assert inplace.table.values is planes[1]
    want = _index_arrays(jax_compact_index(jx))
    for a, b, w in zip(_index_arrays(swap), _index_arrays(inplace), want):
        np.testing.assert_array_equal(a, w)
        np.testing.assert_array_equal(b, w)


def test_engines_adopting_one_index_mapping_own_their_planes(tables):
    """``indexes=`` adopts a copy of the table planes, so one engine's
    in-place compaction never reaches another engine's planes."""
    first = SSBEngine(dict(tables), device="cpu")
    first.ingest("part", np.asarray([9_000_001], np.int32),
                 np.asarray([0], np.int32), auto_compact=False)
    first.compact("part")  # unpinned: written in place
    second = SSBEngine(dict(tables), indexes=first.indexes, device="cpu")
    planes = second.indexes["part"].table.keys.clone()
    assert second.indexes["part"].table.keys is not \
        first.indexes["part"].table.keys
    first.ingest("part", np.asarray([9_000_002], np.int32),
                 np.asarray([1], np.int32), auto_compact=False)
    first.compact("part")
    assert torch.equal(second.indexes["part"].table.keys, planes)


# ---------------------------------------------------------------------------
# pricing: the swap flavor, pinned plans
# ---------------------------------------------------------------------------


def test_swap_merge_priced_above_in_place_as_in_jax():
    for swap in (False, True):
        assert costmodel.merge_seconds(100, 100_000, 8, swap=swap) == \
            jcostmodel.merge_seconds(100, 100_000, 8, swap=swap)
    assert costmodel.merge_seconds(100, 100_000, 8, swap=True) > \
        costmodel.merge_seconds(100, 100_000, 8, swap=False)
    kw = dict(delta_entries=100, delta_slots=4096, fill_frac=0.02,
              worst_bucket_frac=0.1, n_build=100_000, n_dict=100_000,
              bucket_width=8)
    unpinned = planner.plan_compaction(expected_probes=50_000_000, **kw)
    pinned = planner.plan_compaction(expected_probes=50_000_000,
                                     pinned=True, **kw)
    assert unpinned.compact and unpinned.reason == "amortized"
    assert not unpinned.swap and pinned.swap
    assert pinned.est_merge_s > unpinned.est_merge_s
    full = planner.plan_compaction(expected_probes=1000, pinned=True,
                                   **{**kw, "fill_frac": 0.6})
    assert full.compact and full.reason == "fill" and full.swap


@pytest.mark.parametrize("pinned", [False, True])
@pytest.mark.parametrize("kw", [
    dict(delta_entries=0, delta_slots=0, fill_frac=0.0),
    dict(delta_entries=600, delta_slots=1024, fill_frac=0.6),
    dict(delta_entries=10, delta_slots=1024, fill_frac=0.01,
         worst_bucket_frac=0.75),
    dict(delta_entries=10, delta_slots=1024, fill_frac=0.01,
         expected_probes=50_000_000),
    dict(delta_entries=2000, delta_slots=16384, fill_frac=0.12,
         n_dict=30_000, expected_probes=6_000_000),
])
def test_plan_compaction_pinned_matches_jax(kw, pinned):
    kw = {"n_build": 100_000, "n_dict": 100_000, "bucket_width": 8,
          "expected_probes": 100_000, **kw}
    got = planner.plan_compaction(pinned=pinned, **kw)
    want = jplanner.plan_compaction(pinned=pinned, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_pinned_view_shares_columns_without_ownership():
    t = Table.from_numpy({"a": np.arange(10, dtype=np.int32)}, "cpu")
    owned = t.append_tail({"a": np.arange(3, dtype=np.int32)})
    view = owned.pinned_view()
    assert view["a"] is owned["a"] and view.n_rows == owned.n_rows
    assert owned.tail_owned and not view.tail_owned
    grown = view.append_tail({"a": np.arange(2, dtype=np.int32)})
    assert grown["a"].data_ptr() != owned["a"].data_ptr()
    assert owned["a"][owned.n_rows:].eq(0).all()
