"""The port's delta buffer, dictionary extension, ingest and compaction
against the JAX package, bit for bit.

Every case feeds the same numpy inputs to ``repro`` and ``repro_torch`` (on
the CPU) and compares every array of the results: the delta planes, the
merged table, the grown dictionary and the compaction decisions.  The
cases follow ``tests/test_ingest.py``.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import delta as jdelta
from repro.core import dictionary as jdict
from repro.core import hash_table as jht
from repro.core import planner as jplanner
from repro.engine import join as jjoin
from repro_torch.core import costmodel
from repro_torch.core import delta as tdelta
from repro_torch.core import dictionary as tdict
from repro_torch.core import hash_table as tht
from repro_torch.core import lookup as tlookup
from repro_torch.core import planner as tplanner
from repro_torch.engine import join as tjoin


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.int32))


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=msg)


def _eq_delta(got: tdelta.DeltaTable, want: jdelta.DeltaTable):
    for f in ("keys", "words", "fill", "n_ops", "overflow"):
        _eq(getattr(got, f).numpy(), getattr(want, f), f)
    assert got.hash_mode == want.hash_mode


def _eq_table(got: tht.JSPIMTable, want: jht.JSPIMTable):
    for f in ("keys", "values", "dup_offsets", "dup_indices", "group_count",
              "n_unique", "n_build", "overflow"):
        _eq(getattr(got, f).numpy(), getattr(want, f), f)
    assert got.hash_mode == want.hash_mode


def _eq_dict(got: tdict.Dictionary, want: jdict.Dictionary):
    _eq(got.keys.numpy(), want.keys, "keys")
    _eq(got.n.numpy(), want.n, "n")
    assert (got.codes is None) == (want.codes is None)
    if got.codes is not None:
        _eq(got.codes.numpy(), want.codes, "codes")


def _both_tables(keys, vals, num_buckets, bucket_width,
                 hash_mode=jht.HASH_FIBONACCI):
    return (tht.build_table(_t(keys), _t(vals), num_buckets=num_buckets,
                            bucket_width=bucket_width, hash_mode=hash_mode),
            jht.build_table(jnp.asarray(keys, jnp.int32),
                            jnp.asarray(vals, jnp.int32),
                            num_buckets=num_buckets,
                            bucket_width=bucket_width, hash_mode=hash_mode))


# ---------------------------------------------------------------------------
# DeltaTable ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_batch_matches_jax(seed):
    """Seeded batches with repeated keys (last write wins), EMPTY_KEY
    entries and a geometry small enough to overflow."""
    rng = np.random.default_rng(seed)
    td = tdelta.empty_delta(4, 4)
    jd = jdelta.empty_delta(4, 4)
    for step in range(4):
        keys = rng.integers(0, 40, 12).astype(np.int32)
        keys[rng.random(12) < 0.1] = tht.EMPTY_KEY
        words = rng.integers(-3, 1000, 12).astype(np.int32)
        td = tdelta.apply_batch(td, _t(keys), _t(words))
        jd = jdelta.apply_batch(jd, jnp.asarray(keys), jnp.asarray(words))
        _eq_delta(td, jd)
        probe = np.concatenate([keys, [41, 1000]]).astype(np.int32)
        for g, w in zip(tdelta.delta_lookup(td, _t(probe)),
                        jdelta.delta_lookup(jd, jnp.asarray(probe))):
            _eq(g.numpy(), w, f"lookup step {step}")
    assert bool(td.overflow)  # 48 draws over 16 slots


def test_last_write_wins_and_overflow_never_corrupts():
    td = tdelta.insert_batch(tdelta.empty_delta(16, 4), _t([5, 5, 5]),
                             _t([1, 2, 3]))
    hit, word = tdelta.delta_lookup(td, _t([5]))
    assert bool(hit[0]) and int(word[0]) >> 1 == 3
    assert tdelta.delta_stats(td).n_entries == 1
    td = tdelta.insert_batch(tdelta.empty_delta(1, 2), _t([1, 2, 3]),
                             _t([10, 20, 30]))
    jd = jdelta.insert_batch(jdelta.empty_delta(1, 2),
                             jnp.asarray([1, 2, 3], jnp.int32),
                             jnp.asarray([10, 20, 30], jnp.int32))
    _eq_delta(td, jd)
    assert bool(td.overflow)
    hit, word = tdelta.delta_lookup(td, _t([1, 2]))
    assert hit.all() and (word.numpy() >> 1).tolist() == [10, 20]


def test_delete_then_reinsert_matches_jax():
    td, jd = tdelta.empty_delta(16, 4), jdelta.empty_delta(16, 4)
    for op, keys, pays in (("insert", [7, 8], [1, 2]), ("delete", [7, 9], None),
                           ("upsert", [7], [9])):
        if op == "delete":
            td = tdelta.delete_batch(td, _t(keys))
            jd = jdelta.delete_batch(jd, jnp.asarray(keys, jnp.int32))
        else:
            td = tdelta.upsert_batch(td, _t(keys), _t(pays))
            jd = jdelta.upsert_batch(jd, jnp.asarray(keys, jnp.int32),
                                     jnp.asarray(pays, jnp.int32))
        _eq_delta(td, jd)
        tstats, jstats = tdelta.delta_stats(td), jdelta.delta_stats(jd)
        assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    hit, word = tdelta.delta_lookup(td, _t([7, 8, 9]))
    assert hit.tolist() == [True, True, True]
    assert word.tolist() == [9 << 1, 2 << 1, tdelta.TOMBSTONE]
    assert tdelta.delta_stats(td).n_tombstones == 1


def test_overlay_delta_matches_jax():
    rng = np.random.default_rng(5)
    keys = rng.choice(5000, 300, replace=False).astype(np.int32)
    tt, jt = _both_tables(keys, np.arange(300), 64, 8)
    td, jd = tdelta.empty_delta(32, 8), jdelta.empty_delta(32, 8)
    new = np.arange(9000, 9040, dtype=np.int32)
    for fn, ks, ps in ((("insert_batch"), new, np.arange(300, 340)),
                       ("delete_batch", keys[:20], None),
                       ("upsert_batch", keys[20:40], np.full(20, 3))):
        args_t = (_t(ks),) if ps is None else (_t(ks), _t(ps))
        args_j = tuple(jnp.asarray(np.asarray(a, np.int32))
                       for a in ((ks,) if ps is None else (ks, ps)))
        td = getattr(tdelta, fn)(td, *args_t)
        jd = getattr(jdelta, fn)(jd, *args_j)
    from repro.core import lookup as jlookup
    stream = rng.choice(np.concatenate([keys, new, [123_456]]), 500)
    got = tlookup.probe_with_delta(tt, td, _t(stream))
    want = jlookup.probe_with_delta(jt, jd, jnp.asarray(stream.astype(
        np.int32)))
    for g, w in zip(got, want):
        _eq(g.numpy(), w)


# ---------------------------------------------------------------------------
# merge_entries
# ---------------------------------------------------------------------------


def test_merge_entries_matches_jax_and_leaves_input():
    rng = np.random.default_rng(3)
    keys = rng.choice(100_000, 2000, replace=False).astype(np.int32)
    tt, jt = _both_tables(keys, np.arange(2000), 1024, 8)
    td, jd = tdelta.empty_delta(256, 8), jdelta.empty_delta(256, 8)
    new = np.arange(500_000, 500_040, dtype=np.int32)
    td = tdelta.insert_batch(td, _t(keys[:30]), _t(np.full(30, 5)))
    td = tdelta.delete_batch(td, _t(keys[30:60]))
    td = tdelta.insert_batch(td, _t(new), _t(np.arange(2000, 2040)))
    jd = jdelta.insert_batch(jd, jnp.asarray(keys[:30]),
                             jnp.full(30, 5, jnp.int32))
    jd = jdelta.delete_batch(jd, jnp.asarray(keys[30:60]))
    jd = jdelta.insert_batch(jd, jnp.asarray(new),
                             jnp.arange(2000, 2040, dtype=jnp.int32))
    before = (tt.keys.clone(), tt.values.clone())
    merged, grow = tdelta.merge_entries(tt, *tdelta.delta_entries(td))
    jmerged, jgrow = jdelta.merge_entries(jt, *jdelta.delta_entries(jd))
    _eq_table(merged, jmerged)
    assert bool(grow) == bool(jgrow) is False
    assert torch.equal(tt.keys, before[0])
    assert torch.equal(tt.values, before[1])


def test_merge_reuses_freed_slot_and_flags_growth():
    # one bucket of width 2, full: a delete frees the cell the insert takes
    tt, jt = _both_tables([0, 1], [0, 1], 1, 2, jht.HASH_IDENTITY)
    codes, words = [0, 7], [tdelta.TOMBSTONE, 7 << 1]
    live = np.ones(2, bool)
    merged, grow = tdelta.merge_entries(tt, _t(codes), _t(words),
                                        torch.as_tensor(live))
    jmerged, jgrow = jdelta.merge_entries(jt, jnp.asarray(codes, jnp.int32),
                                          jnp.asarray(words, jnp.int32),
                                          jnp.asarray(live))
    _eq_table(merged, jmerged)
    assert not bool(grow) and not bool(jgrow)
    pr = tlookup.probe(merged, _t([0, 1, 7]))
    assert pr.found.tolist() == [False, True, True]
    # two inserts into a full bucket with no delete: needs_grow
    codes, words = [5, 9], [5 << 1, 9 << 1]
    merged, grow = tdelta.merge_entries(tt, _t(codes), _t(words),
                                        torch.as_tensor(live))
    jmerged, jgrow = jdelta.merge_entries(jt, jnp.asarray(codes, jnp.int32),
                                          jnp.asarray(words, jnp.int32),
                                          jnp.asarray(live))
    _eq_table(merged, jmerged)
    assert bool(grow) and bool(jgrow)


# ---------------------------------------------------------------------------
# extend_dictionary
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["mid_range", "from_empty", "extend_twice"])
def test_extend_dictionary_matches_jax(case):
    rng = np.random.default_rng(9)
    raw = (np.zeros(0, np.int32) if case == "from_empty" else
           np.sort(rng.choice(10_000, 500, replace=False)).astype(np.int32))
    cap = max(1, raw.shape[0])
    td = tdict.build_dictionary(_t(raw), capacity=cap)
    jd = jdict.build_dictionary(jnp.asarray(raw), capacity=cap)
    batches = [np.asarray([3, 15_000, 15_001], np.int32)]
    if case == "extend_twice":
        batches.append(np.asarray([-5, 7, 20_000], np.int32))
    for new in batches:
        new = np.sort(new[~np.isin(new, raw)])
        td, tcodes = tdict.extend_dictionary(td, new)
        jd, jcodes = jdict.extend_dictionary(jd, new)
        _eq_dict(td, jd)
        _eq(tcodes, jcodes)
        raw = np.concatenate([raw, new])
    probe = np.concatenate([raw, [12_345, -77]]).astype(np.int32)
    _eq(tdict.encode(td, _t(probe)).numpy(),
        jdict.encode(jd, jnp.asarray(probe)))
    codes = np.arange(-1, int(td.n) + 2, dtype=np.int32)
    _eq(tdict.decode(td, _t(codes)).numpy(),
        jdict.decode(jd, jnp.asarray(codes)))


# ---------------------------------------------------------------------------
# ingest_index / compact_index
# ---------------------------------------------------------------------------


def _both_indexes(dim_keys, bucket_width=8):
    return (tjoin.build_dim_index(_t(dim_keys), bucket_width=bucket_width),
            jjoin.build_dim_index(jnp.asarray(dim_keys, jnp.int32),
                                  bucket_width=bucket_width))


def _eq_index(got, want):
    _eq_dict(got.dictionary, want.dictionary)
    _eq_table(got.table, want.table)
    assert (got.delta is None) == (want.delta is None)
    if got.delta is not None:
        _eq_delta(got.delta, want.delta)
    for f in ("num_buckets", "bucket_width", "n_unique", "n_build",
              "overflow", "grow_retries"):
        assert getattr(got.stats, f) == getattr(want.stats, f), f


def test_ingest_grow_loop_matches_jax():
    """Far more ops than the first delta geometry holds: the delta doubles
    (and re-applies its entries) until nothing is dropped."""
    ti, ji = _both_indexes(np.arange(100))
    n = 5000
    ks = np.arange(10_000, 10_000 + n, dtype=np.int32)
    ps = np.arange(100, 100 + n, dtype=np.int32)
    ti = tjoin.ingest_index(ti, ks, ps, op="insert")
    ji = jjoin.ingest_index(ji, ks, ps, op="insert")
    assert ti.delta.num_buckets > 64 and not bool(ti.delta.overflow)
    _eq_index(ti, ji)
    ti = tjoin.ingest_index(ti, ks[:50], op="delete")
    ji = jjoin.ingest_index(ji, ks[:50], op="delete")
    _eq_index(ti, ji)
    probe = np.concatenate([ks[::7], np.arange(0, 100, 3)]).astype(np.int32)
    got = tjoin.lookup(ti, _t(probe), impl="torch")
    want = jjoin.lookup(ji, jnp.asarray(probe))
    for g, w in zip(got, want):
        _eq(g.numpy(), w)


def _mutated_pair(seed, bucket_width=8):
    rng = np.random.default_rng(seed)
    dim_keys = rng.choice(60_000, 3000, replace=False).astype(np.int32)
    ti, ji = _both_indexes(dim_keys, bucket_width)
    batches = [("insert", np.arange(100_000, 100_150, dtype=np.int32),
                np.arange(3000, 3150, dtype=np.int32)),
               ("delete", rng.choice(dim_keys, 120, replace=False), None),
               ("upsert", rng.choice(dim_keys, 60, replace=False),
                rng.integers(0, 3000, 60).astype(np.int32))]
    for op, ks, ps in batches:
        ti = tjoin.ingest_index(ti, ks, ps, op=op)
        ji = jjoin.ingest_index(ji, ks, ps, op=op)
    _eq_index(ti, ji)
    return ti, ji, dim_keys


def test_compact_matches_jax_and_leaves_input():
    ti, ji, dim_keys = _mutated_pair(0)
    before = {f: getattr(ti.table, f).clone()
              for f in ("keys", "values", "n_unique", "n_build")}
    dict_before = ti.dictionary.keys.clone()
    tc = tjoin.compact_index(ti)
    jc = jjoin.compact_index(ji)
    _eq_index(tc, jc)
    assert tc.delta is None and ti.delta is not None
    for f, v in before.items():
        assert torch.equal(getattr(ti.table, f), v), f
    assert torch.equal(ti.dictionary.keys, dict_before)
    stream = np.concatenate([dim_keys, np.arange(100_000, 100_150),
                             [777_777]]).astype(np.int32)
    want = jjoin.lookup(jc, jnp.asarray(stream))
    for g, w in zip(tjoin.lookup(tc, _t(stream), impl="torch"), want):
        _eq(g.numpy(), w)
    # the kernel's miss word is NULL_WORD; the gather path's miss payload
    # is whatever slot 0 holds, so compare the hits' payloads only
    got = tjoin.lookup(tc, _t(stream), impl="cuda")
    found = np.asarray(want.found)
    _eq(got.found.numpy(), found)
    _eq(got.payload.numpy()[found], np.asarray(want.payload)[found])


def test_compaction_growth_fallback_matches_jax():
    ti, ji = _both_indexes(np.arange(64), bucket_width=4)
    nb0 = ti.stats.num_buckets
    new = np.arange(1000, 1512, dtype=np.int32)
    pays = np.arange(64, 576, dtype=np.int32)
    ti = tjoin.ingest_index(ti, new, pays, op="insert")
    ji = jjoin.ingest_index(ji, new, pays, op="insert")
    tc = tjoin.compact_index(ti)
    jc = jjoin.compact_index(ji)
    assert tc.stats.num_buckets > nb0 and tc.stats.grow_retries > 0
    _eq_index(tc, jc)
    pr = tjoin.lookup(tc, _t(np.concatenate([np.arange(64), new])),
                      impl="torch")
    assert bool(pr.found.all())


def test_compact_of_a_hollow_delta_strips_it():
    ti, _ = _both_indexes(np.arange(50))
    hollow = dataclasses.replace(ti, delta=tdelta.empty_delta(64, 8))
    assert tjoin.compact_index(hollow).delta is None
    assert tjoin.effective_index(hollow).delta is None
    assert tjoin.compact_index(ti) is ti


# ---------------------------------------------------------------------------
# plan_compaction and the CUDA gate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(delta_entries=0, delta_slots=0, fill_frac=0.0),
    dict(delta_entries=600, delta_slots=1024, fill_frac=0.6),
    dict(delta_entries=10, delta_slots=1024, fill_frac=0.01,
         worst_bucket_frac=0.75),
    dict(delta_entries=10, delta_slots=1024, fill_frac=0.01,
         expected_probes=50_000_000),
    dict(delta_entries=10, delta_slots=1024, fill_frac=0.01,
         expected_probes=100),
], ids=["empty", "fill", "bucket", "amortized", "defer"])
def test_plan_compaction_matches_jax(kw):
    kw = dict(dict(n_build=200_000, n_dict=200_000, bucket_width=8,
                   expected_probes=6_000_000), **kw)
    got = tplanner.plan_compaction(**kw, backend="cpu")
    want = jplanner.plan_compaction(**kw, backend="cpu")
    assert not want.swap  # the port has no snapshot to pin a table
    assert dataclasses.asdict(got) == {
        f.name: getattr(want, f.name) for f in dataclasses.fields(got)}


def test_compaction_pricing_on_cuda_is_gated():
    """The card's entry prices compaction (its overlay, merge and rebuild
    costs); a backend with no entry raises instead of pricing as a CPU."""
    kw = dict(delta_entries=10, delta_slots=1024, fill_frac=0.01,
              n_build=1000, n_dict=1000, bucket_width=8,
              expected_probes=1000)
    plan = tplanner.plan_compaction(**kw, backend="cuda")
    c = costmodel.HOST_COSTS["cuda"]
    assert plan.est_merge_s == costmodel.merge_seconds(10, 1000, 8,
                                                       backend="cuda")
    assert plan.est_overlay_s == costmodel.delta_overlay_seconds(
        1000, 1024, bucket_width=8, backend="cuda")
    assert plan.compact == (plan.est_overlay_s > plan.est_merge_s)
    assert costmodel.merge_seconds(10, 1000, 8, backend="cuda",
                                   swap=True) > plan.est_merge_s
    assert costmodel.rebuild_seconds(10, 8, backend="cuda") > 10 * c.op_ns \
        * 1e-9
    with pytest.raises(NotImplementedError, match="tpu"):
        tplanner.plan_compaction(**kw, backend="tpu")
    for fn, args in ((costmodel.delta_overlay_seconds, (10, 10)),
                     (costmodel.merge_seconds, (10, 10, 8)),
                     (costmodel.rebuild_seconds, (10, 8))):
        with pytest.raises(NotImplementedError, match="tpu"):
            fn(*args, backend="tpu")
    assert set(costmodel.HOST_COSTS) == {"cpu", "cuda"}


# ---------------------------------------------------------------------------
# §3.2.3 update commands
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("command", ["entry_update", "index_update",
                                     "index_update_absent", "table_update"])
def test_update_commands_match_jax_and_leave_input(command):
    keys = np.arange(0, 300, 3, dtype=np.int32)
    tt, jt = _both_tables(keys, np.arange(100), 32, 8)
    before = (tt.keys.clone(), tt.values.clone())
    if command == "entry_update":
        got = tht.entry_update(tt, 5, 2, 77, 9 << 1)
        want = jht.entry_update(jt, 5, 2, 77, 9 << 1)
    elif command.startswith("index_update"):
        key = 1 if command.endswith("absent") else 42
        got = tht.index_update(tt, key, 1234)
        want = jht.index_update(jt, jnp.int32(key), jnp.int32(1234))
    else:
        rows = np.asarray([3, 17], np.int32)
        nk = np.arange(16, dtype=np.int32).reshape(2, 8) + 1000
        nv = np.arange(16, dtype=np.int32).reshape(2, 8) << 1
        got = tht.table_update(tt, _t(rows), _t(nk), _t(nv))
        want = jht.table_update(jt, jnp.asarray(rows), jnp.asarray(nk),
                                jnp.asarray(nv))
    _eq_table(got, want)
    assert torch.equal(tt.keys, before[0])
    assert torch.equal(tt.values, before[1])
