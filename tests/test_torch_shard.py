"""The port's sharded fact engine against the JAX package.

``tests/test_sharded_engine.py``'s sections, in-process on the CPU with 8
shard regions (``launch/mesh.py``) at sf 0.002: each section holds the
port's ``ShardedSSBEngine`` against the port's ``SSBEngine`` mirror and
against the JAX package's single-device ``SSBEngine`` fed the same numpy
mutation stream.

A. a seeded interleaving of appends, ingest, deletes, dimension appends
   and compactions, with snapshots taken mid-stream;
B. the per-shard epoch stamps: uniform at every epoch, a torn publish
   refused by ``snapshot()``, a republish healing it;
C. the steady state: the reference counts zero jit lowerings, which
   eager PyTorch has no counterpart of.  Its observable half is ported:
   steady-state unpinned appends keep every fact column's buffer
   (``data_ptr()``) and the fact generation, and the answers stay equal;
D. ``EMPTY_KEY`` at the shard boundary: live rows carrying it are
   refused, padding lanes stay dead against tombstones and a poisoned
   dictionary or delta, dead filler rows are never found;
E. reshard 1 -> 4 -> 2 with an append between, and the placement units;
F. the streamed open against an engine over the same chunks.

Then the physical layout against the reference's sharded engine, at 1
shard in-process and at 4 in one subprocess with 4 host devices, and the
prefix-read caveat: the reference's checkpoint state of a 4-shard engine
is not its logical image, so the port's ``persist`` and IVM attach refuse
more than one shard.  The arithmetic is int32: every comparison is exact.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.engine import SSBEngine as JaxEngine
from repro.engine import build_dim_index as jax_build_dim_index
from repro.engine import generate_ssb as jax_generate_ssb
from repro.engine import generate_ssb_dims as jax_generate_ssb_dims
from repro.engine import ingest_index as jax_ingest_index
from repro.engine import lookup as jax_lookup
from repro.engine import stream_ssb_fact as jax_stream_ssb_fact
from repro.engine import Table as JaxTable
from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import ExecutionPolicy
from repro_torch.core.hash_table import EMPTY_KEY
from repro_torch.core.planner import SchedulePlan
from repro_torch.core.policy import validate_sharded
from repro_torch.engine import (SSBEngine, ShardedSSBEngine, Table,
                                build_dim_index, generate_fact_batch,
                                generate_ssb, generate_ssb_dims,
                                ingest_index, random_mutation,
                                sharded_lookup, stream_ssb_fact)
from repro_torch.engine.join import sharded_probe_program
from repro_torch.launch import (Placement, dp_size, make_data_mesh,
                                make_host_mesh, shard_fact_columns,
                                shard_multiple)
from repro_torch.launch.elastic import _sanitize

SF = 0.002
NDEV = 8
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


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


def mesh(n):
    return make_data_mesh(n, device="cpu")


def fingerprint(results):
    return {q: (int(t), np.asarray(g).tolist())
            for q, (t, g) in results.items()}


def same(*results):
    fps = [fingerprint(r) for r in results]
    return all(f == fps[0] for f in fps[1:])


def _np(x):
    return np.asarray(x.cpu().numpy() if torch.is_tensor(x) else x)


def replay(eng, kind, detail):
    """Apply one ``random_mutation`` record to ``eng`` (either package)."""
    if kind == "append_fact_rows":
        eng.append_fact_rows({k: v.copy() for k, v in detail["rows"].items()})
    elif kind == "ingest":
        if "payloads" in detail:
            eng.ingest(detail["dim"], detail["keys"], detail["payloads"],
                       op=detail["op"], auto_compact=False)
        else:
            eng.ingest(detail["dim"], detail["keys"], op="delete",
                       auto_compact=False)
    elif kind == "append_rows":
        eng.append_rows(detail["dim"], detail["rows"], auto_compact=False)
    else:
        eng.compact(detail["dim"])


@pytest.fixture(scope="module")
def result(reference4):
    """Sections A-D on one engine, in order, as the reference runs them
    (the reference's 4-shard layout runs in its subprocess meanwhile)."""
    out = {}
    tables = generate_ssb(SF, seed=3, device="cpu")
    jtables = jax_generate_ssb(SF, seed=3)
    mirror = SSBEngine(dict(tables), device="cpu")
    jx = JaxEngine(dict(jtables))
    sh = ShardedSSBEngine(dict(tables), mesh=mesh(NDEV))
    rng = np.random.default_rng(11)

    # -- A. the differential interleaving ---------------------------------
    ok_steps = True
    snaps = []  # (port snapshot, JAX snapshot, frozen fingerprint)
    for step in range(30):
        kind, detail = random_mutation(mirror, rng, fact_batch=48)
        replay(sh, kind, detail)
        replay(jx, kind, detail)
        if step in (7, 19):
            snaps.append((sh.snapshot(), jx.snapshot(),
                          fingerprint(sh.run_all())))
        if step % 10 == 9:
            ok_steps = ok_steps and same(mirror.run_all(), sh.run_all(),
                                         jx.run_all())
    out["differential_interleaved"] = bool(ok_steps)
    out["differential_snapshots_stable"] = all(
        fingerprint({q: s.run(q) for q in frozen}) == frozen
        and fingerprint(js.run_all()) == frozen
        for s, js, frozen in snaps)
    out["snapshot_stamps_uniform"] = all(
        (_np(s.epoch_stamps) == s.epoch).all()
        and s.cache_info()["shards"] == NDEV for s, _, _ in snaps)
    for s, js, _ in snaps:
        s.release()
        js.release()

    # -- B. epoch stamps ---------------------------------------------------
    out["stamps_track_epoch"] = bool(
        (_np(sh._epoch_stamps) == sh.epoch).all()
        and sh._epoch_stamps.shape == (NDEV,))
    sh._epoch_stamps = sh._epoch_stamps + 1  # a torn publish
    try:
        sh.snapshot()
        out["mixed_epoch_detected"] = False
    except RuntimeError as e:
        out["mixed_epoch_detected"] = "mixed-epoch" in str(e)
    sh._wal_publish()  # re-stamps every shard: freezing works again
    with sh.snapshot() as s2:
        out["republish_heals"] = bool(
            (_np(s2.epoch_stamps) == sh.epoch).all())

    # -- C. the steady state -----------------------------------------------
    warm = [generate_fact_batch(mirror.tables, 48, rng) for _ in range(5)]
    for b in warm[:2]:
        for e in (mirror, sh, jx):
            e.append_fact_rows({k: v.copy() for k, v in b.items()})
    sh.run_all()
    fact = sh.tables["lineorder"]
    ptrs = {k: v.data_ptr() for k, v in fact.columns.items()}
    gen, copies = sh._fact_gen, sh.snapshot_info()["pin_copies"]
    idx = sh.indexes["part"]
    fkp = fact["partkey"]
    first = sharded_lookup(idx, fkp, sh.mesh)
    steady = True
    for _ in range(3):
        again = sharded_lookup(idx, fkp, sh.mesh)
        steady = steady and all(torch.equal(a, b)
                                for a, b in zip(first, again))
    for dim in ("part", "date"):
        sh.invalidate_probe_cache(dim)
        sh.probe_dim(dim)
    grew = False
    for b in warm[2:]:
        mirror.append_fact_rows({k: v.copy() for k, v in b.items()})
        jx.append_fact_rows({k: v.copy() for k, v in b.items()})
        grew = grew or sh.append_fact_rows(
            {k: v.copy() for k, v in b.items()})["capacity_grew"]
    fact = sh.tables["lineorder"]
    out["steady_state_in_place"] = bool(
        steady and not grew and sh._fact_gen == gen
        and sh.snapshot_info()["pin_copies"] == copies
        and {k: v.data_ptr() for k, v in fact.columns.items()} == ptrs)
    out["steady_state_identical"] = same(mirror.run_all(), sh.run_all(),
                                         jx.run_all())

    # -- D. EMPTY_KEY at the shard boundary ----------------------------------
    bad = generate_fact_batch(mirror.tables, 8, rng)
    bad["custkey"] = bad["custkey"].copy()
    bad["custkey"][3] = EMPTY_KEY
    epoch = sh.epoch
    try:
        sh.append_fact_rows(bad)
        out["append_rejects_sentinel"] = False
    except ValueError as e:
        out["append_rejects_sentinel"] = ("EMPTY_KEY" in str(e)
                                          and sh.epoch == epoch)
    poisoned = Table({k: v.clone() for k, v in
                      tables["lineorder"].columns.items()})
    poisoned.columns["partkey"][5] = EMPTY_KEY
    try:
        ShardedSSBEngine(dict(tables, lineorder=poisoned), mesh=mesh(2))
        out["construct_rejects_sentinel"] = False
    except ValueError as e:
        out["construct_rejects_sentinel"] = "EMPTY_KEY" in str(e)

    part_keys = _np(tables["part"]["partkey"])
    n_part = part_keys.shape[0]
    m = 10_001  # odd: 7 padded lanes at 8 shards
    fko = tables["lineorder"]["partkey"][:m]
    jfko = jnp.asarray(_np(fko))

    def pad_lanes_dead(index, jindex, plan=None):
        """Padding lanes dead in the raw program, ``sharded_lookup`` its
        first ``m`` lanes, and those equal to the JAX package's
        single-device ``lookup`` over the same index state."""
        pr = sharded_lookup(index, fko, sh.mesh, plan=plan)
        key_plan = plan if plan is not None and \
            plan.schedule == "deduped" else None
        fk = torch.cat([fko, fko.new_full((7,), EMPTY_KEY)])
        full = sharded_probe_program(sh.mesh, "data", key_plan, 0)(
            index, None, fk)
        ref = jax_lookup(jindex, jfko)
        f = np.asarray(ref.found)
        return bool(not _np(full.found)[m:].any()
                    and np.array_equal(_np(pr.found), _np(full.found)[:m])
                    and np.array_equal(_np(pr.found), f)
                    and np.array_equal(_np(pr.payload)[f],
                                       np.asarray(ref.payload)[f]))

    idx0 = build_dim_index(tables["part"]["partkey"])
    jidx0 = jax_build_dim_index(jtables["part"]["partkey"])
    # tombstone-heavy live delta: delete 60% of the keys, insert new ones
    dead_keys = part_keys[: (n_part * 6) // 10]
    new_keys = np.arange(10**6, 10**6 + 64, dtype=np.int32)
    idx_t = ingest_index(idx0, dead_keys, op="delete")
    idx_t = ingest_index(idx_t, new_keys, np.arange(64, dtype=np.int32),
                         op="insert")
    jidx_t = jax_ingest_index(jidx0, jnp.asarray(dead_keys), op="delete")
    jidx_t = jax_ingest_index(jidx_t, jnp.asarray(new_keys),
                              jnp.arange(64, dtype=jnp.int32), op="insert")
    out["padding_dead_tombstones"] = all(
        pad_lanes_dead(idx_t, jidx_t, plan)
        for plan in (None, SchedulePlan(schedule="deduped")))
    # a poisoned dictionary: EMPTY_KEY smuggled in as a live sorted key, so
    # encode gives it a real code and only the boundary guard keeps the
    # padding lanes dead
    d, jd = idx0.dictionary, jidx0.dictionary
    pk = np.sort(np.concatenate([[np.int32(EMPTY_KEY)],
                                 _np(d.keys)[: d.capacity - 1]]))
    idx_pd = dataclasses.replace(idx0, dictionary=dataclasses.replace(
        d, keys=torch.from_numpy(pk),
        n=torch.tensor(int(d.n) + 1, dtype=torch.int32)))
    jidx_pd = dataclasses.replace(jidx0, dictionary=dataclasses.replace(
        jd, keys=jnp.asarray(pk), n=jnp.int32(int(jd.n) + 1)))
    out["padding_dead_poisoned_dict"] = pad_lanes_dead(idx_pd, jidx_pd)
    # a poisoned delta: insert words planted on free (EMPTY_KEY-keyed)
    # slots, which only a sentinel probe could match
    dl, jdl = idx_t.delta, jidx_t.delta
    idx_pdelta = dataclasses.replace(idx_t, delta=dataclasses.replace(
        dl, words=torch.where(dl.keys == EMPTY_KEY, 7 << 1, dl.words)))
    jidx_pdelta = dataclasses.replace(jidx_t, delta=dataclasses.replace(
        jdl, words=jnp.where(jdl.keys == EMPTY_KEY, jnp.int32(7 << 1),
                             jdl.words)))
    out["padding_dead_poisoned_delta"] = pad_lanes_dead(idx_pdelta,
                                                        jidx_pdelta)

    # the engine's own dead filler rows: a batch 8 does not divide leaves
    # dead rows at the end of the last shard's window, and a live
    # tombstone-heavy delta must never surface one
    odd = generate_fact_batch(mirror.tables, 45, rng)
    for e in (mirror, sh, jx):
        e.append_fact_rows({k: v.copy() for k, v in odd.items()})
    for e in (mirror, sh, jx):
        e.ingest("part", part_keys[:50], op="delete", auto_compact=False)
    found, _ = sh.probe_dim("part")
    info = sh.shard_info()
    out["dead_rows_present"] = info["dead_rows"] == NDEV * 6 - 45
    phys = _np(found).reshape(NDEV, -1)
    start, per, n = sh._windows[-1]
    dead = [(i // per, start + i % per) for i in range(n, NDEV * per)]
    out["dead_rows_never_found"] = bool(
        not phys[:, sh._shard_valid:].any()
        and not any(phys[r, c] for r, c in dead)
        and all(_np(sh.tables["lineorder"]["partkey"]).reshape(
            NDEV, -1)[r, c] == EMPTY_KEY for r, c in dead))
    out["post_tombstone_identical"] = same(mirror.run_all(), sh.run_all(),
                                           jx.run_all())
    for q in ("Q1.1", "Q2.1", "Q4.3"):
        want = fingerprint({q: mirror.run(q)})
        out["post_tombstone_identical"] = bool(
            out["post_tombstone_identical"]
            and fingerprint({q: sh.run(q, use_cache=False)}) == want
            and fingerprint({q: sh.run(q, fusion="mega")}) == want)
    return out


# -- A. the differential interleaving -----------------------------------------
def test_differential_interleaved_mutations(result):
    """Seeded append/ingest/delete/compact interleavings on 8 shards stay
    bit-identical to the port's and the JAX package's single-device
    engines at every check."""
    assert result["differential_interleaved"]


def test_sharded_snapshots_stable_under_mutations(result):
    """Mid-stream sharded snapshots keep answering at their frozen epoch,
    as the JAX engine's snapshots do, while the head mutates on."""
    assert result["differential_snapshots_stable"]


def test_snapshot_epoch_stamps_uniform(result):
    """Every frozen image carries uniform per-shard stamps equal to its
    epoch."""
    assert result["snapshot_stamps_uniform"]


# -- B. epoch stamps ----------------------------------------------------------
def test_epoch_stamps_track_head_epoch(result):
    assert result["stamps_track_epoch"]


def test_mixed_epoch_freeze_fails_loudly(result):
    """A torn publish (stamps off the engine epoch) makes ``snapshot()``
    raise instead of freezing a mixed-epoch image."""
    assert result["mixed_epoch_detected"]


def test_collective_republish_heals(result):
    assert result["republish_heals"]


# -- C. the steady state ------------------------------------------------------
def test_sharded_steady_state_compiles_nothing(result):
    """The observable half of the reference's zero-lowering check:
    repeated sharded probes give the same tensors, and steady-state
    appends on unpinned buffers write in place (same ``data_ptr()`` per
    column, same fact generation, no pinned copy, no growth)."""
    assert result["steady_state_in_place"]


def test_steady_state_still_identical(result):
    assert result["steady_state_identical"]


# -- D. EMPTY_KEY at the shard boundary ---------------------------------------
def test_sharded_append_rejects_sentinel_fk(result):
    """Live fact rows carrying EMPTY_KEY are refused, on append (before
    any state changes) and at construction."""
    assert result["append_rejects_sentinel"]
    assert result["construct_rejects_sentinel"]


@pytest.mark.parametrize("key", ["padding_dead_tombstones",
                                 "padding_dead_poisoned_dict",
                                 "padding_dead_poisoned_delta"])
def test_padding_rows_never_resurrect(result, key):
    """Padding lanes stay unfindable on every schedule against live
    tombstone-heavy deltas and poisoned dictionary or delta state (the
    boundary guard holds), and the real lanes equal the JAX probe."""
    assert result[key]


def test_dead_filler_rows_never_found(result):
    assert result["dead_rows_present"]
    assert result["dead_rows_never_found"]
    assert result["post_tombstone_identical"]


# -- E. reshard ---------------------------------------------------------------
def test_reshard_round_trip_bit_identical():
    """1 -> 4 -> 2 shard moves, with an append between, answer as the
    port's and the JAX package's single-device engines, the logical fact
    image included."""
    t2 = generate_ssb(SF, seed=5, device="cpu")
    ref = SSBEngine(dict(t2), device="cpu")
    jref = JaxEngine(dict(jax_generate_ssb(SF, seed=5)))
    e1 = ShardedSSBEngine(dict(t2), mesh=mesh(1))
    r_ref = ref.run_all()
    assert same(r_ref, e1.run_all(), jref.run_all())
    e4 = e1.reshard(mesh(4))
    assert e4.shard_info()["devices"] == 4
    assert same(r_ref, e4.run_all())
    b = generate_fact_batch(t2, 100, np.random.default_rng(2))
    for e in (ref, jref, e4):
        e.append_fact_rows({k: v.copy() for k, v in b.items()})
    e2 = e4.reshard(mesh(2))
    assert same(ref.run_all(), e2.run_all(), jref.run_all())
    want = ref.tables["lineorder"].trimmed()
    for e in (e4, e2):
        got = e.logical_fact_columns()
        for k in want.names():
            np.testing.assert_array_equal(got[k], _np(want[k]))


def test_fact_columns_pad_to_shard_multiple():
    """A length 4 does not divide pads to the shard multiple: one region
    per shard, the fill after the live rows, never a replicated column."""
    m4 = mesh(4)
    cols, cap, per = shard_fact_columns(
        {"k": np.arange(13, dtype=np.int32)}, m4, fills={"k": -1})
    assert (per, cap) == (4, 4)
    assert cols["k"].shape == (16,) and cols["k"].dtype == torch.int32
    v = _np(cols["k"]).reshape(4, cap)
    np.testing.assert_array_equal(v[:, :per].reshape(-1)[:13],
                                  np.arange(13))
    assert (v[:, :per].reshape(-1)[13:] == -1).all()
    # a capacity past the written rows fills every region's tail
    cols, cap, per = shard_fact_columns(
        {"k": torch.arange(13, dtype=torch.int32)}, m4, fills={"k": -1},
        cap_per_shard=6)
    v = _np(cols["k"]).reshape(4, 6)
    assert (v[:, 4:] == -1).all()
    np.testing.assert_array_equal(v[:, :4].reshape(-1)[:13], np.arange(13))
    with pytest.raises(ValueError, match="below shard rows"):
        shard_fact_columns({"k": np.arange(13)}, m4, fills={"k": 0},
                           cap_per_shard=3)


def test_sanitize_error_mode_raises():
    m4 = mesh(4)
    with pytest.raises(ValueError, match="pad to the shard multiple"):
        _sanitize(("data",), (13,), m4, on_indivisible="error")
    assert _sanitize(("data",), (13,), m4) == (None,)
    assert _sanitize(("data",), (12,), m4, on_indivisible="error") == \
        ("data",)
    assert _sanitize(("data",), (12, 5), m4) == ("data", None)
    assert _sanitize((None, "data"), (3, 8), m4) == (None, "data")


# -- F. streamed open ---------------------------------------------------------
def test_from_streamed_matches_materialized():
    """The chunk-streamed open answers as single-device engines over the
    same (host-materialized) stream; the chunks equal the JAX
    package's."""
    chunks = list(stream_ssb_fact(SF, seed=7, chunk_rows=4096))
    jchunks = list(jax_stream_ssb_fact(SF, seed=7, chunk_rows=4096))
    assert len(chunks) == len(jchunks) == 3
    for c, jc in zip(chunks, jchunks):
        for k in c:
            np.testing.assert_array_equal(c[k], jc[k])
    host_fact = {k: np.concatenate([c[k] for c in chunks])
                 for k in chunks[0]}
    t3 = generate_ssb_dims(SF, seed=7, device="cpu")
    t3["lineorder"] = Table.from_numpy(host_fact, "cpu")
    jt3 = jax_generate_ssb_dims(SF, seed=7)
    jt3["lineorder"] = JaxTable.from_numpy(host_fact)
    es = ShardedSSBEngine.from_streamed(SF, seed=7, mesh=mesh(NDEV),
                                        chunk_rows=4096)
    info = es.shard_info()
    assert same(SSBEngine(t3, device="cpu").run_all(), es.run_all(),
                JaxEngine(jt3).run_all())
    assert info["live_rows"] == host_fact["orderkey"].shape[0]
    assert info["windows"] == len(chunks)
    got = es.logical_fact_columns()
    for k in host_fact:
        np.testing.assert_array_equal(got[k], host_fact[k])


# -- units --------------------------------------------------------------------
def test_validate_sharded_policy():
    """The reference's subspace with ``"torch"`` for its ``"xla"``; the
    port's global default kernel (``"cuda"``) is outside it."""
    validate_sharded(ExecutionPolicy(kernel="torch"))
    validate_sharded(ExecutionPolicy(kernel="torch", schedule="deduped"))
    with pytest.raises(ValueError, match="jspim"):
        validate_sharded(ExecutionPolicy(mode="baseline", kernel="torch"))
    with pytest.raises(ValueError, match="kernel"):
        validate_sharded(ExecutionPolicy(kernel="cuda"))
    with pytest.raises(ValueError, match="kernel"):
        validate_sharded(ExecutionPolicy())  # the port's default kernel
    with pytest.raises(ValueError, match="schedule"):
        validate_sharded(ExecutionPolicy(kernel="torch",
                                         schedule="hot_cold"))


def test_sharded_engine_rejects_unsupported_policy():
    with pytest.raises(ValueError, match="jspim"):
        ShardedSSBEngine({}, policy=ExecutionPolicy(mode="pid"))
    with pytest.raises(ValueError, match="schedule"):
        ShardedSSBEngine({}, policy=ExecutionPolicy(kernel="torch",
                                                    schedule="stream"))


def test_sharded_engine_default_policy_is_torch_kernel():
    """``policy=None`` resolves to ``kernel="torch"`` (where the
    reference's default ``"xla"`` already validates); an explicit
    ``kernel="cuda"`` raises with the reference's message."""
    tables = generate_ssb(0.0005, seed=1, device="cpu")
    eng = ShardedSSBEngine(dict(tables), mesh=mesh(2))
    assert eng.policy == ExecutionPolicy(kernel="torch")
    assert eng.device == torch.device("cpu")
    with pytest.raises(ValueError, match="kernel"):
        ShardedSSBEngine(dict(tables), mesh=mesh(2),
                         policy=ExecutionPolicy(kernel="cuda"))


def test_sharded_engine_refuses_tables_on_another_device():
    """Every table must already live on the mesh's device: no quiet
    move."""
    tables = generate_ssb(0.0005, seed=1, device="cpu")
    with pytest.raises(ValueError, match="lives on"):
        ShardedSSBEngine(dict(tables), mesh=make_data_mesh(2,
                                                           device="meta"))


def test_shard_multiple():
    assert shard_multiple(0, 8) == 0
    assert shard_multiple(1, 8) == 8
    assert shard_multiple(16, 8) == 16
    assert shard_multiple(17, 4) == 20


def test_make_data_mesh_bounds(monkeypatch):
    m = make_data_mesh(1, device="cpu")
    assert m.shape["data"] == 1 and m.device == torch.device("cpu")
    assert make_data_mesh(3, axis="x", device="cpu").shape == {"x": 3}
    with pytest.raises(ValueError):
        make_data_mesh(0, device="cpu")
    with pytest.raises(ValueError):
        make_data_mesh(-2, device="cpu")
    # no device-count bound: every region lives on the one device
    assert make_data_mesh(10**6, device="cpu").shape["data"] == 10**6
    assert hash(make_data_mesh(4, device="cpu")) == hash(mesh(4))
    # the card is the default device: none here raises, never a fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_data_mesh(2)


def test_make_host_mesh_and_dp_size():
    m = make_host_mesh((2, 3), ("data", "model"), device="cpu")
    assert m.shape == {"data": 2, "model": 3}
    assert dp_size(m) == 2
    assert dp_size(make_host_mesh((2, 2, 3), ("pod", "data", "model"),
                                  device="cpu")) == 4
    assert dp_size(make_host_mesh((5,), ("model",), device="cpu")) == 1
    with pytest.raises(ValueError):
        make_host_mesh((2,), ("data", "model"), device="cpu")


def test_restore_shardings_placement_and_replication(tmp_path):
    """``restore(shardings=)``: placed leaves land on the mesh's device,
    a dimension the axis does not divide replicates (no error), unplaced
    leaves follow ``device``, and a spec naming an axis the mesh lacks
    raises."""
    tree = {"a": torch.arange(12, dtype=torch.int32),
            "b": {"c": torch.arange(13, dtype=torch.int32),
                  "d": torch.ones(3, 4)}}
    ckpt.save(str(tmp_path), 1, tree)
    m4 = mesh(4)
    shardings = {"a": Placement(m4, ("data",)),
                 "b": {"c": Placement(m4, ("data",)), "d": None}}
    got = ckpt.restore(str(tmp_path), 1, tree, device="cpu",
                       shardings=shardings)
    for path, want in (("a", tree["a"]), ("c", tree["b"]["c"]),
                       ("d", tree["b"]["d"])):
        leaf = got[path] if path == "a" else got["b"][path]
        assert leaf.device == torch.device("cpu")
        assert torch.equal(leaf, want)
    # a None subtree leaves its leaves where the template's live
    got = ckpt.restore(str(tmp_path), 1, tree,
                       shardings={"a": Placement(m4, ()), "b": None})
    assert torch.equal(got["b"]["c"], tree["b"]["c"])
    with pytest.raises(KeyError):
        ckpt.restore(str(tmp_path), 1, tree,
                     shardings={"a": Placement(m4, ("model",)),
                                "b": None})


# -- the physical layout against the reference's sharded engine ---------------
# 15,000 rows a shard at 4 shards: the planner extends the cached probes
# (at 1,500 it reprobes), so the per-shard extension and the cache's
# growth are compared too
LAYOUT_SF, LAYOUT_SEED = 0.01, 3
# three 45-row appends (the prefix-read record), a growth, one more
LAYOUT_BATCHES = (45, 45, 45, 8300, 45)
ASPECTS = ("shard_info", "physical", "logical", "cache", "reports",
           "run_all")

REFERENCE_LAYOUT = r"""
import numpy as np

from repro.durability.state import engine_state
from repro.engine import generate_ssb
from repro.engine.shard import ShardedSSBEngine
from repro.launch.mesh import make_data_mesh


def reference_layout(ndev, batches):
    sh = ShardedSSBEngine(generate_ssb(LAYOUT_SF, seed=LAYOUT_SEED),
                          mesh=make_data_mesh(ndev))
    sh.warm_cache()
    arrays, reports = {}, []
    for i, b in enumerate(batches):
        reports.append(sh.append_fact_rows(
            {k: v.copy() for k, v in b.items()}))
        if i == 2:  # the prefix-read record: after three 45-row appends
            tree, _ = engine_state(sh)
            for k, v in tree["tables"]["lineorder"].items():
                arrays["state3_" + k] = np.asarray(v)
            for k, v in sh.logical_fact_columns().items():
                arrays["logical3_" + k] = v
    for k, v in sh.tables["lineorder"].columns.items():
        arrays["physical_" + k] = np.asarray(v)
    for k, v in sh.logical_fact_columns().items():
        arrays["logical_" + k] = v
    for d, (f, r) in sh._probe_cache.items():
        arrays["cache_found_" + d] = np.asarray(f)
        arrays["cache_row_" + d] = np.asarray(r)
    for q, (t, g) in sh.run_all().items():
        arrays["total_" + q] = np.asarray(t)
        arrays["groups_" + q] = np.asarray(g)
    return sh.shard_info(), arrays, reports
"""

SUBPROCESS = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={ndev}"
import json
import sys
sys.path.insert(0, {src!r})
import jax
assert len(jax.devices()) == {ndev}
LAYOUT_SF, LAYOUT_SEED = {sf!r}, {seed!r}
""" + "{body}" + r"""
data = np.load({inp!r})
batches = [dict((k.split("__", 1)[1], data[k]) for k in data.files
                if k.startswith("b%d__" % i))
           for i in range({nb})]
info, arrays, reports = reference_layout({ndev}, batches)
np.savez({out!r}, **arrays)
print("RESULT::" + json.dumps({{"info": info, "reports": reports}}))
"""


def _layout_batches():
    base = generate_ssb(LAYOUT_SF, seed=LAYOUT_SEED, device="cpu")
    rng = np.random.default_rng(0)
    return [generate_fact_batch(base, n, rng) for n in LAYOUT_BATCHES]


def _port_layout(ndev, batches):
    sh = ShardedSSBEngine(generate_ssb(LAYOUT_SF, seed=LAYOUT_SEED,
                                       device="cpu"), mesh=mesh(ndev))
    sh.warm_cache()
    arrays, reports = {}, []
    for i, b in enumerate(batches):
        reports.append(sh.append_fact_rows(
            {k: v.copy() for k, v in b.items()}))
        if i == 2:
            for k, v in sh.logical_fact_columns().items():
                arrays["logical3_" + k] = v
    for k, v in sh.tables["lineorder"].columns.items():
        arrays["physical_" + k] = _np(v)
    for k, v in sh.logical_fact_columns().items():
        arrays["logical_" + k] = v
    for d, (f, r) in sh._probe_cache.items():
        arrays["cache_found_" + d] = _np(f)
        arrays["cache_row_" + d] = _np(r)
    for q, (t, g) in sh.run_all().items():
        arrays["total_" + q] = _np(t)
        arrays["groups_" + q] = _np(g)
    return sh, sh.shard_info(), arrays, reports


@pytest.fixture(scope="module")
def reference4(tmp_path_factory):
    """The reference's 4-shard layout, started in a subprocess of 4 host
    devices as soon as the module's first fixture runs (the in-process
    sections run meanwhile); ``layouts`` collects it."""
    batches = _layout_batches()
    d = tmp_path_factory.mktemp("layout")
    inp, res = str(d / "batches.npz"), str(d / "reference4.npz")
    np.savez(inp, **{f"b{i}__{k}": v for i, b in enumerate(batches)
                     for k, v in b.items()})
    code = SUBPROCESS.format(ndev=4, src=os.path.abspath(SRC),
                             sf=LAYOUT_SF, seed=LAYOUT_SEED, inp=inp,
                             out=res, nb=len(batches),
                             body=REFERENCE_LAYOUT)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.pop("PYTHONWARNINGS", None)
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc, res, batches
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def layouts(reference4):
    """Both packages' layouts over the same appends: 1 shard in-process,
    4 shards with the reference in its subprocess."""
    proc, res, batches = reference4
    ns = {"LAYOUT_SF": LAYOUT_SF, "LAYOUT_SEED": LAYOUT_SEED}
    exec(REFERENCE_LAYOUT, ns)
    out = {1: (ns["reference_layout"](1, batches),
               _port_layout(1, batches))}
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr[-4000:]
    line = [ln for ln in stdout.splitlines()
            if ln.startswith("RESULT::")][-1]
    meta = json.loads(line[len("RESULT::"):])
    out[4] = ((meta["info"], dict(np.load(res)), meta["reports"]),
              _port_layout(4, batches))
    return out


def _pick(arrays, prefix):
    return {k: v for k, v in arrays.items() if k.startswith(prefix)}


@pytest.mark.parametrize("aspect", ASPECTS)
@pytest.mark.parametrize("ndev", [1, 4])
def test_layout_matches_reference(layouts, ndev, aspect):
    """At 1 and 4 shards the port lays the fact table out as the
    reference's ``ShardedSSBEngine`` does, through a growth and a batch
    the shard count does not divide: equal counters, physical columns
    (regions, dead rows, fills), logical columns, the tail-extended probe
    cache (grown per shard), per-append reports and answers."""
    (rinfo, rarrays, rreports), (_, pinfo, parrays, preports) = \
        layouts[ndev]
    if aspect == "shard_info":
        assert pinfo == rinfo
        assert pinfo["dead_rows"] > 0 or ndev == 1
    elif aspect == "reports":
        assert json.loads(json.dumps(preports)) == \
            json.loads(json.dumps(rreports))
        assert any(r["capacity_grew"] for r in preports)
        # every append extends every cached dimension, the growth's too
        assert all(r["dims"] and set(r["dims"].values()) == {"extended"}
                   for r in preports)
    else:
        prefix = {"physical": "physical_", "logical": "logical_",
                  "cache": "cache_",
                  "run_all": ("total_", "groups_")}[aspect]
        want = _pick(rarrays, prefix)
        got = _pick(parrays, prefix)
        assert sorted(got) == sorted(want) and want
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_reference_checkpoint_state_is_not_the_logical_image(layouts):
    """The prefix-read caveat, pinned: at 4 shards the reference's
    ``engine_state`` reads lineorder as a prefix of its live rows and
    gets other rows than its own (and the port's) logical image; at 1
    shard the live rows are a prefix and the two agree."""
    (_, r4, _), (_, _, p4, _) = layouts[4]
    (_, r1, _), _ = layouts[1]
    cols = [k[len("logical3_"):] for k in r4 if k.startswith("logical3_")]
    for k in cols:
        np.testing.assert_array_equal(p4["logical3_" + k],
                                      r4["logical3_" + k])
        np.testing.assert_array_equal(r1["state3_" + k],
                                      r1["logical3_" + k])
    assert any(not np.array_equal(r4["state3_" + k], r4["logical3_" + k])
               for k in cols)


def test_prefix_readers_refuse_more_than_one_shard(layouts, tmp_path):
    """The port's ``persist`` and IVM attach raise at 4 shards instead of
    capturing the wrong rows; at 1 shard they work as in the reference
    (a recovery answers as the engine, the maintained views equal
    ``run_all``)."""
    from repro_torch.ivm import MaintainedSuite

    sh4 = layouts[4][1][0]
    with pytest.raises(NotImplementedError, match="prefix"):
        sh4.persist(str(tmp_path / "r4"))
    with pytest.raises(NotImplementedError, match="prefix"):
        MaintainedSuite.attach(sh4)
    assert sh4.durability is None and not sh4._view_suites
    sh1 = layouts[1][1][0]
    suite = MaintainedSuite.attach(sh1)
    assert fingerprint(suite.results()) == fingerprint(sh1.run_all())
    sh1.persist(str(tmp_path / "r1"))
    b = generate_fact_batch(generate_ssb(LAYOUT_SF, seed=LAYOUT_SEED,
                                         device="cpu"), 30,
                            np.random.default_rng(9))
    sh1.append_fact_rows(b)
    assert suite.fresh_at(sh1.epoch)
    assert fingerprint(suite.results()) == fingerprint(sh1.run_all())
    sh1.close()
    rec = SSBEngine.open(str(tmp_path / "r1"), device="cpu")
    assert rec.epoch == sh1.epoch
    assert same(rec.run_all(), sh1.run_all())
    rec.close()
