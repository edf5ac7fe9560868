"""The port's durability tier: WAL format, checkpoint atomicity, recovery.

The JAX package's crash-recovery suite on the port's engine (CPU), with
the JAX package as a second oracle: the deterministic recovery cases
also hold the recovered port engine's answers against a JAX engine that
took the same stream.

The centerpiece is the randomized crash-injection harness
(``test_randomized_crash_recovery_bit_identical``): a ``FailpointFS``
kills the writer at randomized syscall points (mid-record, pre-fsync,
after-fsync-before-publish, and, through the instrumented checkpoint
writer, mid-leaf-write and mid-rename) across randomized mutation
interleavings, then the durability root is reopened and every recovered
answer must be bit-identical to an uninterrupted volatile port engine
that applied exactly the mutations whose WAL records survived, over the
reference's 56 seeds with its coverage asserts.

The oracle needs only the surviving *semantic* record count: compaction
records are replayed for code-path fidelity but are invisible to query
results (every probe path gives the same answers), so the oracle never
compacts and must still agree bit for bit.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from repro.engine import SSBEngine as JaxEngine
from repro.engine import generate_ssb as jax_generate_ssb
from repro_torch.checkpoint.manager import (CheckpointCorruptError,
                                            latest_step, load_arrays,
                                            restore, save, steps)
from repro_torch.durability import (SEMANTIC_KINDS, CrashPoint,
                                    DurabilityManager, FailpointFS, OsFS,
                                    RecoveryError, WriteAheadLog,
                                    read_records, scan)
from repro_torch.durability.faults import boom_on as _boom_on
from repro_torch.durability.faults import \
    checkpoint_crash_sites as _checkpoint_crash_sites
from repro_torch.durability.manager import CKPT_SUBDIR, WAL_NAME
from repro_torch.durability.wal import MAGIC, WALError, encode_record
from repro_torch.engine import SSBEngine, generate_ssb
from repro_torch.engine.queries import DIM_PK, SSB_QUERIES

SF = 0.001
SEED = 7
_ALL_QUERIES = sorted(SSB_QUERIES)
_MUT_DIMS = ("supplier", "customer")
FACT_BATCH = 256
DIM_BATCH = 16


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
def base_tables():
    return generate_ssb(SF, seed=SEED, device="cpu")


@pytest.fixture(scope="module")
def jax_tables():
    return jax_generate_ssb(sf=SF, seed=SEED)


@pytest.fixture(scope="module")
def jax_cache():
    """One ``_cached_programs`` dict for every JAX engine in this module:
    the cached-probe query programs are pure functions of their spec, so
    the JAX oracles share their compiles."""
    return {}


def _engine(base_tables) -> SSBEngine:
    return SSBEngine(dict(base_tables), device="cpu")


def _jax_engine(jax_tables, cache) -> JaxEngine:
    eng = JaxEngine(dict(jax_tables), mode="jspim")
    eng._cached_programs = cache
    return eng


def _host(x) -> np.ndarray:
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _results(eng, names):
    out = {}
    for name in names:
        total, groups = eng.run(name)
        out[name] = (int(total), _host(groups))
    return out


def _assert_same(got, want, ctx: str):
    for name in want:
        assert got[name][0] == want[name][0], (ctx, name)
        np.testing.assert_array_equal(got[name][1], want[name][1],
                                      err_msg=f"{ctx} {name}")


def _pk(base, dim) -> np.ndarray:
    return base[dim][DIM_PK[dim]].numpy()


# ---------------------------------------------------------------------------
# randomized mutation streams (pre-generated data: trial and oracle apply
# byte-identical batches, so any divergence is the durability tier's)
# ---------------------------------------------------------------------------


def _resample_rows(table, rng, n, pk_col, start_key):
    src = rng.integers(0, table.n_rows, n)
    cols = {k: table[k].numpy()[:table.n_rows][src] for k in table.names()}
    cols[pk_col] = np.arange(start_key, start_key + n, dtype=np.int32)
    return cols


def _gen_ops(base, rng):
    ops = []
    fact_key, dim_key = 5_000_000, 1_000_000
    for _ in range(int(rng.integers(5, 9))):
        kind = str(rng.choice(("fact", "upsert", "delete", "rows",
                               "compact"), p=(0.3, 0.2, 0.15, 0.2, 0.15)))
        dim = str(rng.choice(_MUT_DIMS))
        t = base[dim]
        if kind == "fact":
            ops.append(("fact", None, _resample_rows(
                base["lineorder"], rng, FACT_BATCH, "orderkey", fact_key)))
            fact_key += FACT_BATCH
        elif kind == "upsert":
            keys = _pk(base, dim)[rng.integers(0, t.n_rows, 24)]
            pays = rng.integers(0, t.n_rows, 24).astype(np.int32)
            ops.append(("upsert", dim, (keys.astype(np.int32), pays)))
        elif kind == "delete":
            keys = _pk(base, dim)[rng.integers(0, t.n_rows, 8)]
            ops.append(("delete", dim, keys.astype(np.int32)))
        elif kind == "rows":
            ops.append(("rows", dim, _resample_rows(
                t, rng, DIM_BATCH, DIM_PK[dim], dim_key)))
            dim_key += DIM_BATCH
        else:
            ops.append(("compact", dim, None))
    return ops


def _apply(eng, op):
    kind, dim, data = op
    if kind == "fact":
        eng.append_fact_rows(data)
    elif kind == "upsert":
        eng.ingest(dim, data[0], data[1], op="upsert")
    elif kind == "delete":
        eng.ingest(dim, data, op="delete")
    elif kind == "rows":
        eng.append_rows(dim, data)
    else:
        eng.compact(dim)


# ---------------------------------------------------------------------------
# WAL record format: framing, torn tails, reopen semantics
# ---------------------------------------------------------------------------


class TestWALFormat:
    def test_append_read_round_trip(self, tmp_path):
        path = str(tmp_path / "wal.log")
        wal, recovered = WriteAheadLog.open(path)
        assert recovered == []
        wal.append("ingest", 1, {"dim": "supplier", "op": "upsert"},
                   {"keys": np.arange(5, dtype=np.int32),
                    "payloads": np.arange(5, dtype=np.int32) * 2})
        wal.append("compact", 2, {"dim": "supplier"})
        wal.append("append_fact_rows", 3, {},
                   {"orderkey": np.array([7, 8], np.int32)})
        wal.close()
        recs = read_records(path)
        assert [r.kind for r in recs] == ["ingest", "compact",
                                         "append_fact_rows"]
        assert [r.epoch for r in recs] == [1, 2, 3]
        assert recs[0].meta == {"dim": "supplier", "op": "upsert"}
        np.testing.assert_array_equal(recs[0].arrays["payloads"],
                                      np.arange(5, dtype=np.int32) * 2)
        assert recs[1].arrays == {}
        assert sum(r.nbytes for r in recs) == os.path.getsize(path) - \
            len(MAGIC)

    def test_scan_survives_every_cut_point(self):
        r1 = encode_record("ingest", 1, {"dim": "part", "op": "delete"},
                           {"keys": np.arange(9, dtype=np.int32)})
        r2 = encode_record("compact", 2, {"dim": "part"})
        data = MAGIC + r1 + r2
        for cut in range(len(data) + 1):
            recs, clean = scan(data[:cut])
            if cut < len(MAGIC) + len(r1):
                assert recs == [] and clean in (0, len(MAGIC))
            elif cut < len(data):
                assert len(recs) == 1 and clean == len(MAGIC) + len(r1)
            else:
                assert len(recs) == 2 and clean == len(data)

    def test_scan_stops_at_corrupt_record(self):
        r1 = encode_record("compact", 1, {"dim": "date"})
        r2 = encode_record("compact", 2, {"dim": "date"})
        data = bytearray(MAGIC + r1 + r2)
        data[len(MAGIC) + len(r1) - 1] ^= 0xFF  # corrupt r1's payload
        recs, clean = scan(bytes(data))
        # everything after the first bad record is untrusted: r2 is NOT
        # recovered even though its own bytes are intact
        assert recs == [] and clean == len(MAGIC)

    def test_open_truncates_torn_tail_and_appends(self, tmp_path):
        path = str(tmp_path / "wal.log")
        r1 = encode_record("compact", 1, {"dim": "date"})
        r2 = encode_record("compact", 2, {"dim": "date"})
        with open(path, "wb") as f:
            f.write(MAGIC + r1 + r2[:len(r2) - 4])  # torn final record
        wal, recs = WriteAheadLog.open(path)
        assert [r.epoch for r in recs] == [1]
        assert os.path.getsize(path) == len(MAGIC) + len(r1)
        wal.append("compact", 2, {"dim": "customer"})
        wal.close()
        assert [(r.epoch, r.meta["dim"]) for r in read_records(path)] == \
            [(1, "date"), (2, "customer")]

    def test_open_rewrites_pre_magic_debris(self, tmp_path):
        path = str(tmp_path / "wal.log")
        with open(path, "wb") as f:
            f.write(b"\x01\x02\x03")  # shorter than MAGIC: no valid prefix
        wal, recs = WriteAheadLog.open(path)
        assert recs == []
        wal.append("compact", 1, {"dim": "date"})
        wal.close()
        assert len(read_records(path)) == 1

    def test_unknown_kind_rejected_at_encode(self):
        with pytest.raises(WALError, match="unknown WAL record kind"):
            encode_record("drop_table", 1)

    def test_closed_log_rejects_appends(self, tmp_path):
        wal, _ = WriteAheadLog.open(str(tmp_path / "wal.log"))
        wal.close()
        with pytest.raises(WALError, match="closed"):
            wal.append("compact", 1, {"dim": "date"})


# ---------------------------------------------------------------------------
# checkpoint-manager crash atomicity (kill between tmp-write, fsync and
# rename; the previous step keeps serving; tmp dirs are collected)
# ---------------------------------------------------------------------------


def _tree(mult: int = 1):
    return {"a": torch.arange(64, dtype=torch.int32) * mult,
            "b": np.arange(16, dtype=np.int64) * (3 * mult)}


class TestCheckpointCrashAtomicity:
    @pytest.mark.parametrize("site,nth", [
        ("ckpt_save", 1),      # killed mid first leaf write
        ("ckpt_fsync", 2),     # killed between leaf fsyncs
        ("ckpt_replace", 1),   # killed before the commit rename
    ])
    def test_crashed_save_keeps_previous_step(self, tmp_path, site, nth):
        ck = str(tmp_path)
        save(ck, 0, _tree(1), extra={"epoch": 0})
        with _checkpoint_crash_sites(_boom_on(site, nth)):
            with pytest.raises(CrashPoint):
                save(ck, 1, _tree(2), extra={"epoch": 1})
        # the aborted save never became a step; the stale tmp dir is
        # ignored by steps() and collected by the next latest_step()
        assert steps(ck) == [0]
        assert any(d.endswith(".tmp") for d in os.listdir(ck))
        assert latest_step(ck) == 0
        assert not any(d.endswith(".tmp") for d in os.listdir(ck))
        arrays, extra = load_arrays(ck, 0)
        np.testing.assert_array_equal(arrays["a"], _tree(1)["a"].numpy())
        assert extra == {"epoch": 0}
        # a retried save commits cleanly on top
        save(ck, 1, _tree(2), extra={"epoch": 1})
        assert steps(ck) == [0, 1]
        np.testing.assert_array_equal(load_arrays(ck, 1)[0]["b"],
                                      _tree(2)["b"])

    def test_restore_round_trip_verifies(self, tmp_path):
        ck = str(tmp_path)
        tree = dict(_tree(5), c=torch.arange(6, dtype=torch.float32)
                    .to(torch.bfloat16))
        save(ck, 3, tree)
        out = restore(ck, 3, dict(_tree(1), c=torch.zeros(
            6, dtype=torch.bfloat16)))
        assert torch.equal(out["a"], tree["a"])
        assert out["c"].dtype == torch.bfloat16
        assert torch.equal(out["c"], tree["c"])
        with pytest.raises(NotImplementedError, match="item 7"):
            restore(ck, 3, _tree(1), shardings={"a": None})

    def test_corrupt_leaf_names_the_leaf(self, tmp_path):
        ck = str(tmp_path)
        d = save(ck, 0, _tree())
        with open(os.path.join(d, "manifest.json")) as f:
            entry = [e for e in json.load(f)["leaves"]
                     if e["path"] == "a"][0]
        fp = os.path.join(d, entry["file"])
        blob = bytearray(open(fp, "rb").read())
        blob[-2] ^= 0xFF  # flip a data byte: the header stays parseable
        open(fp, "wb").write(bytes(blob))
        with pytest.raises(CheckpointCorruptError, match="'a'.*CRC32"):
            load_arrays(ck, 0)
        with pytest.raises(CheckpointCorruptError, match="'a'.*CRC32"):
            restore(ck, 0, _tree())
        # verification off: the corruption loads silently (the point of
        # having CRCs on by default)
        arrays, _ = load_arrays(ck, 0, verify=False)
        assert not np.array_equal(arrays["a"], _tree()["a"].numpy())

    def test_truncated_leaf_is_unreadable(self, tmp_path):
        ck = str(tmp_path)
        d = save(ck, 0, _tree())
        fp = os.path.join(d, "leaf_00000.npy")
        open(fp, "r+b").truncate(10)
        with pytest.raises(CheckpointCorruptError, match="unreadable"):
            load_arrays(ck, 0)

    def test_missing_manifest_is_corrupt(self, tmp_path):
        ck = str(tmp_path)
        d = save(ck, 0, _tree())
        os.remove(os.path.join(d, "manifest.json"))
        with pytest.raises(CheckpointCorruptError, match="manifest"):
            load_arrays(ck, 0)


# ---------------------------------------------------------------------------
# mutation-API input validation (bad batches die at the boundary with the
# argument named: replay trusts logged batches)
# ---------------------------------------------------------------------------


class TestMutationValidation:
    @pytest.fixture(scope="class")
    def veng(self, base_tables):
        return _engine(base_tables)

    def test_rejects_float_keys(self, veng):
        with pytest.raises(ValueError, match="keys: expected an integer"):
            veng.ingest("supplier", np.array([1.5, 2.5]), np.array([0, 1]))

    def test_rejects_2d_keys(self, veng):
        with pytest.raises(ValueError, match="keys: expected a 1-D"):
            veng.ingest("supplier", np.zeros((2, 2), np.int32),
                        np.array([0, 1], np.int32))

    def test_rejects_ragged_payloads(self, veng):
        with pytest.raises(ValueError, match="payloads.*ragged"):
            veng.ingest("supplier", np.array([1, 2, 3], np.int32),
                        np.array([0, 1], np.int32))

    def test_rejects_missing_payloads(self, veng):
        with pytest.raises(ValueError, match="payloads: required"):
            veng.ingest("supplier", np.array([1], np.int32), op="insert")

    def test_rejects_bad_op_and_dim(self, veng):
        with pytest.raises(ValueError, match="op: expected"):
            veng.ingest("supplier", np.array([1], np.int32),
                        np.array([0], np.int32), op="merge")
        with pytest.raises(ValueError, match="dim: unknown dimension"):
            veng.ingest("warehouse", np.array([1], np.int32),
                        np.array([0], np.int32))

    def test_rejects_int32_overflow(self, veng):
        with pytest.raises(ValueError, match="keys.*int32"):
            veng.ingest("supplier", np.array([2 ** 40], np.int64),
                        np.array([0], np.int32))

    def test_append_rows_names_bad_column(self, veng, base_tables):
        t = base_tables["supplier"]
        good = {k: np.zeros(4, np.int32) for k in t.names()}
        bad = dict(good, city=np.zeros(4, np.float32))
        with pytest.raises(ValueError, match=r"rows\['city'\]"):
            veng.append_rows("supplier", bad)
        ragged = dict(good)
        ragged[sorted(good)[-1]] = np.zeros(3, np.int32)
        with pytest.raises(ValueError, match="ragged"):
            veng.append_rows("supplier", ragged)
        with pytest.raises(ValueError, match="column mismatch"):
            veng.append_rows("supplier",
                             {k: good[k] for k in list(good)[:-1]})

    def test_append_fact_rows_names_bad_column(self, veng, base_tables):
        lo = base_tables["lineorder"]
        good = {k: np.zeros(4, np.int32) for k in lo.names()}
        bad = dict(good, orderkey=np.zeros((4, 1), np.int32))
        with pytest.raises(ValueError, match=r"rows\['orderkey'\].*1-D"):
            veng.append_fact_rows(bad)

    def test_rejections_and_empty_batches_publish_nothing(self, veng,
                                                          base_tables):
        e0 = veng.epoch
        for fn in (
            lambda: veng.ingest("supplier", np.array([0.5])),
            lambda: veng.append_rows("supplier", {"x": np.zeros(1)}),
            lambda: veng.append_fact_rows({"orderkey": np.zeros(1)}),
        ):
            with pytest.raises(ValueError):
                fn()
        # zero-row batches are strict no-ops, not epoch bumps
        veng.ingest("supplier", np.array([], np.int32),
                    np.array([], np.int32))
        lo = base_tables["lineorder"]
        veng.append_fact_rows({k: np.array([], np.int32)
                               for k in lo.names()})
        veng.append_rows("supplier",
                         {k: np.array([], np.int32)
                          for k in base_tables["supplier"].names()})
        assert veng.epoch == e0


# ---------------------------------------------------------------------------
# deterministic recovery paths (each also held against the JAX package)
# ---------------------------------------------------------------------------


class TestRecovery:
    def test_round_trip_recovers_every_mutation_kind(
            self, base_tables, jax_tables, jax_cache, tmp_path):
        root = str(tmp_path / "d")
        eng = _engine(base_tables)
        mgr = eng.persist(root)
        jax_eng = _jax_engine(jax_tables, jax_cache)
        for op in _gen_ops(base_tables, np.random.default_rng(0)):
            _apply(eng, op)
            _apply(jax_eng, op)
        live = _results(eng, _ALL_QUERIES)
        epoch, fact_epoch = eng.epoch, eng.fact_epoch
        assert (epoch, fact_epoch) == (jax_eng.epoch, jax_eng.fact_epoch)
        assert mgr.records_logged == epoch  # one record per published epoch
        eng.close()
        rec = SSBEngine.open(root, device="cpu")
        assert (rec.epoch, rec.fact_epoch) == (epoch, fact_epoch)
        assert rec.durability is not None
        got = _results(rec, _ALL_QUERIES)
        _assert_same(got, live, "round-trip")
        _assert_same(got, _results(jax_eng, _ALL_QUERIES),
                     "round-trip against the JAX engine")
        rec.close()

    def test_recovered_engine_keeps_ingesting_durably(
            self, base_tables, jax_tables, jax_cache, tmp_path):
        root = str(tmp_path / "d")
        eng = _engine(base_tables)
        eng.persist(root)
        sup = _pk(base_tables, "supplier")
        eng.ingest("supplier", sup[:5], np.arange(5, dtype=np.int32))
        eng.close()
        mid = SSBEngine.open(root, device="cpu")
        mid.ingest("supplier", sup[5:9], op="delete")  # logged post-recovery
        want = _results(mid, ("Q3.1", "Q4.1"))
        mid.close()
        rec = SSBEngine.open(root, device="cpu")
        assert rec.epoch == 2
        got = _results(rec, ("Q3.1", "Q4.1"))
        _assert_same(got, want, "re-recovered")
        jax_eng = _jax_engine(jax_tables, jax_cache)
        jax_eng.ingest("supplier", sup[:5], np.arange(5, dtype=np.int32))
        jax_eng.ingest("supplier", sup[5:9], op="delete")
        _assert_same(got, _results(jax_eng, ("Q3.1", "Q4.1")),
                     "re-recovered against the JAX engine")
        rec.close()

    def test_torn_wal_tail_degrades_to_last_full_record(
            self, base_tables, jax_tables, jax_cache, tmp_path):
        root = str(tmp_path / "d")
        eng = _engine(base_tables)
        eng.persist(root, auto_checkpoint=False)
        sup = _pk(base_tables, "supplier")
        for i in range(3):
            eng.ingest("supplier", sup[i * 6:(i + 1) * 6],
                       np.full(6, i, np.int32))
        eng.close()
        wal_path = os.path.join(root, WAL_NAME)
        size = os.path.getsize(wal_path)
        open(wal_path, "r+b").truncate(size - 5)   # tear the final record
        with open(wal_path, "ab") as f:
            f.write(b"\x99" * 17)                  # plus writeback debris
        rec = SSBEngine.open(root, device="cpu")
        assert rec.epoch == 2
        oracle = _engine(base_tables)
        jax_eng = _jax_engine(jax_tables, jax_cache)
        for e in (oracle, jax_eng):
            for i in range(2):
                e.ingest("supplier", sup[i * 6:(i + 1) * 6],
                         np.full(6, i, np.int32))
        got = _results(rec, ("Q3.1", "Q4.1"))
        _assert_same(got, _results(oracle, ("Q3.1", "Q4.1")), "torn-tail")
        _assert_same(got, _results(jax_eng, ("Q3.1", "Q4.1")),
                     "torn-tail against the JAX engine")
        rec.close()

    def test_corrupt_checkpoint_falls_back_then_errors(
            self, base_tables, jax_tables, jax_cache, tmp_path):
        root = str(tmp_path / "d")
        eng = _engine(base_tables)
        mgr = eng.persist(root, auto_checkpoint=False)
        sup = _pk(base_tables, "supplier")
        eng.ingest("supplier", sup[:5], np.arange(5, dtype=np.int32))
        mgr.checkpoint(eng)
        eng.ingest("supplier", sup[5:8], op="delete")
        live = _results(eng, ("Q3.1", "Q4.1"))
        epoch = eng.epoch
        eng.close()
        ck = os.path.join(root, CKPT_SUBDIR)
        assert steps(ck) == [0, 1]  # genesis + explicit

        def corrupt(step):
            d = os.path.join(ck, f"step_{step:08d}")
            leaf = max((f for f in os.listdir(d) if f.endswith(".npy")),
                       key=lambda f: os.path.getsize(os.path.join(d, f)))
            fp = os.path.join(d, leaf)
            blob = bytearray(open(fp, "rb").read())
            blob[-3] ^= 0xFF
            open(fp, "wb").write(bytes(blob))

        corrupt(1)
        rec = SSBEngine.open(root, device="cpu")  # newest fails: back to 0
        assert rec.durability.last_ckpt_epoch == 0
        assert rec.epoch == epoch    # the longer replay still lands at head
        got = _results(rec, ("Q3.1", "Q4.1"))
        _assert_same(got, live, "ckpt-fallback")
        jax_eng = _jax_engine(jax_tables, jax_cache)
        jax_eng.ingest("supplier", sup[:5], np.arange(5, dtype=np.int32))
        jax_eng.ingest("supplier", sup[5:8], op="delete")
        _assert_same(got, _results(jax_eng, ("Q3.1", "Q4.1")),
                     "ckpt-fallback against the JAX engine")
        rec.close()
        corrupt(0)
        with pytest.raises(RecoveryError, match="failed verification"):
            SSBEngine.open(root, device="cpu")

    def test_open_requires_a_durability_root(self, tmp_path):
        with pytest.raises(RecoveryError, match="no checkpoint"):
            SSBEngine.open(str(tmp_path / "nothing"), device="cpu")

    def test_create_refuses_existing_root(self, base_tables, tmp_path):
        root = str(tmp_path / "d")
        eng = _engine(base_tables)
        eng.persist(root)
        eng.close()
        with pytest.raises(ValueError, match="already holds"):
            _engine(base_tables).persist(root)

    def test_raw_updates_refused_while_durable(self, base_tables, tmp_path):
        eng = _engine(base_tables)
        eng.persist(str(tmp_path / "d"))
        tbl = eng.indexes["supplier"].table
        for fn in (lambda: eng.index_update("supplier", 1, 0),
                   lambda: eng.entry_update("supplier", 0, 0, 1, 0),
                   lambda: eng.table_update("supplier", [0],
                                            tbl.keys[:1].clone(),
                                            tbl.values[:1].clone())):
            with pytest.raises(RuntimeError, match="outside the WAL mandate"):
                fn()
        assert eng.epoch == 0
        with eng.snapshot() as snap:
            eng.close()
            eng.close()                  # idempotent
            assert eng.closed and eng.durability is None
            # a closed engine refuses every mutation with a clear error
            sup = _pk(base_tables, "supplier")
            rows = {k: v.numpy()[:2] for k, v in
                    base_tables["supplier"].columns.items()}
            lo = base_tables["lineorder"]
            for fn in (lambda: eng.index_update("supplier", 1, 0),
                       lambda: eng.ingest("supplier",
                                          np.array([1], np.int32),
                                          np.array([0], np.int32)),
                       lambda: eng.append_rows("supplier", rows),
                       lambda: eng.append_fact_rows(
                           {k: v.numpy()[:4] for k, v in
                            lo.columns.items()}),
                       lambda: eng.compact("supplier"),
                       lambda: eng.prepare_compact("supplier"),
                       lambda: eng.persist(str(tmp_path / "e"))):
                with pytest.raises(RuntimeError, match="closed"):
                    fn()
            assert sup.shape[0] > 0 and eng.epoch == 0
            # ...but keeps serving queries, and so does a held snapshot
            total, _ = eng.run("Q1.1")
            assert int(total) == int(eng.run("Q1.1")[0])
            assert int(snap.run("Q1.1")[0]) == int(total)

    def test_cost_model_trigger_takes_mid_stream_checkpoints(
            self, base_tables, jax_tables, jax_cache, tmp_path):
        root = str(tmp_path / "d")
        eng = _engine(base_tables)
        mgr = eng.persist(root, min_log_bytes=1024, safety=0.05)
        jax_eng = _jax_engine(jax_tables, jax_cache)
        jmgr = jax_eng.persist(str(tmp_path / "j"), min_log_bytes=1024,
                               safety=0.05)
        assert mgr.checkpoint_plan(eng).reason == "log_small"
        rng = np.random.default_rng(3)
        for i in range(2):
            op = ("fact", None, _resample_rows(
                base_tables["lineorder"], rng, FACT_BATCH, "orderkey",
                6_000_000 + i * FACT_BATCH))
            _apply(eng, op)
            _apply(jax_eng, op)
            # the same decisions as the JAX package, at the same epochs
            assert (mgr.checkpoints_taken, mgr.last_ckpt_epoch) == \
                (jmgr.checkpoints_taken, jmgr.last_ckpt_epoch)
        assert mgr.checkpoints_taken >= 2   # genesis + >=1 triggered
        assert mgr.last_ckpt_epoch and mgr.last_ckpt_epoch > 0
        eng.close()
        rec = SSBEngine.open(root, device="cpu")
        # recovery resumed from the triggered checkpoint, not genesis
        assert rec.durability.last_ckpt_epoch > 0
        assert rec.durability.records_since_ckpt < 2
        _assert_same(_results(rec, ("Q1.1", "Q4.3")),
                     _results(jax_eng, ("Q1.1", "Q4.3")),
                     "triggered checkpoint against the JAX engine")
        rec.close()
        jax_eng.close()

    def test_record_durable_but_unpublished_replays(
            self, base_tables, jax_tables, jax_cache, tmp_path):
        """The kill point between the WAL append and the epoch publish."""
        rng = np.random.default_rng(11)
        fs = FailpointFS(rng)
        root = str(tmp_path / "d")
        eng = _engine(base_tables)
        DurabilityManager.create(root, eng, fs=fs)
        sup = _pk(base_tables, "supplier")
        # WAL ops: magic write/fsync = 0/1, record N = ops 2N/2N+1; arm
        # the second record's fsync in "after" mode: durable on disk,
        # process dead before the engine publishes epoch 2
        fs.arm(5, "after")
        eng.ingest("supplier", sup[:4], np.arange(4, dtype=np.int32))
        with pytest.raises(CrashPoint):
            eng.ingest("supplier", sup[4:8], op="delete")
        assert eng.epoch == 1            # never published in the dead proc
        fs.disarm()
        rec = SSBEngine.open(root, fs=fs, device="cpu")
        assert rec.epoch == 2            # ...but recovery replays it
        oracle = _engine(base_tables)
        jax_eng = _jax_engine(jax_tables, jax_cache)
        for e in (oracle, jax_eng):
            e.ingest("supplier", sup[:4], np.arange(4, dtype=np.int32))
            e.ingest("supplier", sup[4:8], op="delete")
        got = _results(rec, ("Q3.1", "Q4.1"))
        _assert_same(got, _results(oracle, ("Q3.1", "Q4.1")),
                     "ahead-of-publish")
        _assert_same(got, _results(jax_eng, ("Q3.1", "Q4.1")),
                     "ahead-of-publish against the JAX engine")
        rec.close()


# ---------------------------------------------------------------------------
# recovery under load: old-incarnation snapshots and replay-time readers
# ---------------------------------------------------------------------------


class TestRecoveryUnderLoad:
    def test_open_while_scheduler_pins_previous_incarnation(
            self, base_tables, tmp_path):
        """``SSBEngine.open`` on a root whose previous incarnation still
        has snapshots pinned by a serving scheduler: recovery neither
        waits on nor corrupts the old pins, which keep answering their
        epoch while the recovered engine moves ahead."""
        from repro_torch.serving import (PARAM_QUERIES, BatchRunner,
                                         QueryScheduler, ServeConfig)

        root = str(tmp_path / "d")
        eng = _engine(base_tables)
        eng.persist(root)
        for op in _gen_ops(base_tables, np.random.default_rng(31)):
            _apply(eng, op)
        sched = QueryScheduler(eng, ServeConfig())
        t0 = sched.submit("Q2.1")
        sched.pump()
        want = (t0.response.total, np.asarray(t0.response.groups))
        pinned_epoch = t0.response.epoch
        eng.close()   # the incarnation dies; the scheduler's pin survives
        rec = SSBEngine.open(root, device="cpu")
        assert rec.epoch == eng.epoch
        # the old pin serves bit-identically while the new incarnation
        # mutates past it
        rec.ingest("supplier", _pk(base_tables, "supplier")[:6],
                   op="delete")
        t1 = sched.submit("Q2.1")
        sched.pump()
        assert t1.response.status == "ok"
        assert t1.response.epoch == pinned_epoch
        assert t1.response.total == want[0]
        np.testing.assert_array_equal(np.asarray(t1.response.groups),
                                      want[1])
        # cut over to the recovered incarnation: fresh serving, no lag
        sched.rebind(rec)
        t2 = sched.submit("Q2.1")
        sched.pump()
        assert t2.response.epoch == rec.epoch
        assert not t2.response.stale
        ref_t, _ = rec.run("Q2.1")
        got_t, _ = BatchRunner().run_batch(
            rec, "Q2.1", [PARAM_QUERIES["Q2.1"].defaults])[0]
        assert t2.response.total == got_t == int(ref_t)
        sched.close()
        rec.close()

    def test_wal_replay_races_concurrent_reader(self, base_tables,
                                                tmp_path):
        """A reader hammering an old-incarnation snapshot while
        ``SSBEngine.open`` replays the WAL in another thread: every read
        during the race is bit-identical to the pre-crash answer (replay
        builds private state; it never writes into pinned buffers)."""
        import threading

        root = str(tmp_path / "d")
        eng = _engine(base_tables)
        eng.persist(root)
        for op in _gen_ops(base_tables, np.random.default_rng(37)):
            _apply(eng, op)
        snap = eng.snapshot()
        want = _results(snap, ("Q1.1", "Q3.2"))
        eng.close()

        diverged = []
        stop = threading.Event()

        def reader():
            while not stop.is_set():
                got = _results(snap, ("Q1.1", "Q3.2"))
                for name in want:
                    if (got[name][0] != want[name][0]
                            or not np.array_equal(got[name][1],
                                                  want[name][1])):
                        diverged.append(name)
                        return

        rt = threading.Thread(target=reader)
        rt.start()
        try:
            rec = SSBEngine.open(root, device="cpu")
        finally:
            stop.set()
            rt.join(timeout=60.0)
        assert not diverged, f"reader diverged during replay: {diverged}"
        _assert_same(_results(rec, ("Q1.1", "Q3.2")), want,
                     "post-race recovery")
        snap.release()
        rec.close()


# ---------------------------------------------------------------------------
# the randomized crash-injection harness
# ---------------------------------------------------------------------------

N_TRIALS = 56


def _rand_mode(rng) -> str:
    return str(rng.choice(("before", "partial", "after")))


def _trial_queries(seed: int) -> list[str]:
    if seed % 6 == 0:
        return _ALL_QUERIES
    return [_ALL_QUERIES[(seed + 3 * j) % len(_ALL_QUERIES)]
            for j in range(4)]


def _run_trial(seed, base, tmp):
    rng = np.random.default_rng(10_000 + seed)
    ops = _gen_ops(base, rng)
    n_sem = sum(1 for o in ops if o[0] != "compact")
    fs = FailpointFS(rng)
    root = os.path.join(tmp, f"trial_{seed:03d}")
    eng = _engine(base)
    DurabilityManager.create(root, eng, fs=fs, min_log_bytes=4096,
                             safety=0.05)
    # genesis is durable before arming: recovery always has a floor
    u = float(rng.random())
    if u < 0.45:       # WAL syscalls: mid-record writes, pre/post fsync
        fs.arm(int(rng.integers(0, int(2.2 * len(ops)) + 2)),
               _rand_mode(rng))
    elif u < 0.80:     # anywhere, including deep inside checkpoint bursts
        fs.arm(int(rng.integers(0, 500)), _rand_mode(rng))
    elif u < 0.92:     # aimed at the checkpoint writer's leaf I/O
        fs.arm(int(rng.integers(0, 80)), _rand_mode(rng), site="ckpt_")
    else:              # aimed at the commit rename itself
        fs.arm(0, _rand_mode(rng), site="ckpt_replace")
    crashed = False
    with _checkpoint_crash_sites(fs.hit):
        try:
            for op in ops:
                _apply(eng, op)
        except CrashPoint:
            crashed = True
    site = fs.crashed_at[1] if crashed else None
    fs.disarm()
    if not crashed:
        eng.close()
    del eng  # the dead process: nothing of it may reach recovery

    rec = SSBEngine.open(root, fs=fs, device="cpu")
    survivors = read_records(os.path.join(root, WAL_NAME), fs)
    assert rec.epoch == len(survivors)   # every record replays exactly once
    S = sum(1 for r in survivors if r.kind in SEMANTIC_KINDS)
    assert S <= n_sem
    if not crashed:
        assert S == n_sem                # a clean run loses nothing

    # oracle: an uninterrupted volatile engine over exactly the surviving
    # semantic prefix; compaction is result-invisible, so it skips them
    oracle = _engine(base)
    applied = 0
    for op in ops:
        if op[0] == "compact":
            continue
        if applied == S:
            break
        _apply(oracle, op)
        applied += 1
    assert applied == S

    names = _trial_queries(seed)
    ctx = f"seed={seed} site={site} mode={fs.mode} S={S}/{n_sem}"
    _assert_same(_results(rec, names), _results(oracle, names), ctx)

    if seed % 4 == 0 and S < n_sem:
        # the recovered engine must keep ingesting: replay the lost
        # semantic suffix into both sides and compare again
        k = 0
        for op in ops:
            if op[0] == "compact":
                continue
            if k >= S:
                _apply(rec, op)
                _apply(oracle, op)
            k += 1
        _assert_same(_results(rec, names[:2]), _results(oracle, names[:2]),
                     ctx + " resumed")
    rec.close()
    return crashed, site


def test_randomized_crash_recovery_bit_identical(base_tables, tmp_path):
    stats = [_run_trial(seed, base_tables, str(tmp_path))
             for seed in range(N_TRIALS)]
    sites = {s for crashed, s in stats if crashed}
    n_crashed = sum(1 for crashed, _ in stats if crashed)
    # the sweep must have exercised the interesting kill points: torn and
    # unsynced WAL writes, fsync boundaries, and checkpoint-writer
    # syscalls, plus enough clean runs to prove the harness can pass
    assert n_crashed >= 15, (n_crashed, sites)
    assert N_TRIALS - n_crashed >= 5, (n_crashed, sites)
    assert "write" in sites and "fsync" in sites, sites
    assert any(s.startswith("ckpt_") for s in sites), sites


def test_os_fs_is_the_default_seam(tmp_path):
    """``OsFS`` is what a manager writes through when given no fs, and its
    crash-site marker is a no-op."""
    fs = OsFS()
    fs.hit("ckpt_save")
    wal, _ = WriteAheadLog.open(str(tmp_path / "wal.log"))
    assert isinstance(wal.fs, OsFS)
    wal.close()
