"""Byte compatibility of the durability tier across the two packages.

A JAX engine and a port engine (CPU) on the same SSB tables (sf 0.001)
are made durable and take the same seeded stream of fact appends,
dimension upserts, deletes and appends, auto-compacting ingests and
explicit compactions, with a checkpoint trigger low enough to fire
mid-stream, then a tail of four mutations with the trigger off.  Then:

* after every mutation both report the same epochs, the same
  ``state_nbytes``, the same ``plan_checkpoint`` decision and the same
  manager counters;
* the two ``wal.log`` files are byte-identical;
* the two checkpoint stores hold the same steps, each with the same
  manifest entries (path, file, dtype, shape, crc32), the same ``extra``
  after JSON parsing, and byte-identical ``.npy`` leaves: the index
  planes (dictionary, hash table, delta) of both packages are the same
  bucket for bucket;
* a root written by the JAX package recovers in the port
  (``device="cpu"``) and one written by the port recovers in the JAX
  package, each landing at the same epoch with a ``run_all``
  bit-identical to the other package's live engine.
"""
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from repro.durability import state_nbytes as jax_state_nbytes
from repro.engine import SSBEngine as JaxEngine
from repro.engine import generate_ssb as jax_generate_ssb
from repro_torch.durability import read_records, state_nbytes
from repro_torch.durability.manager import CKPT_SUBDIR, WAL_NAME
from repro_torch.engine import SSBEngine, generate_ssb
from repro_torch.engine.queries import DIM_PK

SF = 0.001
SEED = 7
FACT_BATCH = 256
DIM_BATCH = 16
TRIGGER = {"min_log_bytes": 1024, "safety": 0.05}
# mutations from this one on take no checkpoint
TAIL_FROM = 14


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


def _stream(tables, rng):
    """A seeded mutation stream over host copies of the port's tables."""
    host = {n: {k: v.numpy() for k, v in t.columns.items()}
            for n, t in tables.items()}
    ops = []
    fact_key, dim_key = 5_000_000, 1_000_000
    for i in range(18):
        kind = ("fact", "upsert", "delete", "rows", "auto_upsert",
                "compact", "fact")[i % 7]
        dim = ("customer", "supplier", "part")[i % 3]
        pk = host[dim][DIM_PK[dim]]
        if kind == "fact":
            src = rng.integers(0, host["lineorder"]["orderkey"].shape[0],
                               FACT_BATCH)
            cols = {k: v[src] for k, v in host["lineorder"].items()}
            cols["orderkey"] = np.arange(fact_key, fact_key + FACT_BATCH,
                                         dtype=np.int32)
            fact_key += FACT_BATCH
            ops.append(("fact", None, cols))
        elif kind in ("upsert", "auto_upsert"):
            n = 24 if kind == "upsert" else pk.shape[0] // 2
            keys = pk[rng.integers(0, pk.shape[0], n)].astype(np.int32)
            pays = rng.integers(0, pk.shape[0], n).astype(np.int32)
            ops.append((kind, dim, (keys, pays)))
        elif kind == "delete":
            ops.append(("delete", dim,
                        pk[rng.integers(0, pk.shape[0], 8)].astype(np.int32)))
        elif kind == "rows":
            src = rng.integers(0, pk.shape[0], DIM_BATCH)
            cols = {k: v[src] for k, v in host[dim].items()}
            cols[DIM_PK[dim]] = np.arange(dim_key, dim_key + DIM_BATCH,
                                          dtype=np.int32)
            dim_key += DIM_BATCH
            ops.append(("rows", dim, cols))
        else:
            ops.append(("compact", dim, None))
    return ops


def _apply(eng, op):
    kind, dim, data = op
    if kind == "fact":
        eng.append_fact_rows({k: v.copy() for k, v in data.items()})
    elif kind == "upsert":
        eng.ingest(dim, data[0], data[1], op="upsert", auto_compact=False)
    elif kind == "auto_upsert":  # the planner may fold: a nested compact
        eng.ingest(dim, data[0], data[1], op="upsert")
    elif kind == "delete":
        eng.ingest(dim, data, op="delete", auto_compact=False)
    elif kind == "rows":
        eng.append_rows(dim, {k: v.copy() for k, v in data.items()})
    else:
        eng.compact(dim)


def _answers(results):
    return {q: (int(t), np.asarray(g.numpy() if torch.is_tensor(g) else g))
            for q, (t, g) in results.items()}


def _assert_same(got, want, ctx):
    assert sorted(got) == sorted(want)
    for q in want:
        assert got[q][0] == want[q][0], (ctx, q)
        np.testing.assert_array_equal(got[q][1], want[q][1],
                                      err_msg=f"{ctx} {q}")


@pytest.fixture(scope="module")
def streamed(tmp_path_factory):
    """Both packages' durable engines after the same stream, their roots,
    and the per-mutation observations."""
    base = tmp_path_factory.mktemp("compat")
    ptables = generate_ssb(SF, seed=SEED, device="cpu")
    jtables = jax_generate_ssb(sf=SF, seed=SEED)
    port = SSBEngine(dict(ptables), device="cpu")
    jeng = JaxEngine(dict(jtables), mode="jspim")
    proot, jroot = str(base / "port"), str(base / "jax")
    pm = port.persist(proot, **TRIGGER)
    jm = jeng.persist(jroot, **TRIGGER)
    steps = []
    for i, op in enumerate(_stream(ptables, np.random.default_rng(SEED))):
        if i == TAIL_FROM:  # the tail stays in the log: recovery replays it
            pm.auto_checkpoint = jm.auto_checkpoint = False
        _apply(port, op)
        _apply(jeng, op)
        steps.append({
            "op": op[:2],
            "epochs": ((port.epoch, port.fact_epoch),
                       (jeng.epoch, jeng.fact_epoch)),
            "nbytes": (state_nbytes(port), jax_state_nbytes(jeng)),
            "plan": (dataclasses.asdict(pm.checkpoint_plan(port)),
                     dataclasses.asdict(jm.checkpoint_plan(jeng))),
            "info": (pm.info(), jm.info())})
    live = (_answers(port.run_all()), _answers(jeng.run_all()))
    epochs = (port.epoch, jeng.epoch)
    port.close()
    jeng.close()
    return {"proot": proot, "jroot": jroot, "steps": steps, "live": live,
            "epochs": epochs, "base": base}


def test_the_stream_covers_every_record_kind(streamed):
    recs = read_records(os.path.join(streamed["proot"], WAL_NAME))
    assert {r.kind for r in recs} == {"ingest", "append_rows",
                                      "append_fact_rows", "compact"}
    # an auto-compaction inside a mutation logged its own record
    explicit = sum(st["op"][0] == "compact" for st in streamed["steps"])
    assert sum(r.kind == "compact" for r in recs) > explicit
    info = streamed["steps"][-1]["info"][0]
    assert info["checkpoints_taken"] >= 3  # genesis + triggered ones


def test_epochs_sizes_and_decisions_agree_along_the_stream(streamed):
    for i, st in enumerate(streamed["steps"]):
        ctx = f"after mutation {i} {st['op']}"
        assert st["epochs"][0] == st["epochs"][1], ctx
        assert st["nbytes"][0] == st["nbytes"][1], ctx
        assert st["plan"][0] == st["plan"][1], ctx
        assert st["info"][0] == st["info"][1], ctx


def test_wal_files_are_byte_identical(streamed):
    with open(os.path.join(streamed["proot"], WAL_NAME), "rb") as f:
        pbytes = f.read()
    with open(os.path.join(streamed["jroot"], WAL_NAME), "rb") as f:
        jbytes = f.read()
    assert len(pbytes) > 8
    assert pbytes == jbytes


def test_checkpoints_are_byte_identical(streamed):
    pck = os.path.join(streamed["proot"], CKPT_SUBDIR)
    jck = os.path.join(streamed["jroot"], CKPT_SUBDIR)
    assert sorted(os.listdir(pck)) == sorted(os.listdir(jck))
    assert len(os.listdir(pck)) >= 2
    for step in sorted(os.listdir(pck)):
        with open(os.path.join(pck, step, "manifest.json")) as f:
            pm = json.load(f)
        with open(os.path.join(jck, step, "manifest.json")) as f:
            jm = json.load(f)
        assert pm["step"] == jm["step"]
        assert pm["extra"] == jm["extra"], step
        assert pm["leaves"] == jm["leaves"], step
        paths = [e["path"] for e in pm["leaves"]]
        assert any(p.startswith("indexes.") and ".dl_" in p
                   for p in paths) or step == "step_00000000"
        for e in pm["leaves"]:
            with open(os.path.join(pck, step, e["file"]), "rb") as f:
                pb = f.read()
            with open(os.path.join(jck, step, e["file"]), "rb") as f:
                jb = f.read()
            assert pb == jb, (step, e["path"])


def _copy_root(streamed, which, name):
    dst = str(streamed["base"] / name)
    shutil.copytree(streamed[which], dst)
    return dst


def test_a_jax_root_recovers_in_the_port(streamed):
    root = _copy_root(streamed, "jroot", "jax_into_port")
    rec = SSBEngine.open(root, device="cpu")
    assert rec.epoch == streamed["epochs"][1]
    assert rec.durability.recovery["records_replayed"] > 0
    _assert_same(_answers(rec.run_all()), streamed["live"][1],
                 "JAX root recovered in the port")
    rec.close()


def test_a_port_root_recovers_in_jax(streamed):
    root = _copy_root(streamed, "proot", "port_into_jax")
    rec = JaxEngine.open(root)
    assert rec.epoch == streamed["epochs"][0]
    _assert_same(_answers(rec.run_all()), streamed["live"][0],
                 "port root recovered in the JAX package")
    rec.close()


def test_the_port_exports_the_reference_names():
    import repro.durability as jdur
    import repro_torch.core as pcore
    import repro_torch.durability as pdur

    assert set(jdur.__all__) <= set(pdur.__all__)
    assert all(hasattr(pdur, n) for n in jdur.__all__)
    assert {"CheckpointPlan", "plan_checkpoint"} <= set(pcore.__all__)
    for name in ("persist", "open", "close", "closed", "durability"):
        assert hasattr(SSBEngine, name), name
