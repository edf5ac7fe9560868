"""The port's sharded probe against the JAX package's single-device probe.

``tests/test_sharded_probe.py``'s cases, in-process: the port's
``sharded_lookup`` over 2 and 4 shard regions (``launch/mesh.py``) on the
CPU, each held against ``repro.engine.lookup`` on one device over the same
numpy keys: plain, hot/cold, with a live delta, over a capacity-padded
fact column after an append, and from a pinned snapshot while the head
appends, ingests and swap-compacts.  All arithmetic is int32: every
comparison is exact.
"""
import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.engine import SSBEngine as JaxEngine
from repro.engine import build_dim_index as jax_build_dim_index
from repro.engine import generate_ssb as jax_generate_ssb
from repro.engine import ingest_index as jax_ingest_index
from repro.engine import lookup as jax_lookup
from repro_torch.core import encode, plan_probe, top_keys
from repro_torch.core.hash_table import EMPTY_KEY
from repro_torch.engine import (SSBEngine, build_dim_index, generate_ssb,
                                ingest_index, sharded_lookup)
from repro_torch.engine.join import sharded_probe_program
from repro_torch.launch import make_data_mesh

SF = 0.01
DIMS = {"part": ("partkey", "partkey"), "date": ("datekey", "orderdate")}


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
    return generate_ssb(SF, seed=0, device="cpu")


@pytest.fixture(scope="module")
def jtables():
    return jax_generate_ssb(sf=SF, seed=0)


def _np(x):
    return np.asarray(x.cpu().numpy() if hasattr(x, "cpu") else x)


def _same_probe(got, ref, with_dup=True):
    """``got`` (port, sharded) equals ``ref`` (JAX, one device): found
    everywhere, payload and is_dup where found."""
    f = np.asarray(ref.found)
    ok = (np.array_equal(f, _np(got.found))
          and np.array_equal(np.asarray(ref.payload)[f],
                             _np(got.payload)[f]))
    if with_dup:
        ok = ok and np.array_equal(np.asarray(ref.is_dup)[f],
                                   _np(got.is_dup)[f])
    return ok


@pytest.mark.parametrize("key", ["2dev_part", "2dev_date",
                                 "4dev_part", "4dev_date"])
def test_sharded_probe_matches_single_device(tables, jtables, key):
    ndev, dim = int(key[0]), key.split("_")[1]
    pk, fk_col = DIMS[dim]
    mesh = make_data_mesh(ndev, device="cpu")
    idx = build_dim_index(tables[dim][pk])
    jidx = jax_build_dim_index(jtables[dim][pk])
    # odd length: the last region takes EMPTY_KEY padding
    fk = tables["lineorder"][fk_col][:12_345]
    got = sharded_lookup(idx, fk, mesh)
    ref = jax_lookup(jidx, jtables["lineorder"][fk_col][:12_345])
    assert got.found.shape == (12_345,)
    assert _same_probe(got, ref)
    # misses carry payload -1, the engine's cached-probe form
    assert (_np(got.payload)[~_np(got.found)] == -1).all()


def test_sharded_probe_output_stays_sharded(tables):
    """The raw sharded probe spans ``ndev x shard`` lanes, one region a
    shard, and its padding lanes are dead (found False, payload -1)."""
    mesh = make_data_mesh(4, device="cpu")
    idx = build_dim_index(tables["part"]["partkey"])
    fk = tables["lineorder"]["partkey"][:12_345]
    padded = np.concatenate([_np(fk), np.full(3, EMPTY_KEY, np.int32)])
    raw = sharded_probe_program(mesh, "data", None, 0)(
        idx, None, torch.from_numpy(padded))
    assert raw.found.shape == (4 * 3087,)
    assert not _np(raw.found)[12_345:].any()
    assert (_np(raw.payload)[12_345:] == -1).all()
    got = sharded_lookup(idx, fk, mesh)
    assert np.array_equal(_np(raw.found)[:12_345], _np(got.found))


@pytest.mark.parametrize("key", ["hot_cold_part", "hot_cold_date"])
def test_sharded_hot_cold_matches_single_device(tables, jtables, key):
    """A shared hot table and per-shard cold remainders equal the
    unsharded probe."""
    dim = key.split("_")[-1]
    pk, fk_col = DIMS[dim]
    mesh = make_data_mesh(4, device="cpu")
    fk = tables["lineorder"][fk_col][:10_001]
    idx = build_dim_index(tables[dim][pk], fact_keys=fk)
    st = idx.stats
    plan = plan_probe(st.fact_skew, bucket_width=st.bucket_width,
                      code_space=st.n_unique, force="hot_cold")
    if plan.full_map and dim == "date":
        # the partial-hot path too: shrink to a top-k hot set
        plan = dataclasses.replace(plan, full_map=False, hot_entries=256,
                                   hot_slots=512, cold_capacity=4096)
    if plan.full_map:
        hot = torch.arange(plan.hot_entries, dtype=torch.int32)
    else:
        hot = encode(idx.dictionary, torch.as_tensor(
            top_keys(_np(fk), plan.hot_entries)))
    got = sharded_lookup(idx, fk, mesh, plan=plan, hot_codes=hot)
    jidx = jax_build_dim_index(jtables[dim][pk])
    ref = jax_lookup(jidx, jtables["lineorder"][fk_col][:10_001])
    assert _same_probe(got, ref, with_dup=False)


def test_sharded_delta_overlay_matches_single_device(tables, jtables):
    """A shared delta buffer and split fact keys equal the unsharded
    probe: inserted keys resolve, tombstoned ones miss."""
    mesh = make_data_mesh(4, device="cpu")
    n_part = int(tables["part"].n_rows)
    new_keys = np.arange(10**6, 10**6 + 500, dtype=np.int32)
    new_rows = np.arange(n_part, n_part + 500, dtype=np.int32)
    dead = _np(tables["part"]["partkey"])[:100]
    idx = build_dim_index(tables["part"]["partkey"])
    idx = ingest_index(idx, new_keys, new_rows, op="insert")
    idx = ingest_index(idx, dead, op="delete")
    jidx = jax_build_dim_index(jtables["part"]["partkey"])
    jidx = jax_ingest_index(jidx, jnp.asarray(new_keys),
                            jnp.asarray(new_rows), op="insert")
    jidx = jax_ingest_index(jidx, jnp.asarray(dead), op="delete")
    fk = np.concatenate([_np(tables["lineorder"]["partkey"])[:8_001],
                         new_keys])
    got = sharded_lookup(idx, torch.from_numpy(fk), mesh)
    ref = jax_lookup(jidx, jnp.asarray(fk))
    found = _np(got.found)
    assert _same_probe(got, ref)
    assert found[-500:].all()
    assert not found[:8_001][np.isin(fk[:8_001], dead)].any()


def _batch(lo, src, base):
    b = {k: _np(lo[k])[src] for k in lo.names()}
    b["orderkey"] = np.arange(base, base + src.shape[0], dtype=np.int32)
    return b


@pytest.fixture(scope="module")
def appended(tables, jtables):
    """A port and a JAX engine, probes cached, after the same 700-row
    fact append (the port's column is capacity-padded)."""
    eng = SSBEngine(dict(tables), device="cpu")
    jeng = JaxEngine(dict(jtables))
    eng.warm_cache()
    jeng.warm_cache()
    n0 = eng.tables["lineorder"].n_rows
    rng = np.random.default_rng(0)
    src = rng.integers(0, n0, 700)
    batch = _batch(tables["lineorder"], src, 10**7)
    eng.append_fact_rows({k: v.copy() for k, v in batch.items()})
    jeng.append_fact_rows({k: v.copy() for k, v in batch.items()})
    return eng, jeng, src


def test_sharded_fact_append_matches_single_device(appended):
    """The sharded probe over the capacity-padded fact column equals the
    JAX probe over the same keys and the engine's tail-extended cache;
    capacity padding never joins."""
    eng, jeng, _ = appended
    mesh = make_data_mesh(4, device="cpu")
    fkp = eng.tables["lineorder"]["partkey"]
    got = sharded_lookup(eng.indexes["part"], fkp, mesh)
    ref = jax_lookup(jeng.indexes["part"], jnp.asarray(_np(fkp)))
    f = np.asarray(ref.found)
    cf, cr = eng._probe_cache["part"]
    assert _same_probe(got, ref)
    assert np.array_equal(f, _np(cf))
    assert np.array_equal(np.asarray(ref.payload)[f], _np(cr)[f])
    assert not f[eng.tables["lineorder"].n_rows:].any()


def test_sharded_probe_from_pinned_snapshot(tables, appended):
    """A sharded probe over a pinned snapshot's image stays equal to the
    freeze instant while the head appends (the pin forces a copy),
    ingests and swap-compacts; the JAX engine's snapshot, through the
    same steps, answers the same."""
    eng, jeng, src = appended
    mesh = make_data_mesh(4, device="cpu")
    n_part = int(tables["part"].n_rows)
    snap, jsnap = eng.snapshot(), jeng.snapshot()
    cf, cr = eng._probe_cache["part"]
    ref_f, ref_r = _np(cf).copy(), _np(cr).copy()
    batch2 = _batch(tables["lineorder"], src, 2 * 10**7)
    keys = np.arange(2 * 10**6, 2 * 10**6 + 50, dtype=np.int32)
    rows = np.arange(n_part, n_part + 50, dtype=np.int32)
    for e in (eng, jeng):
        e.append_fact_rows({k: v.copy() for k, v in batch2.items()})
        e.ingest("part", keys, rows, op="insert", auto_compact=False)
        e.compact("part")  # pinned: the swap flavor
    sf_, sr_ = snap.probe_dim("part")
    spr = sharded_lookup(snap.indexes["part"],
                         snap.tables["lineorder"]["partkey"], mesh)
    jf, jr = jsnap.probe_dim("part")
    try:
        assert eng.snapshot_info()["pin_copies"] > 0
        assert np.array_equal(ref_f, _np(sf_))
        assert np.array_equal(ref_r, _np(sr_))
        assert np.array_equal(ref_f, _np(spr.found))
        assert np.array_equal(ref_r[ref_f], _np(spr.payload)[ref_f])
        assert np.array_equal(ref_f, np.asarray(jf))
        assert np.array_equal(ref_r[ref_f], np.asarray(jr)[ref_f])
    finally:
        snap.release()
        jsnap.release()
