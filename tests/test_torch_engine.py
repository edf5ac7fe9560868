"""The port's static SSB read path against the JAX engine, bit for bit.

One JAX reference engine (``kernel="xla"``, gathered schedule) answers the
13 queries at sf=0.002; every execution path of the port, on the CPU (the
kernels' plain versions), must give the same ``(total, groups)``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.policy import ExecutionPolicy as JaxPolicy
from repro.engine import SSBEngine as JaxEngine
from repro.engine import generate_ssb as jax_generate_ssb
from repro.engine import generate_ssb_dims as jax_generate_ssb_dims
from repro.engine import join as jjoin
from repro_torch.core import ExecutionPolicy
from repro_torch.engine import (SSB_QUERIES, SSBEngine, dim_index_from_numpy,
                                generate_ssb, generate_ssb_dims, join,
                                tables_from_numpy)
from repro_torch.engine.join import BuildStats

SF = 0.002


@pytest.fixture(scope="module")
def reference():
    """(JAX engine, its 13 answers as numpy)."""
    engine = JaxEngine(jax_generate_ssb(SF),
                       policy=JaxPolicy(kernel="xla", schedule="gathered"))
    answers = {q: (int(t), np.asarray(g))
               for q, (t, g) in engine.run_all().items()}
    return engine, answers


@pytest.fixture(scope="module")
def tables():
    return generate_ssb(SF, device="cpu")


def _assert_answers(got, reference):
    _, want = reference
    assert sorted(got) == sorted(want) == sorted(SSB_QUERIES)
    for q, (total, groups) in want.items():
        assert got[q][0].dtype == got[q][1].dtype == torch.int32, q
        assert int(got[q][0]) == total, q
        np.testing.assert_array_equal(got[q][1].numpy(), groups, err_msg=q)


def test_generated_tables_are_byte_identical(tables):
    want = jax_generate_ssb(SF)
    assert sorted(tables) == sorted(want)
    for name, table in tables.items():
        assert table.names() == want[name].names()
        for col in table.names():
            np.testing.assert_array_equal(table[col].numpy(),
                                          np.asarray(want[name][col]))
        assert table.nbytes() == want[name].nbytes()
    dims = generate_ssb_dims(SF, device="cpu")
    jdims = jax_generate_ssb_dims(SF)
    for name, table in dims.items():
        for col in table.names():
            np.testing.assert_array_equal(table[col].numpy(),
                                          np.asarray(jdims[name][col]))


PATHS = {
    "cached_composed": lambda e: e.run_all(fusion="composed"),
    "cached_mega_suite": lambda e: e.run_all(fusion="mega"),
    "cold_mega_suite": lambda e: e.run_all(fusion="mega", use_cache=False),
    "cold_run": lambda e: {q: e.run(q, use_cache=False)
                           for q in SSB_QUERIES},
    "mega_run": lambda e: {q: e.run(q, fusion="mega") for q in SSB_QUERIES},
}


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("kernel", ["cuda", "torch"])
def test_jspim_paths_match_jax(tables, reference, kernel, path):
    engine = SSBEngine(tables, policy=ExecutionPolicy(kernel=kernel),
                       device="cpu")
    _assert_answers(PATHS[path](engine), reference)


@pytest.mark.parametrize("mode", ["baseline", "pid"])
@pytest.mark.parametrize("use_cache", [True, False])
def test_baseline_modes_match_jax(tables, reference, mode, use_cache):
    engine = SSBEngine(tables, policy=ExecutionPolicy(mode=mode),
                       device="cpu")
    assert engine.indexes == {}
    _assert_answers(engine.run_all(use_cache=use_cache), reference)


def test_build_stats_geometry_matches(tables, reference):
    jax_engine, _ = reference
    engine = SSBEngine(tables, device="cpu")
    for dim, stats in engine.build_stats.items():
        jstats = jax_engine.build_stats[dim]
        assert stats.bucket_width == 8
        for f in dataclasses.fields(BuildStats):
            got, want = getattr(stats, f.name), getattr(jstats, f.name)
            if f.name == "fact_skew":  # each package has its SkewStats
                assert got is not None
                got, want = dataclasses.astuple(got), \
                    dataclasses.astuple(want)
            assert got == want, (dim, f.name)


def _index_arrays(index):
    d, t = index.dictionary, index.table
    return {"dictionary": {"keys": np.asarray(d.keys), "n": np.asarray(d.n),
                           "codes": None if d.codes is None
                           else np.asarray(d.codes)},
            "table": {"keys": np.asarray(t.keys),
                      "values": np.asarray(t.values),
                      "dup_offsets": np.asarray(t.dup_offsets),
                      "dup_indices": np.asarray(t.dup_indices),
                      "group_count": np.asarray(t.group_count),
                      "n_unique": np.asarray(t.n_unique),
                      "n_build": np.asarray(t.n_build),
                      "overflow": np.asarray(t.overflow),
                      "hash_mode": t.hash_mode}}


def test_engine_on_jax_indexes(tables, reference):
    """An engine adopting the JAX package's indexes (via engine/convert.py)
    holds the very same hash dataset and gives the same answers."""
    jax_engine, _ = reference
    built = SSBEngine(tables, device="cpu")
    indexes = {}
    for dim, jidx in jax_engine.indexes.items():
        s = jidx.stats
        stats = BuildStats(s.num_buckets, s.bucket_width, s.n_unique,
                           s.n_build, s.overflow, s.grow_retries, s.load)
        indexes[dim] = dim_index_from_numpy(_index_arrays(jidx), stats, "cpu")
        mine = built.indexes[dim]
        for part in ("dictionary", "table"):
            for k, v in _index_arrays(indexes[dim])[part].items():
                if k == "hash_mode" or v is None:
                    continue
                np.testing.assert_array_equal(v, _index_arrays(mine)[part][k])
    host = {name: {c: np.asarray(t[c]) for c in t.names()}
            for name, t in jax_generate_ssb(SF).items()}
    engine = SSBEngine(tables_from_numpy(host, "cpu"), indexes=indexes,
                       device="cpu")
    _assert_answers(engine.run_all(), reference)
    _assert_answers({q: engine.run(q, fusion="mega") for q in SSB_QUERIES},
                    reference)


@pytest.mark.parametrize("impl", ["cuda", "torch"])
@pytest.mark.parametrize("dim", ["customer", "supplier", "part", "date"])
def test_lookup_matches_jax(tables, reference, impl, dim):
    jax_engine, _ = reference
    engine = SSBEngine(tables, device="cpu")
    fk = tables["lineorder"][{"customer": "custkey", "supplier": "suppkey",
                              "part": "partkey", "date": "orderdate"}[dim]]
    fk = torch.cat([fk, torch.tensor([-1, 10**6], dtype=torch.int32)])
    jfk = fk.numpy()
    jimpl = "pallas" if impl == "cuda" else "xla"  # Pallas in interpret mode
    got = join.lookup(engine.indexes[dim], fk, impl=impl)
    want = jjoin.lookup(jax_engine.indexes[dim], jfk, impl=jimpl)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    mask = np.arange(tables[dim].n_rows) % 3 == 1
    got = join.lookup_filtered(engine.indexes[dim], fk,
                               torch.as_tensor(mask), impl=impl)
    want = jjoin.lookup_filtered(jax_engine.indexes[dim], jfk, mask,
                                 impl=jimpl)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_probe_cache(tables):
    engine = SSBEngine(tables, device="cpu")
    engine.run_all(fusion="composed")
    info = engine.cache_info()
    assert info["misses"] == 4 and info["hits"] > 0
    assert info["cached_dims"] == ["customer", "date", "part", "supplier"]
    engine.invalidate_probe_cache("part")
    assert engine.cache_info()["cached_dims"] == ["customer", "date",
                                                  "supplier"]
    engine.warm_cache()
    assert engine.cache_info()["misses"] == 5
    engine.invalidate_probe_cache()
    assert engine.cache_info()["cached_dims"] == []
    assert engine.cache_info()["invalidations"] == 5


@pytest.mark.parametrize("field", ["schedule", "fusion"])
def test_auto_is_gated_until_the_planner_slice(tables, reference,
                                               monkeypatch, field):
    """The gate is gone: "auto" is the default and is priced on the
    engine's device.  fusion="auto" runs the composed path for ``run`` and
    ``plan_query``'s pick for ``run_all`` on the cache (on "cpu" the
    reference's "mega"); schedule="auto" keeps gathered for the CUDA
    kernels on "cpu" and on "cuda", with every schedule priced."""
    from repro_torch.core import planner
    from repro_torch.engine import queries
    assert (ExecutionPolicy().schedule, ExecutionPolicy().fusion) == \
        ("auto", "auto")
    engine = SSBEngine(tables, device="cpu")
    if field == "fusion":
        seen = []
        real = queries.plan_query

        def spy(*a, **k):
            seen.append(real(*a, **k))
            return seen[-1]
        monkeypatch.setattr(queries, "plan_query", spy)
        _assert_answers({q: engine.run(q, fusion="auto")
                         for q in SSB_QUERIES}, reference)
        assert not seen  # a single query never asks the planner
        _assert_answers(engine.run_all(fusion="auto"), reference)
        want = planner.plan_query(engine.tables["lineorder"].n_rows, 13,
                                  backend="cpu", kernel="torch")
        assert seen == [want] and want.fusion == "mega"
        _assert_answers(engine.run_all(fusion="auto", use_cache=False),
                        reference)
        assert len(seen) == 1  # cold suites take the composed path
        return
    assert {p.schedule for p in engine.plans.values()} == {"gathered"}
    monkeypatch.setattr(engine, "device", torch.device("cuda"))
    for dim in engine.indexes:
        engine._plan_dim(dim)
        st = engine.indexes[dim].stats
        want = planner.plan_probe(
            st.fact_skew, bucket_width=st.bucket_width, backend="cuda",
            impl="cuda", code_space=int(engine.indexes[dim].dictionary.n),
            hash_mode=engine.indexes[dim].table.hash_mode)
        assert engine.plans[dim] == want
        assert want.schedule == "gathered" and len(want.est_seconds) == 4


@pytest.mark.parametrize("path", ["cached_composed", "cold_run", "mega_run"])
@pytest.mark.parametrize("kernel", ["cuda", "torch"])
def test_stream_schedule_matches_jax(tables, reference, monkeypatch, kernel,
                                     path):
    """``schedule="stream"`` probes through ``bucket_probe_stream`` (its
    plain version here) and gives the gathered answers, as every schedule
    must; filtered cold probes keep the filter kernel on ``"cuda"``."""
    from repro_torch.kernels import ops
    calls = []
    real = ops.bucket_probe_stream
    monkeypatch.setattr(ops, "bucket_probe_stream",
                        lambda *a: calls.append(1) or real(*a))
    engine = SSBEngine(tables, policy=ExecutionPolicy(kernel=kernel,
                                                      schedule="stream"),
                       device="cpu")
    _assert_answers(PATHS[path](engine), reference)
    if path == "mega_run":
        assert not calls
    else:  # 4 cached probes; on cold, one per unfiltered joined dimension
        n_unfiltered = sum(len(set(s.joined_dims()) - set(s.dim_filters))
                           for s in SSB_QUERIES.values())
        assert len(calls) == {"cached_composed": 4,
                              "cold_run": n_unfiltered
                              if kernel == "cuda" else 32 + 4}[path]


def test_policy_defaults_and_validation():
    p = ExecutionPolicy()
    assert (p.mode, p.kernel, p.schedule, p.fusion, p.use_cache) == \
        ("jspim", "cuda", "auto", "auto", True)
    for bad in ({"mode": "x"}, {"kernel": "pallas"}, {"kernel": "xla"},
                {"fusion": "fused"}, {"schedule": "interpret"}):
        with pytest.raises(ValueError):
            ExecutionPolicy(**bad)


def test_engine_refuses_tables_on_another_device(tables):
    meta = {n: type(t)({c: v.to("meta") for c, v in t.columns.items()})
            for n, t in tables.items()}
    with pytest.raises(ValueError, match="lives on"):
        SSBEngine(meta, device="cpu")
