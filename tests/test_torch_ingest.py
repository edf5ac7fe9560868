"""The port's dimension mutation path against the JAX engine, bit for bit.

One seeded ``random_mutation`` stream (ingest, delete, append_rows,
compact) drives a JAX engine (``kernel="xla"``) and two port engines on
the CPU (``kernel="cuda"``, whose kernel wrappers take their plain
versions here, and ``kernel="torch"``).  Each package draws the stream
with its own ``random_mutation`` from the same seed.  After every step,
every path of the port must give the JAX package's ``(total, groups)``:

* cached -- ``run_all`` on the probe cache, against JAX's;
* cold -- ``run(q, use_cache=False)``.  The port's ``"torch"`` kernel
  post-filters like JAX's ``"xla"``; its ``"cuda"`` kernel folds the
  predicate into the probe as JAX's ``"pallas"`` kernel does, so its
  reference is JAX's ``lookup_filtered`` on the filtered dimensions (the
  Pallas kernel's own reference semantics);
* mega -- ``run(q, fusion="mega")``, against JAX's ``fused_query``
  reference on JAX's own mega operands.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.policy import ExecutionPolicy as JaxPolicy
from repro.engine import SSBEngine as JaxEngine
from repro.engine import generate_ssb as jax_generate_ssb
from repro.engine import join as jjoin
from repro.engine import queries as jqueries
from repro.engine.ssb import random_mutation as jax_random_mutation
from repro.kernels import ref as jref
from repro_torch.core import ExecutionPolicy
from repro_torch.engine import (SSB_QUERIES, SSBEngine, dim_index_from_numpy,
                                generate_ssb, join, random_mutation)
from repro_torch.engine.join import BuildStats
from repro_torch.engine.queries import DIM_PK, FACT_FK

SF = 0.002
SEED = 158  # folds two live deltas, re-points a key past its table
STEPS = 8
KINDS = ("ingest", "delete", "append_rows", "compact")
NAMES = sorted(SSB_QUERIES)


def _np(answers):
    return {q: (int(t), np.asarray(g)) for q, (t, g) in answers.items()}


def _jax_cold(engine, *, filtered: bool):
    """JAX's cold answers: each query probes its dimensions afresh
    (``lookup``, or with ``filtered`` ``lookup_filtered`` on the filtered
    dimensions: overlay, then the row filter, the Pallas filter kernels'
    reference semantics), then runs the engine's own query tail."""
    fact_cols = dict(engine.tables["lineorder"].columns)
    out = {}
    for q in NAMES:
        spec = jqueries.SSB_QUERIES[q]
        dim_cols = {d: dict(engine.tables[d].columns)
                    for d in spec.joined_dims()}
        probes = {}
        for d in spec.joined_dims():
            idx = jjoin.effective_index(engine.indexes[d])
            fk = fact_cols[FACT_FK[d]]
            if filtered and d in spec.dim_filters:
                mask = spec.dim_filters[d](engine.tables[d])
                pr = jjoin.lookup_filtered(idx, fk, mask, impl="xla")
            else:
                pr = jjoin.lookup(idx, fk, impl="xla")
            probes[d] = (pr.found, jnp.where(pr.found, pr.payload, -1))
        out[q] = engine._cached_program(q)(fact_cols, dim_cols, probes)
    return _np(out)


def _jax_mega(engine):
    """JAX's mega answers: its ``fused_query`` reference on its own mega
    operands."""
    fact_cols = dict(engine.tables["lineorder"].columns)
    out = {}
    for q in NAMES:
        spec = jqueries.SSB_QUERIES[q]
        dims = spec.joined_dims()
        dim_cols = {d: dict(engine.tables[d].columns) for d in dims}
        idx = {d: jjoin.effective_index(engine.indexes[d]) for d in dims}
        dim_ops, fmeasure, size = jqueries._mega_operands(
            spec, fact_cols, dim_cols, idx)
        out[q] = jref.fused_query_ref(dim_ops, fmeasure, num_segments=size)
    return _np(out)


def _port_answers(engine):
    return {"cached": _np(engine.run_all(fusion="composed")),
            "cold": _np({q: engine.run(q, use_cache=False) for q in NAMES}),
            "mega": _np({q: engine.run(q, fusion="mega") for q in NAMES})}


def _fresh(tables):
    return dict(tables)  # engines replace dimension tables on append


@pytest.fixture(scope="module")
def stream():
    """Drive the stream; returns per-step records of every answer."""
    jax_engine = JaxEngine(_fresh(jax_generate_ssb(SF)),
                           policy=JaxPolicy(kernel="xla",
                                            schedule="gathered"))
    tables = generate_ssb(SF, device="cpu")
    port = {k: SSBEngine(_fresh(tables),
                         policy=ExecutionPolicy(kernel=k), device="cpu")
            for k in ("cuda", "torch")}
    rngs = {"jax": np.random.default_rng(SEED),
            **{k: np.random.default_rng(SEED) for k in port}}
    records = []
    for _ in range(STEPS):
        live_before = sorted(d for d, ix in port["cuda"].indexes.items()
                             if ix.delta is not None)
        n_rows = {d: t.n_rows for d, t in port["cuda"].tables.items()}
        kind, detail = jax_random_mutation(jax_engine, rngs["jax"],
                                           kinds=KINDS)
        details = {k: random_mutation(e, rngs[k], kinds=KINDS)
                   for k, e in port.items()}
        jax_answers = {
            "cached": _np(jax_engine.run_all(fusion="composed")),
            "cold_xla": _jax_cold(jax_engine, filtered=False),
            "cold_filtered": _jax_cold(jax_engine, filtered=True),
            "mega": _jax_mega(jax_engine)}
        live = sorted(d for d, ix in port["cuda"].indexes.items()
                      if ix.delta is not None)
        records.append({"kind": kind, "detail": detail, "details": details,
                        "live_before": live_before, "n_rows": n_rows,
                        "live": live, "jax": jax_answers,
                        "port": {k: _port_answers(e)
                                 for k, e in port.items()}})
    return {"records": records, "jax": jax_engine, "port": port,
            "tables": tables}


def _assert_same(got, want, msg):
    assert sorted(got) == sorted(want) == NAMES
    for q, (total, groups) in want.items():
        assert got[q][0] == total, f"{msg} {q} total"
        np.testing.assert_array_equal(got[q][1], groups,
                                      err_msg=f"{msg} {q}")


def test_both_packages_draw_the_same_stream(stream):
    for i, r in enumerate(stream["records"]):
        for k, (kind, detail) in r["details"].items():
            assert kind == r["kind"], (i, k)
            assert detail.keys() == r["detail"].keys(), (i, k)
            for f, v in detail.items():
                if isinstance(v, dict):
                    for c in v:
                        np.testing.assert_array_equal(v[c],
                                                      r["detail"][f][c])
                else:
                    np.testing.assert_array_equal(v, r["detail"][f])
    recs = stream["records"]
    # the seed exercises ingest, growth and compaction of a live delta,
    # with live deltas on several dimensions and a payload past its table
    assert {"ingest", "append_rows", "compact"} <= {r["kind"] for r in recs}
    assert any(r["kind"] == "compact" and r["detail"]["dim"] in
               r["live_before"] for r in recs)
    assert max(len(r["live"]) for r in recs) >= 3
    assert any("payloads" in r["detail"] and
               (r["detail"]["payloads"] >= r["n_rows"][r["detail"]["dim"]]
                ).any() for r in recs)


_PAIRS = {("cuda", "cached"): "cached", ("torch", "cached"): "cached",
          ("cuda", "cold"): "cold_filtered", ("torch", "cold"): "cold_xla",
          ("cuda", "mega"): "mega", ("torch", "mega"): "mega"}


@pytest.mark.parametrize("kernel,path", sorted(_PAIRS))
@pytest.mark.parametrize("step", range(STEPS))
def test_every_path_matches_jax_after_each_step(stream, step, kernel, path):
    r = stream["records"][step]
    _assert_same(r["port"][kernel][path], r["jax"][_PAIRS[kernel, path]],
                 f"step {step} ({r['kind']}, live {r['live']}) "
                 f"{kernel}/{path}")


def test_delta_state_matches_jax_after_the_stream(stream):
    jax_engine = stream["jax"]
    for k, engine in stream["port"].items():
        for dim, idx in engine.indexes.items():
            jidx = jax_engine.indexes[dim]
            assert (idx.delta is None) == (jidx.delta is None), (k, dim)
            pairs = [(idx.dictionary.keys, jidx.dictionary.keys),
                     (idx.table.keys, jidx.table.keys),
                     (idx.table.values, jidx.table.values)]
            if idx.delta is not None:
                pairs += [(idx.delta.keys, jidx.delta.keys),
                          (idx.delta.words, jidx.delta.words),
                          (idx.delta.fill, jidx.delta.fill)]
            for got, want in pairs:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                              err_msg=f"{k} {dim}")
        for dim, t in engine.tables.items():
            for c in t.names():
                np.testing.assert_array_equal(
                    t[c].numpy(), np.asarray(jax_engine.tables[dim][c]))
        info = engine.ingest_info()
        jinfo = jax_engine.ingest_info()
        assert info["ingest_batches"] == jinfo["ingest_batches"]
        assert info["compactions"] == jinfo["compactions"]
        assert info["deltas"] == jinfo["deltas"]


def _live_pair(stream):
    """A port index and the JAX index of each dimension after one more
    batch of ops on both, so every dimension has a live delta."""
    jax_engine, engine = stream["jax"], stream["port"]["torch"]
    pairs = {}
    for dim in ("customer", "supplier", "part", "date"):
        jidx = jax_engine.indexes[dim]
        n = engine.tables[dim].n_rows
        keys = np.array([0, 1, n - 1, n + 5], np.int32)
        pays = np.array([n - 1, n + 2, 0, 3], np.int32)
        pidx = join.ingest_index(engine.indexes[dim], keys, pays,
                                 op="upsert")
        pidx = join.ingest_index(pidx, keys[2:3], op="delete")
        jidx = jjoin.ingest_index(jidx, keys, pays, op="upsert")
        jidx = jjoin.ingest_index(jidx, keys[2:3], op="delete")
        pairs[dim] = (pidx, jidx)
    return pairs


@pytest.mark.parametrize("impl", ["cuda", "torch"])
@pytest.mark.parametrize("dim", ["customer", "supplier", "part", "date"])
def test_live_delta_lookup_matches_jax(stream, impl, dim):
    """``lookup`` and ``lookup_filtered`` on a live-delta index against the
    JAX package's (``impl="pallas"`` in interpret mode for the kernels)."""
    pidx, jidx = _live_pair(stream)[dim]
    fk = stream["tables"]["lineorder"][FACT_FK[dim]][:600]
    n = stream["port"]["torch"].tables[dim].n_rows
    fk = torch.cat([fk, torch.tensor([0, 1, n - 1, n + 5, -1, 10**6],
                                     dtype=torch.int32)])
    jfk = jnp.asarray(fk.numpy())
    jimpl = "pallas" if impl == "cuda" else "xla"
    got = join.lookup(pidx, fk, impl=impl)
    want = jjoin.lookup(jidx, jfk, impl=jimpl)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    mask = np.arange(n) % 3 == 1
    got = join.lookup_filtered(pidx, fk, torch.as_tensor(mask), impl=impl)
    want = jjoin.lookup_filtered(jidx, jfk, jnp.asarray(mask), impl=jimpl)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _index_arrays(index):
    d, t = index.dictionary, index.table
    out = {"dictionary": {"keys": np.asarray(d.keys), "n": np.asarray(d.n),
                          "codes": None if d.codes is None
                          else np.asarray(d.codes)},
           "table": {f: np.asarray(getattr(t, f))
                     for f in ("keys", "values", "dup_offsets",
                               "dup_indices", "group_count", "n_unique",
                               "n_build", "overflow")}}
    out["table"]["hash_mode"] = t.hash_mode
    if index.delta is not None:
        dl = index.delta
        out["delta"] = {f: np.asarray(getattr(dl, f))
                        for f in ("keys", "words", "fill", "n_ops",
                                  "overflow")}
        out["delta"]["hash_mode"] = dl.hash_mode
    return out


def test_engine_adopts_mutated_jax_indexes(stream):
    """A port engine built on the JAX engine's mutated state (tables and
    indexes, live deltas included, through ``engine/convert.py``) gives
    the JAX engine's answers, and compacts to the same state."""
    jax_engine = stream["jax"]
    indexes = {}
    for dim, jidx in jax_engine.indexes.items():
        s = jidx.stats
        stats = BuildStats(s.num_buckets, s.bucket_width, s.n_unique,
                           s.n_build, s.overflow, s.grow_retries, s.load)
        indexes[dim] = dim_index_from_numpy(_index_arrays(jidx), stats, "cpu")
        assert (indexes[dim].delta is None) == (jidx.delta is None)
    assert any(ix.delta is not None for ix in indexes.values())
    from repro_torch.engine import tables_from_numpy
    host = {name: {c: np.asarray(t[c]) for c in t.names()}
            for name, t in jax_engine.tables.items()}
    engine = SSBEngine(tables_from_numpy(host, "cpu"), indexes=indexes,
                       device="cpu")
    want = stream["records"][-1]["jax"]
    got = _port_answers(engine)
    _assert_same(got["cached"], want["cached"], "adopted cached")
    _assert_same(got["cold"], want["cold_filtered"], "adopted cold")
    _assert_same(got["mega"], want["mega"], "adopted mega")
    for dim in indexes:
        engine.compact(dim)
    assert all(ix.delta is None for ix in engine.indexes.values())
    _assert_same(_np(engine.run_all(fusion="composed")), want["cached"],
                 "adopted, compacted")


# ---------------------------------------------------------------------------
# engine surface: compaction pricing, batch validation, §3.2.3 commands
# ---------------------------------------------------------------------------


@pytest.fixture
def small_engines():
    """A fresh (JAX engine, port engine) pair on the same tables."""
    jax_engine = JaxEngine(_fresh(jax_generate_ssb(SF)),
                           policy=JaxPolicy(kernel="xla",
                                            schedule="gathered"))
    engine = SSBEngine(_fresh(generate_ssb(SF, device="cpu")), device="cpu")
    return jax_engine, engine


def _new_rows(engine, dim, n):
    t = engine.tables[dim]
    rows = {c: t[c][:n].numpy() for c in t.names()}
    rows[DIM_PK[dim]] = np.arange(10_000, 10_000 + n, dtype=np.int32)
    return rows


def _assert_same_plan(got, want):
    """The port's plan has every field of JAX's but ``swap``, which prices
    a merge around a pinned snapshot: the port has no snapshots yet."""
    assert not want.swap
    assert dataclasses.asdict(got) == {
        f.name: getattr(want, f.name) for f in dataclasses.fields(got)}


def test_compaction_pricing_matches_jax_on_the_cpu(small_engines):
    jax_engine, engine = small_engines
    keys = np.arange(0, 40, dtype=np.int32)
    pays = np.arange(100, 140, dtype=np.int32)
    for auto in (False, True):
        got = engine.ingest("customer", keys, pays, auto_compact=auto)
        want = jax_engine.ingest("customer", keys, pays, auto_compact=auto)
        _assert_same_plan(got, want)
        assert engine.ingest_info() == jax_engine.ingest_info()
    got = engine.compaction_plan("part")
    want = jax_engine.compaction_plan("part")
    _assert_same_plan(got, want)


def test_compaction_pricing_is_gated_on_a_cuda_engine(small_engines,
                                                      monkeypatch):
    """No longer gated: an engine on the card prices compaction on the
    card's entry, ``ingest``/``append_rows(auto_compact=True)`` compact on
    its decision, and the answers equal the JAX engine's after the same
    ops and folds."""
    from repro_torch.core import planner as tplanner
    jax_engine, engine = small_engines
    monkeypatch.setattr(engine, "device", torch.device("cuda"))
    n0 = engine.tables["part"].n_rows
    rows = _new_rows(engine, "part", 3)
    from repro_torch.core.delta import delta_stats
    plan = engine.ingest("part", [1, 2], [3, 4], auto_compact=False)
    idx = engine.indexes["part"]
    ds = delta_stats(idx.delta)
    want = tplanner.plan_compaction(
        delta_entries=ds.n_entries, delta_slots=ds.num_slots,
        fill_frac=ds.fill_frac, worst_bucket_frac=ds.worst_bucket_frac,
        n_build=idx.stats.n_build, n_dict=int(idx.dictionary.n),
        bucket_width=8, expected_probes=engine.tables["lineorder"].n_rows,
        backend="cuda")
    assert plan == want == engine.compaction_plan("part")
    jax_engine.ingest("part", [1, 2], [3, 4], auto_compact=False)
    assert engine.append_rows("part", rows) is None
    jax_engine.append_rows("part", rows, auto_compact=False)
    assert engine.tables["part"].n_rows == n0 + 3
    folded = engine.indexes["part"].delta is None
    assert folded == (engine.ingest_info()["compactions"] > 0)
    if folded:
        jax_engine.compact("part")
    monkeypatch.undo()
    _assert_same(_np(engine.run_all(fusion="composed")),
                 _np(jax_engine.run_all(fusion="composed")), "cuda-priced")


@pytest.mark.parametrize("bad", ["float_keys", "2d_keys", "ragged",
                                 "empty_key", "no_payloads", "unknown_op",
                                 "unknown_dim", "int64_range",
                                 "append_columns"])
def test_mutation_batches_are_validated(small_engines, bad):
    _, engine = small_engines
    keys, pays = np.array([1, 2], np.int32), np.array([3, 4], np.int32)
    kw = dict(dim="part", keys=keys, payloads=pays, op="upsert")
    if bad == "float_keys":
        kw["keys"] = np.array([1.5, 2.0])
    elif bad == "2d_keys":
        kw["keys"] = keys.reshape(2, 1)
    elif bad == "ragged":
        kw["payloads"] = pays[:1]
    elif bad == "empty_key":
        kw["keys"] = np.array([1, -0x7FFFFFFF], np.int32)
    elif bad == "no_payloads":
        kw["payloads"] = None
    elif bad == "unknown_op":
        kw["op"] = "merge"
    elif bad == "unknown_dim":
        kw["dim"] = "region"
    elif bad == "int64_range":
        kw["keys"] = np.array([1, 2**40], np.int64)
    with pytest.raises(ValueError):
        if bad == "append_columns":
            rows = _new_rows(engine, "part", 2)
            del rows["brand"]
            engine.append_rows("part", rows)
        else:
            engine.ingest(kw.pop("dim"), kw.pop("keys"), kw.pop("payloads"),
                          **kw)
    assert all(ix.delta is None for ix in engine.indexes.values())
    assert engine.ingest_info()["ingest_batches"] == 0


def test_update_commands_through_the_engine_match_jax(small_engines):
    """The §3.2.3 commands rewrite table cells, drop the dimension's
    cached probes, and give the JAX engine's answers after each."""
    jax_engine, engine = small_engines
    engine.run_all()
    cmds = [("index_update", ("part", 5, 7)),
            ("index_update", ("customer", 123_456, 1)),   # absent: no-op
            ("entry_update", ("supplier", 0, 0, int(
                engine.indexes["supplier"].table.keys[0, 0]), 3 << 1)),
            ("table_update", ("date", np.array([1]),
                              np.full((1, 8), -0x7FFFFFFF, np.int32),
                              np.zeros((1, 8), np.int32)))]
    for name, args in cmds:
        misses = engine.cache_info()["misses"]
        getattr(engine, name)(*args)
        getattr(jax_engine, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                                    else a for a in args))
        assert args[0] not in engine.cache_info()["cached_dims"]
        _assert_same(_np(engine.run_all(fusion="composed")),
                     _np(jax_engine.run_all(fusion="composed")), name)
        assert engine.cache_info()["misses"] == misses + 1


@pytest.mark.parametrize("op", ["upsert", "delete", "append_rows",
                                "index_update"])
def test_engines_sharing_indexes_do_not_see_each_others_mutations(op):
    """Two engines built on the same tables and ``indexes=``: one mutates
    ``part`` and compacts it; the other keeps its planes and its answers."""
    tables = generate_ssb(SF, device="cpu")
    first = SSBEngine(tables, device="cpu")
    second = SSBEngine(tables, indexes=first.indexes, device="cpu")
    before = _port_answers(second)
    planes = {d: [x.clone() for x in (ix.table.keys, ix.table.values,
                                      ix.dictionary.keys)]
              for d, ix in second.indexes.items()}
    pk = tables["part"][DIM_PK["part"]].numpy()
    n = pk.shape[0]
    if op == "upsert":
        first.ingest("part", pk[::5], (np.arange(0, n, 5) + 1) % n,
                     auto_compact=False)
    elif op == "delete":
        first.ingest("part", pk[::5], op="delete", auto_compact=False)
    elif op == "append_rows":
        first.append_rows("part", _new_rows(first, "part", 5),
                          auto_compact=False)
    else:
        first.index_update("part", int(pk[3]), 0)
    first.compact("part")
    assert first.indexes["part"].delta is None
    assert second.indexes["part"].delta is None
    assert second.tables["part"].n_rows == n
    for d, ix in second.indexes.items():
        for got, want in zip((ix.table.keys, ix.table.values,
                              ix.dictionary.keys), planes[d]):
            assert torch.equal(got, want), d
    after = _port_answers(second)
    for path in ("cached", "cold", "mega"):
        _assert_same(after[path], before[path], f"{op} {path}")
    if op != "append_rows":  # new keys join no fact row
        totals = {q: t for q, (t, _) in _port_answers(first)["cold"].items()}
        assert totals != {q: t for q, (t, _) in before["cold"].items()}
