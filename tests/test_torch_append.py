"""The port's fact-side streaming append against the JAX engine, bit for bit.

One seeded ``random_mutation`` stream with the JAX package's default kinds
(fact appends, ingest, deletes, dimension appends, compaction) drives a
JAX engine (``kernel="xla"``, gathered) and two port engines on the CPU
(``kernel="cuda"``, whose kernel wrappers take their plain versions here,
and ``kernel="torch"``), every probe cache warm so that appends extend it.
After every step the port's cached, cold and mega answers equal the JAX
engine's, and so do its append reports, epochs, ``fact_append_info()``
(but the port's own ``skew_measures``), capacity and cached probes over
the physical rows.  Last, the JAX engine's state after the stream,
carried across through ``engine/convert.py``, answers as its port twin
does.  The append path's
pieces and the engine surface are in ``test_torch_append_engine.py``.
"""
import os

import numpy as np
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
from repro_torch.engine import (SSB_QUERIES, SSBEngine, build_stats_from,
                                dim_index_from_numpy, generate_ssb,
                                random_mutation, tables_from_numpy)

SF = 0.002
SEED = 1198  # 4 fact appends, each over live deltas; a live delta compacted
STEPS = 8
LAST_APPEND = 7  # the step of the seed's last fact append
NAMES = sorted(SSB_QUERIES)
DIMS = ("customer", "supplier", "part", "date")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread_when_parallel():
    """In a parallel run (pytest-xdist workers share the cores) this
    module's torch ops take one thread each: OpenMP regions, which wait
    for every thread, stall when the cores are oversubscribed.  Alone,
    torch keeps its default."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        yield
        return
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(answers):
    return {q: (int(t), np.asarray(g)) for q, (t, g) in answers.items()}


def _assert_same(got, want, msg):
    assert sorted(got) == sorted(want) == NAMES
    for q, (total, groups) in want.items():
        assert got[q][0] == total, f"{msg} {q} total"
        np.testing.assert_array_equal(got[q][1], groups,
                                      err_msg=f"{msg} {q}")


def _jax_mega(engine):
    """JAX's mega answers: its ``fused_query`` reference on its own mega
    operands, over the capacity-padded fact columns."""
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


def _record_appends(engine):
    """Record every ``append_fact_rows`` report of ``engine``."""
    reports, orig = [], engine.append_fact_rows

    def rec(rows, **kw):
        reports.append(orig(rows, **kw))
        return reports[-1]
    engine.append_fact_rows = rec
    return reports


def _probes_np(engine):
    return {d: tuple(np.asarray(x) for x in engine._probe_cache[d])
            for d in sorted(engine._probe_cache)}


@pytest.fixture(scope="module")
def stream():
    """Drive the stream; returns per-step records of every answer."""
    jax_engine = JaxEngine(dict(jax_generate_ssb(SF)),
                           policy=JaxPolicy(kernel="xla",
                                            schedule="gathered"))
    tables = generate_ssb(SF, device="cpu")
    port = {k: SSBEngine(dict(tables), policy=ExecutionPolicy(kernel=k),
                         device="cpu")
            for k in ("cuda", "torch")}
    reports = {"jax": _record_appends(jax_engine),
               **{k: _record_appends(e) for k, e in port.items()}}
    for e in (jax_engine, *port.values()):
        e.warm_cache()
    rngs = {"jax": np.random.default_rng(SEED),
            **{k: np.random.default_rng(SEED) for k in port}}
    records = []
    for _ in range(STEPS):
        live = sorted(d for d, ix in port["cuda"].indexes.items()
                      if ix.delta is not None)
        n_rows = {d: t.n_rows for d, t in port["cuda"].tables.items()}
        kind, detail = jax_random_mutation(jax_engine, rngs["jax"])
        details = {k: random_mutation(e, rngs[k]) for k, e in port.items()}
        records.append({
            "kind": kind, "detail": detail, "details": details,
            "live_before": live, "n_rows": n_rows,
            # JAX's mega reference (its fused_query reference on the
            # padded operands) after the last fact append; elsewhere its
            # answers equal its cached ones
            "jax": {"cached": _np(jax_engine.run_all(fusion="composed")),
                    "mega": (_jax_mega(jax_engine)
                             if len(records) == LAST_APPEND else None)},
            "port": {k: _port_answers(e) for k, e in port.items()},
            "state": {k: (e.epoch, e.fact_epoch, e.fact_append_info(),
                          e.cache_info()["fact_epoch"], _probes_np(e))
                      for k, e in (("jax", jax_engine), *port.items())}})
    return {"records": records, "jax": jax_engine, "port": port,
            "reports": reports, "tables": tables}


def test_both_packages_draw_the_same_stream(stream):
    recs = stream["records"]
    for i, r in enumerate(recs):
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
    kinds = [r["kind"] for r in recs]
    # the seed appends four fact batches, each over live deltas, and
    # compacts a live delta
    assert kinds.count("append_fact_rows") >= 4
    assert all(r["live_before"] for r in recs
               if r["kind"] == "append_fact_rows")
    assert any(r["kind"] == "compact" and r["detail"]["dim"] in
               r["live_before"] for r in recs)
    assert {"ingest", "append_rows"} <= set(kinds)
    # no upsert points past its dimension's end, so every path of the JAX
    # engine gives the same answers (the filter kernels and fused_query
    # treat such a row as no match, the probe-then-tail paths clip it)
    assert not any("payloads" in r["detail"] and
                   (r["detail"]["payloads"]
                    >= r["n_rows"][r["detail"]["dim"]]).any() for r in recs)
    assert kinds[LAST_APPEND] == "append_fact_rows"
    assert recs[LAST_APPEND]["jax"]["mega"] is not None


@pytest.mark.parametrize("kernel,path", [(k, p) for k in ("cuda", "torch")
                                         for p in ("cached", "cold",
                                                   "mega")])
@pytest.mark.parametrize("step", range(STEPS))
def test_every_path_matches_jax_after_each_step(stream, step, kernel, path):
    r = stream["records"][step]
    want = r["jax"]["mega"] if path == "mega" else None
    want = want or r["jax"]["cached"]
    _assert_same(r["port"][kernel][path], want,
                 f"step {step} ({r['kind']}) {kernel}/{path}")


@pytest.mark.parametrize("step", range(STEPS))
def test_state_matches_jax_after_each_step(stream, step):
    """Epochs, append counters, capacity and the cached probes over the
    physical rows (padding included) equal the JAX engine's."""
    state = stream["records"][step]["state"]
    jepoch, jfact, jinfo, jcache_epoch, jprobes = state["jax"]
    for k in ("cuda", "torch"):
        epoch, fact, info, cache_epoch, probes = state[k]
        assert (epoch, fact, cache_epoch) == (jepoch, jfact, jcache_epoch), k
        # the port also counts its skew measurements: one a dimension at
        # build, one a dimension at each re-measure
        assert {c: v for c, v in info.items() if c != "skew_measures"} == \
            jinfo, k
        assert info["skew_measures"] >= len(DIMS), k
        assert sorted(probes) == sorted(jprobes), k
        for d, (found, row) in probes.items():
            np.testing.assert_array_equal(found, jprobes[d][0], err_msg=d)
            np.testing.assert_array_equal(row, jprobes[d][1], err_msg=d)


def test_append_reports_and_tables_match_jax(stream):
    jreports = stream["reports"]["jax"]
    assert len(jreports) >= 4
    assert any(r["capacity_grew"] for r in jreports)
    assert all(r["dims"] == {d: "extended" for d in DIMS}
               for r in jreports[:1])
    for k, engine in stream["port"].items():
        assert stream["reports"][k] == jreports, k
        fact, jfact = (engine.tables["lineorder"],
                       stream["jax"].tables["lineorder"])
        assert (fact.n_rows, fact.n_physical) == (jfact.n_rows,
                                                  jfact.n_physical)
        for c in fact.names():
            np.testing.assert_array_equal(fact[c].numpy(),
                                          np.asarray(jfact[c]))
        n = fact.n_rows
        for d in DIMS:
            assert not engine.probe_dim(d)[0][n:].any(), \
                f"{k} {d}: capacity padding joined"
    # the base tables the engines were built on never changed
    base = stream["tables"]["lineorder"]
    assert base.n_rows == base.n_physical == int(6_000_000 * SF)


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


def test_appended_jax_state_carries_across(stream):
    """The JAX engine after the stream (a capacity-padded fact table,
    live deltas) carried across through ``engine/convert.py`` answers as
    its port twin does, with the same capacity, and keeps appending
    alike."""
    jax_engine = stream["jax"]
    host = {name: {c: np.asarray(t[c]) for c in t.names()}
            for name, t in jax_engine.tables.items()}
    valid = {name: t.valid_rows for name, t in jax_engine.tables.items()}
    indexes = {d: dim_index_from_numpy(_index_arrays(ix),
                                       build_stats_from(ix.stats), "cpu")
               for d, ix in jax_engine.indexes.items()}
    for adopt in (indexes, None):
        engine = SSBEngine(tables_from_numpy(host, "cpu", valid),
                           indexes=adopt, device="cpu")
        fact = engine.tables["lineorder"]
        jfact = jax_engine.tables["lineorder"]
        assert (fact.n_rows, fact.n_physical) == (jfact.n_rows,
                                                  jfact.n_physical)
        if adopt is not None:
            twin = stream["port"]["torch"]
            _assert_same(_np(engine.run_all(fusion="composed")),
                         _np(twin.run_all(fusion="composed")), "carried")
            _assert_same(_np({q: engine.run(q, fusion="mega")
                              for q in NAMES}),
                         stream["records"][-1]["jax"]["cached"],
                         "carried mega")
    # the rebuilt (delta-free) engine answers as a trimmed rebuild
    trimmed = SSBEngine(dict(engine.tables,
                             lineorder=engine.tables["lineorder"].trimmed()),
                        device="cpu")
    _assert_same(_np(engine.run_all(fusion="composed")),
                 _np(trimmed.run_all(fusion="composed")), "rebuilt")
    assert engine.build_stats["part"].fact_skew.n == fact.n_rows
