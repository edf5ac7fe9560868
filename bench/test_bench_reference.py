"""The reference against a brute-force NumPy join at SF 0.005, under a
replayed stream of fact appends, dimension row versions and deletes."""
import numpy as np
import pytest
import torch

from bench.datagen import DataGen, WriteGen
from bench.reference.compare import Answer, compare
from bench.reference.replay import LogEntry, Replay
from bench.reference.ssb import DIM_PK, FACT_FK, QUERY_IDS, TEMPLATES

ROWS = {"lineorder": 30_000, "customer": 300, "supplier": 20, "part": 2_000,
        "date": 2556}
CONFIG = {"rows": ROWS,
          "foreign_keys": {"custkey": {"dist": "zipf", "s": 1.0},
                           "partkey": {"dist": "uniform"},
                           "suppkey": {"dist": "zipf", "s": 1.0},
                           "orderdate": {"dist": "uniform"}}}
CYCLE = [{"kind": "fact_append", "rows_frac": 0.01},
         {"kind": "dim_new_version", "dim": "customer", "keys_frac": 0.05},
         {"kind": "dim_delete", "dim": "part", "keys_frac": 0.05},
         {"kind": "dim_new_version", "dim": "supplier", "keys_frac": 0.2},
         {"kind": "dim_delete", "dim": "customer", "keys_frac": 0.05},
         {"kind": "dim_new_version", "dim": "part", "keys_frac": 0.05},
         {"kind": "dim_delete", "dim": "supplier", "keys_frac": 0.2}]
OPS = {"append_fact_rows": "fact_append", "append_rows": "dim_append",
       "upsert": "dim_upsert", "delete": "dim_delete"}


@pytest.fixture(scope="module")
def stream():
    data = DataGen(CONFIG, 7_000_000_001, "cpu")
    fact, dims = data.tables()
    wg = WriteGen(data)
    log = []
    for i in range(2 * len(CYCLE)):
        for call in wg.make(i, CYCLE[i % len(CYCLE)]).calls:
            log.append(LogEntry(OPS[call.api], call.dim, call.arrays,
                                len(log) + 1))
    host = ({k: v.numpy() for k, v in fact.items()},
            {d: {k: v.numpy() for k, v in c.items()} for d, c in dims.items()})
    return fact, dims, log, host


def brute_force(host, log, epoch, name, p):
    """Python dicts for the key maps, a row-by-row join, NumPy sums."""
    fact = {k: v.copy() for k, v in host[0].items()}
    dims = {d: {k: v.copy() for k, v in c.items()} for d, c in host[1].items()}
    maps = {d: {int(k): i for i, k in enumerate(c[DIM_PK[d]])}
            for d, c in dims.items()}
    for e in log:
        if e.epoch > epoch:
            break
        a = e.arrays
        if e.op == "fact_append":
            for k in fact:
                fact[k] = np.concatenate([fact[k], a[k]])
        elif e.op == "dim_append":
            n0 = len(dims[e.dim][DIM_PK[e.dim]])
            for k in dims[e.dim]:
                dims[e.dim][k] = np.concatenate([dims[e.dim][k], a[k]])
            for i, k in enumerate(a[DIM_PK[e.dim]]):
                maps[e.dim][int(k)] = n0 + i
        elif e.op == "dim_upsert":
            for k, r in zip(a["keys"], a["rows"]):
                maps[e.dim][int(k)] = int(r)
        else:
            for k in a["keys"]:
                maps[e.dim].pop(int(k), None)
    t = TEMPLATES[name]
    rows = {d: np.array([maps[d].get(int(k), -1) for k in fact[FACT_FK[d]]])
            for d in t.joined_dims}
    keep = np.ones(len(fact["orderkey"]), bool)
    for d in t.joined_dims:
        keep &= rows[d] >= 0
        if d in t.dim_filters:
            dmask = np.asarray(t.dim_filters[d](dims[d], p))
            keep &= dmask[np.maximum(rows[d], 0)]
    if t.fact_filter is not None:
        keep &= np.asarray(t.fact_filter(fact, p))
    measure = np.asarray(t.measure({k: v.astype(np.int64)
                                    for k, v in fact.items()}))[keep]
    total = int(np.int64(measure.sum()).astype(np.int32))
    if not t.group_by:
        return total, np.array([total], np.int32)
    key = np.zeros(int(keep.sum()), np.int64)
    for d, col, card in t.group_by:
        key = key * card + dims[d][col][rows[d][keep]].astype(np.int64) % card
    groups = np.zeros(t.group_size, np.int64)
    np.add.at(groups, key, measure)
    return total, groups.astype(np.int32)


@pytest.mark.parametrize("name", QUERY_IDS)
def test_reference_matches_brute_force(stream, name):
    fact, dims, log, host = stream
    rng = np.random.default_rng(list(map(ord, name)))
    epochs = [0, 3, len(log) // 2, len(log)]
    replay = Replay(fact, dims, log)
    answers = []
    for epoch in epochs:
        replay.advance_to(epoch)
        for _ in range(2):
            p = TEMPLATES[name].sample(rng)
            total, groups = brute_force(host, log, epoch, name, p)
            got_total, got_groups = replay.answer(TEMPLATES[name], p)
            assert got_total == total
            assert np.array_equal(got_groups, groups)
            answers.append(Answer(name, p, epoch, total, groups))
    # the comparison finds every brute-force answer right, and a changed
    # group wrong
    assert compare(answers, Replay(fact, dims, log))["wrong"] == 0
    bad = answers[-1]
    g = bad.groups.copy()
    g[-1] += 1
    answers[-1] = Answer(bad.name, bad.params, bad.epoch, bad.total, g)
    assert compare(answers, Replay(fact, dims, log))["wrong"] == 1


def test_float32_accumulation_differs_at_scale(stream):
    """The control's float32 sums part from the exact ones once a sum
    passes 2^24 (Q1.1's totals at SF 0.01 do)."""
    fact, dims, log, _ = stream
    replay = Replay(fact, dims, log)
    t = TEMPLATES["Q1.1"]
    p = (1993, 1, 3, 50)
    exact, _ = replay.answer(t, p)
    approx, _ = replay.answer(t, p, acc="float32")
    assert abs(exact) > 2 ** 24
    assert approx != exact


def test_replay_refuses_to_go_back(stream):
    fact, dims, log, _ = stream
    replay = Replay(fact, dims, log)
    replay.advance_to(5)
    with pytest.raises(ValueError):
        replay.advance_to(4)
    assert replay.n_fact > ROWS["lineorder"]
    assert torch.equal(replay.rows("date"), replay.fact["orderdate"])
