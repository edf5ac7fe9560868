"""The generator: determinism per seed, the SSB shapes, the Zipf ranks, and
the refresh batches."""
import numpy as np
import pytest
import torch

from bench.datagen import DataGen, KeyDist, WriteGen, generator, sub_seed
from bench.harness import client_stream
from bench.reference.ssb import DIM_COLUMNS, FACT_COLUMNS, QUERY_IDS

ROWS = {"lineorder": 30_000, "customer": 300, "supplier": 20, "part": 2_000,
        "date": 2556}
ZIPF = {"custkey": {"dist": "zipf", "s": 1.0},
        "partkey": {"dist": "zipf", "s": 1.0},
        "suppkey": {"dist": "zipf", "s": 1.0},
        "orderdate": {"dist": "uniform"}}
UNIFORM = {k: {"dist": "uniform"} for k in ZIPF}
BIG_SEED = 2 ** 31 + 12_345


def tables(fks, seed):
    return DataGen({"rows": ROWS, "foreign_keys": fks}, seed, "cpu").tables()


@pytest.mark.parametrize("fks", [UNIFORM, ZIPF], ids=["uniform", "zipf"])
def test_same_seed_same_tables_other_seed_other(fks):
    f1, d1 = tables(fks, BIG_SEED)
    f2, d2 = tables(fks, BIG_SEED)
    f3, _ = tables(fks, BIG_SEED + 1)
    assert all(torch.equal(f1[k], f2[k]) for k in FACT_COLUMNS)
    assert all(torch.equal(d1[d][k], d2[d][k])
               for d in DIM_COLUMNS for k in DIM_COLUMNS[d])
    assert not torch.equal(f1["custkey"], f3["custkey"])


def test_ssb_shapes():
    fact, dims = tables(UNIFORM, 3)
    assert list(fact) == list(FACT_COLUMNS)
    assert {d: list(c) for d, c in dims.items()} == \
        {d: list(c) for d, c in DIM_COLUMNS.items()}
    for d, n in ROWS.items():
        cols = fact if d == "lineorder" else dims[d]
        assert all(v.shape == (n,) and v.dtype == torch.int32
                   for v in cols.values())
    assert torch.equal(fact["orderkey"], torch.arange(ROWS["lineorder"],
                                                      dtype=torch.int32))
    for d in ("customer", "supplier", "part"):
        key = dims[d][DIM_COLUMNS[d][0]]
        assert torch.equal(key, torch.arange(ROWS[d], dtype=torch.int32))
        fk = fact[{"customer": "custkey", "supplier": "suppkey",
                   "part": "partkey"}[d]]
        assert int(fk.min()) >= 0 and int(fk.max()) < ROWS[d]
    c = dims["customer"]
    assert torch.equal(c["nation"] // 5, c["region"])
    assert torch.equal(c["city"] // 10, c["nation"])
    p = dims["part"]
    assert torch.equal(p["category"] // 5, p["mfgr"])
    assert torch.equal(p["brand"] // 40, p["category"])
    assert torch.equal(fact["revenue"], fact["extendedprice"]
                       * (100 - fact["discount"]) // 100)
    assert int(fact["quantity"].min()) >= 1 and int(fact["quantity"].max()) <= 50
    assert int(fact["discount"].max()) <= 10
    assert int(dims["date"]["year"].min()) == 1992
    assert int(dims["date"]["year"].max()) == 1998


def test_zipf_ranks_map_through_the_seeded_permutation():
    n, m = 1_000, 400_000
    dist = KeyDist(n, {"dist": "zipf", "s": 1.0}, BIG_SEED, "custkey", "cpu")
    keys = dist.draw(m, generator(torch.device("cpu"), BIG_SEED, "t"))
    counts = torch.bincount(keys.long(), minlength=n).double()
    by_rank = counts[dist.perm.long()]   # count of the key of each rank
    harmonic = float((1.0 / torch.arange(1, n + 1).double()).sum())
    expect = m / harmonic / torch.arange(1, n + 1).double()
    # the hottest ranks follow 1/r within sampling noise
    assert torch.allclose(by_rank[:10], expect[:10], rtol=0.05)
    # the permutation is a permutation, and another seed maps ranks elsewhere
    assert torch.equal(dist.perm.sort().values, torch.arange(n,
                                                             dtype=torch.int32))
    other = KeyDist(n, {"dist": "zipf", "s": 1.0}, BIG_SEED + 1, "custkey",
                    "cpu")
    assert not torch.equal(dist.perm, other.perm)


def test_sub_seeds_take_large_seeds_and_separate_streams():
    assert sub_seed(2 ** 40 + 3, "a") != sub_seed(2 ** 40 + 3, "b")
    assert sub_seed(2 ** 40 + 3, "a") == sub_seed(2 ** 40 + 3, "a")
    assert 0 <= sub_seed(-5, "a") < 2 ** 63


def test_refresh_batches_are_deterministic_and_consistent():
    cycle = [{"kind": "fact_append", "rows_frac": 0.001},
             {"kind": "dim_new_version", "dim": "part", "keys_frac": 0.01},
             {"kind": "dim_delete", "dim": "customer", "keys_frac": 0.01}]

    def make():
        wg = WriteGen(DataGen({"rows": ROWS, "foreign_keys": ZIPF},
                              BIG_SEED, "cpu"))
        return [wg.make(i, cycle[i % 3]) for i in range(6)]

    a, b = make(), make()
    for wa, wb in zip(a, b):
        for ca, cb in zip(wa.calls, wb.calls):
            assert ca.api == cb.api
            assert all(np.array_equal(ca.arrays[k], cb.arrays[k])
                       for k in ca.arrays)
    fact0, fact1 = a[0].calls[0].arrays, a[3].calls[0].arrays
    assert fact0["orderkey"][0] == ROWS["lineorder"]
    assert fact1["orderkey"][0] == ROWS["lineorder"] + 30
    rows, upsert = a[1].calls[0].arrays, a[1].calls[1].arrays
    assert rows["partkey"][0] == ROWS["part"]        # fresh keys
    assert upsert["rows"][0] == ROWS["part"]          # the new rows
    assert len(set(upsert["keys"].tolist())) == len(upsert["keys"]) == 20
    assert int(upsert["keys"].max()) < ROWS["part"]   # existing keys
    assert a[4].calls[1].arrays["rows"][0] == ROWS["part"] + 20


def test_clients_send_every_query_in_each_round():
    s = client_stream(BIG_SEED, 3)
    first = [next(s) for _ in range(2 * len(QUERY_IDS))]
    assert sorted(n for n, _ in first[:13]) == sorted(QUERY_IDS)
    assert sorted(n for n, _ in first[13:]) == sorted(QUERY_IDS)
    again = client_stream(BIG_SEED, 3)
    assert [next(again) for _ in range(26)] == first
    assert [next(client_stream(BIG_SEED, 4)) for _ in range(1)] != first[:1]
