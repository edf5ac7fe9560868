"""Star Schema Benchmark data generator (ssb-dbgen-compatible shapes, §4.1).

The port's own copy of ``repro.engine.ssb``'s generator: the same numpy
draws in the same order, so the same ``sf``/``seed`` gives byte-identical
arrays.  Integer-coded columns; row counts follow the paper's linear
scaling: lineorder 6,000,000×SF; customer 30,000×SF; supplier 2,000×SF;
part 200,000×SF; date 2,556 (7 years of days, fixed).
``stream_ssb_fact`` yields the fact table in chunks (the sharded engine's
streamed open), ``generate_fact_batch`` draws one lineorder append batch,
and ``random_mutation`` the mutation stream the differential tests replay.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.engine.table import Table, resolve_device

REGIONS = 5
NATIONS = 25
CITIES = 250
MFGRS = 5
CATEGORIES = 25
BRANDS = 1000
YEARS = (1992, 1998)  # inclusive


def _dates(rng: np.random.Generator) -> dict:
    n = 2556
    datekey = np.arange(n, dtype=np.int32)
    year = (YEARS[0] + datekey // 365).clip(max=YEARS[1]).astype(np.int32)
    month = ((datekey % 365) // 31 + 1).clip(max=12).astype(np.int32)
    return {
        "datekey": datekey,
        "year": year,
        "yearmonthnum": (year * 100 + month).astype(np.int32),
        "weeknuminyear": ((datekey % 365) // 7 + 1).astype(np.int32),
    }


LINEORDER_COLUMNS = ("orderkey", "custkey", "partkey", "suppkey",
                     "orderdate", "quantity", "discount", "extendedprice",
                     "revenue", "supplycost")


def ssb_sizes(sf: float) -> dict[str, int]:
    """Row counts at scale factor ``sf`` (the paper's linear scaling)."""
    return {"lineorder": max(1000, int(6_000_000 * sf)),
            "customer": max(30, int(30_000 * sf)),
            "supplier": max(20, int(2_000 * sf)),
            "part": max(200, int(200_000 * sf)),
            "date": 2556}


def _gen_dims(rng: np.random.Generator, sf: float) -> dict[str, dict]:
    """The four dimension tables, consuming ``rng`` in the fixed order
    (date draws nothing, then customer/supplier geography, then part)."""
    sizes = ssb_sizes(sf)
    n_cust, n_supp, n_part = (sizes["customer"], sizes["supplier"],
                              sizes["part"])
    date = _dates(rng)

    def geo(n):
        region = rng.integers(0, REGIONS, n, dtype=np.int32)
        nation = region * (NATIONS // REGIONS) + rng.integers(
            0, NATIONS // REGIONS, n, dtype=np.int32)
        city = nation * (CITIES // NATIONS) + rng.integers(
            0, CITIES // NATIONS, n, dtype=np.int32)
        return region, nation, city

    c_region, c_nation, c_city = geo(n_cust)
    customer = {
        "custkey": np.arange(n_cust, dtype=np.int32),
        "city": c_city, "nation": c_nation, "region": c_region,
    }
    s_region, s_nation, s_city = geo(n_supp)
    supplier = {
        "suppkey": np.arange(n_supp, dtype=np.int32),
        "city": s_city, "nation": s_nation, "region": s_region,
    }
    mfgr = rng.integers(0, MFGRS, n_part, dtype=np.int32)
    category = mfgr * (CATEGORIES // MFGRS) + rng.integers(
        0, CATEGORIES // MFGRS, n_part, dtype=np.int32)
    brand = category * (BRANDS // CATEGORIES) + rng.integers(
        0, BRANDS // CATEGORIES, n_part, dtype=np.int32)
    part = {
        "partkey": np.arange(n_part, dtype=np.int32),
        "mfgr": mfgr, "category": category, "brand": brand,
    }
    return {"customer": customer, "supplier": supplier, "part": part,
            "date": date}


def _gen_fact(rng: np.random.Generator, n: int, sf: float,
              start_key: int = 0) -> dict[str, np.ndarray]:
    """``n`` lineorder rows, drawing from ``rng`` in the fixed column order
    (measure draws first, then FK draws)."""
    sizes = ssb_sizes(sf)
    quantity = rng.integers(1, 51, n, dtype=np.int32)
    discount = rng.integers(0, 11, n, dtype=np.int32)
    extendedprice = rng.integers(100, 100_000, n, dtype=np.int32)
    supplycost = (extendedprice * 6 // 10).astype(np.int32)
    return {
        "orderkey": np.arange(start_key, start_key + n, dtype=np.int32),
        "custkey": rng.integers(0, sizes["customer"], n, dtype=np.int32),
        "partkey": rng.integers(0, sizes["part"], n, dtype=np.int32),
        "suppkey": rng.integers(0, sizes["supplier"], n, dtype=np.int32),
        "orderdate": rng.integers(0, sizes["date"], n, dtype=np.int32),
        "quantity": quantity,
        "discount": discount,
        "extendedprice": extendedprice,
        "revenue": (extendedprice * (100 - discount) // 100).astype(np.int32),
        "supplycost": supplycost,
    }


def generate_ssb(sf: float, seed: int = 0, device=None) -> dict[str, Table]:
    """Generate the five SSB tables at scale factor ``sf`` on ``device``
    (default: the CUDA card; raises ``RuntimeError`` if there is none)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    dims = _gen_dims(rng, sf)
    lineorder = _gen_fact(rng, ssb_sizes(sf)["lineorder"], sf)
    return {
        "lineorder": Table.from_numpy(lineorder, dev),
        "customer": Table.from_numpy(dims["customer"], dev),
        "supplier": Table.from_numpy(dims["supplier"], dev),
        "part": Table.from_numpy(dims["part"], dev),
        "date": Table.from_numpy(dims["date"], dev),
    }


def generate_ssb_dims(sf: float, seed: int = 0,
                      device=None) -> dict[str, Table]:
    """The four dimension tables only, identical to ``generate_ssb``'s
    (same rng stream prefix), without drawing the fact table."""
    dev = resolve_device(device)
    dims = _gen_dims(np.random.default_rng(seed), sf)
    return {name: Table.from_numpy(cols, dev) for name, cols in dims.items()}


def stream_ssb_fact(sf: float, seed: int = 0, *,
                    chunk_rows: int = 1 << 20):
    """Yield the SF-``sf`` lineorder table as append-ready host chunks.

    Never materializes the full fact table: chunk ``i`` draws from its own
    rng (``default_rng((seed, i))``), so the stream is fully determined by
    ``(sf, seed, chunk_rows)``, equals the JAX package's chunk for chunk,
    and any consumer sees the same rows.  It is a different sample than
    ``generate_ssb``'s single-draw fact table.  Chunks are numpy dicts:
    the consumer picks the device.
    """
    n_lo = ssb_sizes(sf)["lineorder"]
    start = 0
    i = 0
    while start < n_lo:
        n = min(int(chunk_rows), n_lo - start)
        rng = np.random.default_rng((seed, i))
        yield _gen_fact(rng, n, sf, start_key=start)
        start += n
        i += 1


def generate_fact_batch(tables, n: int,
                        rng: np.random.Generator) -> dict[str, np.ndarray]:
    """One lineorder append batch against the current tables, with the
    JAX package's draws: FK columns re-sample live fact rows (keeping the
    generated skew), measures are drawn fresh.  The sampled rows are
    gathered where the table lives; only the batch crosses to the host.
    It samples the first ``n_rows`` rows, so draw from an unsharded
    engine's tables: a sharded engine's live rows are not a prefix."""
    fact = tables["lineorder"]
    idx = rng.integers(0, fact.n_rows, n)
    sel = torch.as_tensor(idx, device=fact.device)
    cols = {k: fact[k][sel].cpu().numpy() for k in fact.names()}
    q = rng.integers(1, 51, n, dtype=np.int32)
    d = rng.integers(0, 11, n, dtype=np.int32)
    ep = rng.integers(100, 100_000, n, dtype=np.int32)
    cols["orderkey"] = np.arange(fact.n_rows, fact.n_rows + n,
                                 dtype=np.int32)
    cols["quantity"], cols["discount"], cols["extendedprice"] = q, d, ep
    cols["revenue"] = (ep * (100 - d) // 100).astype(np.int32)
    cols["supplycost"] = (ep * 6 // 10).astype(np.int32)
    return cols


def random_mutation(engine, rng: np.random.Generator, *,
                    fact_batch: int = 64,
                    kinds=("append_fact_rows", "ingest", "delete",
                           "append_rows", "compact")) -> tuple[str, dict]:
    """Draw one randomized mutation, apply it to ``engine`` and return
    ``(kind, detail)`` so that a differential harness can mirror it.

    The JAX package's ``random_mutation``: fact appends of ``fact_batch``
    rows, dimension upserts (some re-pointed past the table's end),
    deletes, dimension growth and compaction.  It makes the same ``rng``
    draws, so one seed and the same ``kinds`` give the same stream in both
    packages.  Every ingest runs with ``auto_compact=False``.
    """
    from repro_torch.engine.queries import DIM_PK

    kind = kinds[int(rng.integers(0, len(kinds)))]
    dim = ("customer", "supplier", "part",
           "date")[int(rng.integers(0, 4))]
    if kind == "append_fact_rows":
        cols = generate_fact_batch(engine.tables, fact_batch, rng)
        engine.append_fact_rows(cols)
        return kind, {"rows": cols}
    if kind in ("ingest", "delete"):
        pk = engine.tables[dim][DIM_PK[dim]].cpu().numpy()
        n = int(rng.integers(1, 9))
        keys = pk[rng.integers(0, pk.shape[0], n)].astype(np.int32)
        if kind == "delete":
            engine.ingest(dim, keys, op="delete", auto_compact=False)
            return "ingest", {"dim": dim, "op": "delete", "keys": keys}
        # re-point: mostly valid rows, sometimes past the table end
        hi = pk.shape[0] + (4 if rng.integers(0, 4) == 0 else 0)
        pays = rng.integers(0, max(hi, 1), n, dtype=np.int32)
        op = "upsert" if rng.integers(0, 2) else "insert"
        engine.ingest(dim, keys, pays, op=op, auto_compact=False)
        return "ingest", {"dim": dim, "op": op, "keys": keys,
                          "payloads": pays}
    if kind == "append_rows":
        t = engine.tables[dim]
        n = int(rng.integers(1, 4))
        base = int(t[DIM_PK[dim]].max()) + 1
        src = rng.integers(0, t.n_rows, n)
        rows = {k: t[k].cpu().numpy()[src] for k in t.names()}
        rows[DIM_PK[dim]] = np.arange(base, base + n, dtype=np.int32)
        engine.append_rows(dim, rows, auto_compact=False)
        return kind, {"dim": dim, "rows": rows}
    if kind != "compact":
        raise ValueError(f"unknown mutation kind {kind!r}")
    engine.compact(dim)
    return "compact", {"dim": dim}
