"""SSB data and refresh batches, drawn on the device from ``--seed``.

The shapes and distributions of SSB's generator as the system's own
``engine/ssb.py`` draws them: integer-coded dimensions (customer and
supplier geography region -> nation -> city, part mfgr -> category ->
brand, seven years of dates) and lineorder rows with uniform measures.
A configuration's ``foreign_keys`` gives each foreign key's distribution:
``uniform`` over the dimension's keys, or a bounded ``zipf`` of exponent
``s`` over them, with ranks mapped to keys by a seeded permutation.

Every column draws from its own generator, seeded from ``(seed, tag)``,
so the same seed gives the same tables on the same device, in a few large
calls on the device (a Zipf distribution's CDF, one value per key, is
summed on the host, where the sum's order is fixed).  The refresh batches
are drawn the same way, one generator per write, and handed to the system
as host arrays.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from bench.reference.ssb import (BRANDS, CATEGORIES, CITIES, DATE_ROWS,
                                  DIM_COLUMNS, DIM_PK, FACT_COLUMNS, FACT_FK,
                                  MFGRS, NATIONS, REGIONS, YEARS)

# elements drawn per step of a Zipf draw (bounds its float64 temporaries)
CHUNK = 1 << 24


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for the stream named by ``tags`` under ``seed``."""
    words = [int(seed) % (1 << 64)]
    words += [zlib.crc32(str(t).encode()) for t in tags]
    a, b = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(a) << 31) ^ int(b)


def generator(device: torch.device, seed: int, *tags) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, *tags))
    return g


def _randint(lo: int, hi: int, n: int, g: torch.Generator) -> torch.Tensor:
    return torch.randint(lo, hi, (n,), generator=g, device=g.device,
                         dtype=torch.int32)


class KeyDist:
    """A foreign key's distribution over ``n`` dimension keys 0..n-1."""

    def __init__(self, n: int, spec: dict, seed: int, fk: str,
                 device: torch.device):
        self.n = int(n)
        self.kind = spec["dist"]
        if self.kind == "uniform":
            return
        if self.kind != "zipf":
            raise ValueError(f"{fk}: unknown distribution {self.kind!r}")
        # the CDF is summed on the host: a float64 cumsum on the card may
        # round differently from one call to the next, and a rank drawn
        # near a step would then map to another key
        w = np.arange(1, self.n + 1, dtype=np.float64) ** -float(spec["s"])
        cdf = np.cumsum(w)
        self.cdf = torch.as_tensor(cdf / cdf[-1], device=device)
        self.perm = torch.randperm(
            self.n, generator=generator(device, seed, "zipf-perm", fk),
            device=device, dtype=torch.int32)

    def draw(self, m: int, g: torch.Generator) -> torch.Tensor:
        if self.kind == "uniform":
            return _randint(0, self.n, m, g)
        out = torch.empty(m, dtype=torch.int32, device=g.device)
        for lo in range(0, m, CHUNK):
            c = min(CHUNK, m - lo)
            u = torch.rand(c, generator=g, dtype=torch.float64,
                           device=g.device)
            rank = torch.searchsorted(self.cdf, u, right=True)
            out[lo:lo + c] = self.perm[rank.clamp_(max=self.n - 1)]
        return out


def _dates(device: torch.device) -> dict[str, torch.Tensor]:
    datekey = torch.arange(DATE_ROWS, dtype=torch.int32, device=device)
    year = (YEARS[0] + datekey // 365).clamp(max=YEARS[1])
    month = ((datekey % 365) // 31 + 1).clamp(max=12)
    return {"datekey": datekey, "year": year,
            "yearmonthnum": year * 100 + month,
            "weeknuminyear": (datekey % 365) // 7 + 1}


def dim_rows(dim: str, n: int, g: torch.Generator, first_key: int = 0
             ) -> dict[str, torch.Tensor]:
    """``n`` rows of a customer, supplier or part table with keys
    ``first_key..first_key+n-1``."""
    key = torch.arange(first_key, first_key + n, dtype=torch.int32,
                       device=g.device)
    if dim == "part":
        mfgr = _randint(0, MFGRS, n, g)
        category = mfgr * (CATEGORIES // MFGRS) + _randint(
            0, CATEGORIES // MFGRS, n, g)
        brand = category * (BRANDS // CATEGORIES) + _randint(
            0, BRANDS // CATEGORIES, n, g)
        return {"partkey": key, "mfgr": mfgr, "category": category,
                "brand": brand}
    region = _randint(0, REGIONS, n, g)
    nation = region * (NATIONS // REGIONS) + _randint(
        0, NATIONS // REGIONS, n, g)
    city = nation * (CITIES // NATIONS) + _randint(0, CITIES // NATIONS, n, g)
    return {DIM_PK[dim]: key, "city": city, "nation": nation,
            "region": region}


def fact_rows(n: int, first_key: int, fks: dict[str, KeyDist],
              dev: torch.device, seed: int, *tags) -> dict[str, torch.Tensor]:
    """``n`` lineorder rows with order keys from ``first_key``: foreign
    keys from ``fks``, measures uniform as SSB draws them."""
    def g(col):
        return generator(dev, seed, *tags, col)

    quantity = _randint(1, 51, n, g("quantity"))
    discount = _randint(0, 11, n, g("discount"))
    price = _randint(100, 100_000, n, g("extendedprice"))
    cols = {
        "orderkey": torch.arange(first_key, first_key + n, dtype=torch.int32,
                                 device=dev),
        "quantity": quantity, "discount": discount, "extendedprice": price,
        "revenue": price * (100 - discount) // 100,
        "supplycost": price * 6 // 10,
    }
    for fk, dist in fks.items():
        cols[fk] = dist.draw(n, g(fk))
    return {k: cols[k] for k in FACT_COLUMNS}


class DataGen:
    """One configuration's data under one seed."""

    def __init__(self, config: dict, seed: int, device):
        self.config = config
        self.seed = int(seed)
        self.device = torch.device(device)
        self.rows = {k: int(v) for k, v in config["rows"].items()}
        if self.rows["date"] != DATE_ROWS:
            raise ValueError(f"date has {DATE_ROWS} rows in SSB")
        self._fks = None

    def fks(self) -> dict:
        if self._fks is None:
            specs = self.config["foreign_keys"]
            self._fks = {FACT_FK[d]: KeyDist(self.rows[d], specs[FACT_FK[d]],
                                             self.seed, FACT_FK[d],
                                             self.device)
                         for d in DIM_COLUMNS}
        return self._fks

    def release(self) -> None:
        """Drop the distributions' device tables."""
        self._fks = None

    def tables(self) -> tuple[dict, dict]:
        """``(fact columns, {dimension: columns})``, int32 on the device."""
        dims = {d: dim_rows(d, self.rows[d],
                            generator(self.device, self.seed, "dim", d))
                for d in ("customer", "supplier", "part")}
        dims["date"] = _dates(self.device)
        fact = fact_rows(self.rows["lineorder"], 0, self.fks(), self.device,
                         self.seed, "fact")
        return fact, dims


@dataclasses.dataclass
class Call:
    """One call into the system's write API, with host arrays."""

    api: str        # append_fact_rows | append_rows | upsert | delete | compact
    dim: str | None
    arrays: dict
    auto_compact: bool = True


@dataclasses.dataclass
class Write:
    """One write of the refresh traffic: one or two API calls."""

    index: int
    kind: str
    dim: str | None
    calls: list[Call]


def _host(cols: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in cols.items()}


def _count(frac: float, n: int) -> int:
    return max(1, int(round(frac * n)))


class WriteGen:
    """The refresh batches, in write order.  A write's batch depends on
    ``(seed, index)`` and on the rows and keys the writes before it added,
    which this generator counts itself."""

    def __init__(self, data: DataGen):
        self.data = data
        self.n_fact = data.rows["lineorder"]
        self.next_key = {d: data.rows[d] for d in ("customer", "supplier",
                                                   "part")}
        self.dim_rows = dict(self.next_key)

    def make(self, index: int, spec: dict) -> Write:
        data, dev, seed = self.data, self.data.device, self.data.seed
        kind = spec["kind"]
        if kind == "fact_append":
            m = _count(spec["rows_frac"], data.rows["lineorder"])
            cols = fact_rows(m, self.n_fact, data.fks(), dev, seed, "write",
                             index)
            self.n_fact += m
            return Write(index, kind, None,
                         [Call("append_fact_rows", None, _host(cols))])
        dim = spec["dim"]
        if kind == "compact":
            return Write(index, kind, dim, [Call("compact", dim, {})])
        ac = bool(spec.get("auto_compact", True))
        n_dim = data.rows[dim]
        k = _count(spec["keys_frac"], n_dim)
        g = generator(dev, seed, "write", index)
        keys = torch.randperm(n_dim, generator=g, device=dev,
                              dtype=torch.int32)[:k].cpu().numpy()
        if kind == "dim_delete":
            return Write(index, kind, dim,
                         [Call("delete", dim, {"keys": keys}, ac)])
        if kind != "dim_new_version":
            raise ValueError(f"unknown write kind {kind!r}")
        rows = _host(dim_rows(dim, k, g, self.next_key[dim]))
        first_row = self.dim_rows[dim]
        self.next_key[dim] += k
        self.dim_rows[dim] += k
        return Write(index, kind, dim, [
            Call("append_rows", dim, rows, ac),
            Call("upsert", dim, {"keys": keys, "rows": np.arange(
                first_row, first_row + k, dtype=np.int32)}, ac)])
