"""The Star Schema Benchmark's schema and its 13 query templates.

A frozen copy for the benchmark's reference: SSB's queries Q1.1-Q4.3
(O'Neil, O'Neil, Chen, Revilak, SSB rev. 3) over the integer-coded schema
the system serves, each with its predicates lifted to a parameter vector
and with SSB's parameter substitution rules as ``sample``.

A filter takes ``(columns, p)``: a mapping of column name to tensor and a
tuple of ints.  It uses only subscripts, comparisons and ``&``/``|``, so it
runs on torch tensors of any device.  ``measure`` gives the value each fact
row adds, ``group_by`` the ``(dimension, column, cardinality)`` digits of
the dense group key (each digit is the column value modulo the
cardinality, most significant first).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

REGIONS = 5
NATIONS = 25
CITIES = 250
MFGRS = 5
CATEGORIES = 25
BRANDS = 1000
YEARS = (1992, 1998)  # inclusive
DATE_ROWS = 2556      # seven years of days

FACT_COLUMNS = ("orderkey", "custkey", "partkey", "suppkey", "orderdate",
                "quantity", "discount", "extendedprice", "revenue",
                "supplycost")
DIM_COLUMNS = {
    "customer": ("custkey", "city", "nation", "region"),
    "supplier": ("suppkey", "city", "nation", "region"),
    "part": ("partkey", "mfgr", "category", "brand"),
    "date": ("datekey", "year", "yearmonthnum", "weeknuminyear"),
}
FACT_FK = {"customer": "custkey", "supplier": "suppkey", "part": "partkey",
           "date": "orderdate"}
DIM_PK = {d: cols[0] for d, cols in DIM_COLUMNS.items()}


@dataclasses.dataclass(frozen=True)
class Template:
    """One SSB query with its predicates as functions of a parameter
    vector."""

    name: str
    dim_filters: dict[str, Callable]
    fact_filter: Callable | None
    measure: Callable
    group_by: tuple[tuple[str, str, int], ...]
    sampler: Callable[[np.random.Generator], tuple[int, ...]]

    @property
    def joined_dims(self) -> tuple[str, ...]:
        return tuple(sorted(set(self.dim_filters)
                            | {d for d, _, _ in self.group_by}))

    @property
    def group_size(self) -> int:
        size = 1
        for _, _, card in self.group_by:
            size *= card
        return size

    def sample(self, rng: np.random.Generator) -> tuple[int, ...]:
        return tuple(int(v) for v in self.sampler(rng))


TEMPLATES: dict[str, Template] = {}


def _t(name, dim_filters, fact_filter, measure, group_by, sampler):
    TEMPLATES[name] = Template(name, dim_filters, fact_filter, measure,
                               tuple(group_by), sampler)


def _discounted(t):
    return t["extendedprice"] * t["discount"]


def _revenue(t):
    return t["revenue"]


def _profit(t):
    return t["revenue"] - t["supplycost"]


def _year(rng):
    return int(rng.integers(YEARS[0], YEARS[1] + 1))


def _ym(rng):
    return _year(rng) * 100 + int(rng.integers(1, 13))


def _year_range(rng):
    lo = _year(rng)
    return lo, int(rng.integers(lo, YEARS[1] + 1))


def _discount_band(rng):
    d = int(rng.integers(0, 9))
    return d, d + 2


def _quantity_band(rng):
    q = int(rng.integers(1, 41))
    return q, q + 9


_BY_YEAR_BRAND = [("date", "year", 7), ("part", "brand", 1000)]

# --- Q1.x: one date join, filters on the fact table --------------------------
_t("Q1.1", {"date": lambda t, p: t["year"] == p[0]},
   lambda t, p: ((t["discount"] >= p[1]) & (t["discount"] <= p[2])
                 & (t["quantity"] < p[3])),
   _discounted, (),
   lambda rng: (_year(rng), *_discount_band(rng),
                int(rng.integers(10, 51))))
_t("Q1.2", {"date": lambda t, p: t["yearmonthnum"] == p[0]},
   lambda t, p: ((t["discount"] >= p[1]) & (t["discount"] <= p[2])
                 & (t["quantity"] >= p[3]) & (t["quantity"] <= p[4])),
   _discounted, (),
   lambda rng: (_ym(rng), *_discount_band(rng), *_quantity_band(rng)))
_t("Q1.3", {"date": lambda t, p: ((t["weeknuminyear"] == p[0])
                                  & (t["year"] == p[1]))},
   lambda t, p: ((t["discount"] >= p[2]) & (t["discount"] <= p[3])
                 & (t["quantity"] >= p[4]) & (t["quantity"] <= p[5])),
   _discounted, (),
   lambda rng: (int(rng.integers(1, 53)), _year(rng), *_discount_band(rng),
                *_quantity_band(rng)))
# --- Q2.x: part, supplier, date ----------------------------------------------
_t("Q2.1", {"part": lambda t, p: t["category"] == p[0],
            "supplier": lambda t, p: t["region"] == p[1]},
   None, _revenue, _BY_YEAR_BRAND,
   lambda rng: (int(rng.integers(0, CATEGORIES)),
                int(rng.integers(0, REGIONS))))
_t("Q2.2", {"part": lambda t, p: (t["brand"] >= p[0]) & (t["brand"] <= p[1]),
            "supplier": lambda t, p: t["region"] == p[2]},
   None, _revenue, _BY_YEAR_BRAND,
   lambda rng: ((b := int(rng.integers(0, BRANDS - 7))), b + 7,
                int(rng.integers(0, REGIONS))))
_t("Q2.3", {"part": lambda t, p: t["brand"] == p[0],
            "supplier": lambda t, p: t["region"] == p[1]},
   None, _revenue, _BY_YEAR_BRAND,
   lambda rng: (int(rng.integers(0, BRANDS)),
                int(rng.integers(0, REGIONS))))
# --- Q3.x: customer, supplier, date ------------------------------------------
_t("Q3.1", {"customer": lambda t, p: t["region"] == p[0],
            "supplier": lambda t, p: t["region"] == p[1],
            "date": lambda t, p: (t["year"] >= p[2]) & (t["year"] <= p[3])},
   None, _revenue,
   [("customer", "nation", 25), ("supplier", "nation", 25),
    ("date", "year", 7)],
   lambda rng: (int(rng.integers(0, REGIONS)),
                int(rng.integers(0, REGIONS)), *_year_range(rng)))
_t("Q3.2", {"customer": lambda t, p: t["nation"] == p[0],
            "supplier": lambda t, p: t["nation"] == p[1],
            "date": lambda t, p: (t["year"] >= p[2]) & (t["year"] <= p[3])},
   None, _revenue,
   [("customer", "city", 250), ("supplier", "city", 250),
    ("date", "year", 7)],
   lambda rng: (int(rng.integers(0, NATIONS)),
                int(rng.integers(0, NATIONS)), *_year_range(rng)))
_t("Q3.3", {"customer": lambda t, p: (t["city"] == p[0]) | (t["city"] == p[1]),
            "supplier": lambda t, p: (t["city"] == p[0]) | (t["city"] == p[1]),
            "date": lambda t, p: (t["year"] >= p[2]) & (t["year"] <= p[3])},
   None, _revenue,
   [("customer", "city", 250), ("supplier", "city", 250),
    ("date", "year", 7)],
   lambda rng: (int(rng.integers(0, CITIES)), int(rng.integers(0, CITIES)),
                *_year_range(rng)))
_t("Q3.4", {"customer": lambda t, p: (t["city"] == p[0]) | (t["city"] == p[1]),
            "supplier": lambda t, p: (t["city"] == p[0]) | (t["city"] == p[1]),
            "date": lambda t, p: t["yearmonthnum"] == p[2]},
   None, _revenue,
   [("customer", "city", 250), ("supplier", "city", 250),
    ("date", "year", 7)],
   lambda rng: (int(rng.integers(0, CITIES)), int(rng.integers(0, CITIES)),
                _ym(rng)))
# --- Q4.x: all four dimensions -----------------------------------------------
_t("Q4.1", {"customer": lambda t, p: t["region"] == p[0],
            "supplier": lambda t, p: t["region"] == p[1],
            "part": lambda t, p: (t["mfgr"] == p[2]) | (t["mfgr"] == p[3])},
   None, _profit, [("date", "year", 7), ("customer", "nation", 25)],
   lambda rng: (int(rng.integers(0, REGIONS)), int(rng.integers(0, REGIONS)),
                int(rng.integers(0, MFGRS)), int(rng.integers(0, MFGRS))))
_t("Q4.2", {"customer": lambda t, p: t["region"] == p[0],
            "supplier": lambda t, p: t["region"] == p[1],
            "part": lambda t, p: (t["mfgr"] == p[2]) | (t["mfgr"] == p[3]),
            "date": lambda t, p: (t["year"] == p[4]) | (t["year"] == p[5])},
   None, _profit,
   [("date", "year", 7), ("supplier", "nation", 25),
    ("part", "category", 25)],
   lambda rng: (int(rng.integers(0, REGIONS)), int(rng.integers(0, REGIONS)),
                int(rng.integers(0, MFGRS)), int(rng.integers(0, MFGRS)),
                (y := _year(rng)), min(y + 1, YEARS[1])))
_t("Q4.3", {"customer": lambda t, p: t["region"] == p[0],
            "supplier": lambda t, p: t["nation"] == p[1],
            "part": lambda t, p: t["category"] == p[2],
            "date": lambda t, p: (t["year"] == p[3]) | (t["year"] == p[4])},
   None, _profit,
   [("date", "year", 7), ("supplier", "city", 250), ("part", "brand", 1000)],
   lambda rng: (int(rng.integers(0, REGIONS)), int(rng.integers(0, NATIONS)),
                int(rng.integers(0, CATEGORIES)),
                (y := _year(rng)), min(y + 1, YEARS[1])))

QUERY_IDS = tuple(sorted(TEMPLATES))
