"""Parameterized SSB queries: one int32 vector per request.

PyTorch port of ``repro.serving.params``.  The serving tier batches
*compatible* requests (same query id, different predicate constants) into
one dispatch that evaluates the shared filter -> mask -> measure ->
segment-sum tail for every parameter vector at once.  That needs each
query's predicates as functions of a parameter vector instead of baked-in
constants: :class:`ParamQuery` carries those functions, the canonical
defaults (binding them reproduces ``SSB_QUERIES`` bit for bit) and a
``sample`` rule drawing valid variations for traffic generation, with the
JAX package's numpy draws.

The filter callables take ``(table, p)`` and use only subscripting and
comparison / bitwise operators, so the *same* functions run on tensors
with python ints (the composed path), on tensors with ``(B, 1)`` parameter
columns (the batched path: every predicate broadcasts to ``(B, rows)``),
and on numpy arrays with python ints (the host oracle,
``serving/oracle.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.engine.queries import SSB_QUERIES, QuerySpec
from repro_torch.engine.ssb import (BRANDS, CATEGORIES, CITIES, MFGRS, NATIONS,
                              REGIONS, YEARS)


@dataclasses.dataclass(frozen=True)
class ParamQuery:
    """One SSB query id with its predicates lifted to a parameter vector.

    ``dim_filters`` / ``fact_filter`` take ``(table, p)`` where ``p`` is
    any integer-indexable vector: a tuple of ints, or a sequence of
    ``(B, 1)`` tensors (one column per parameter) that broadcasts every
    predicate to one row per request; ``measure`` / ``group_by`` are
    inherited from the base spec.
    """

    name: str
    params: tuple[str, ...]
    defaults: tuple[int, ...]
    dim_filters: dict[str, Callable]
    fact_filter: Callable | None
    sampler: Callable[[np.random.Generator], tuple[int, ...]]

    def bind(self, p) -> QuerySpec:
        """A :class:`QuerySpec` with every predicate closed over ``p``."""
        base = SSB_QUERIES[self.name]
        df = {d: (lambda t, _f=f: _f(t, p))
              for d, f in self.dim_filters.items()}
        ff = None if self.fact_filter is None else \
            (lambda t, _f=self.fact_filter: _f(t, p))
        return QuerySpec(self.name, df, ff, base.measure, base.group_by)

    def sample(self, rng: np.random.Generator) -> tuple[int, ...]:
        """A random valid parameter vector (traffic generation)."""
        out = tuple(int(v) for v in self.sampler(rng))
        assert len(out) == len(self.params), (self.name, out)
        return out

    @property
    def n_params(self) -> int:
        return len(self.params)


PARAM_QUERIES: dict[str, ParamQuery] = {}


def _pq(name, params, defaults, dim_filters, fact_filter, sampler):
    assert name in SSB_QUERIES, name
    assert len(params) == len(defaults), name
    PARAM_QUERIES[name] = ParamQuery(name, tuple(params), tuple(defaults),
                                     dim_filters, fact_filter, sampler)


def _year(rng):
    return int(rng.integers(YEARS[0], YEARS[1] + 1))


def _ym(rng):
    return _year(rng) * 100 + int(rng.integers(1, 13))


def _year_range(rng):
    lo = _year(rng)
    return lo, int(rng.integers(lo, YEARS[1] + 1))


# --- Q1.x: filter-heavy, single date join -------------------------------
_pq("Q1.1", ("year", "discount_lo", "discount_hi", "quantity_max"),
    (1993, 1, 3, 25),
    {"date": lambda t, p: t["year"] == p[0]},
    lambda t, p: ((t["discount"] >= p[1]) & (t["discount"] <= p[2])
                  & (t["quantity"] < p[3])),
    lambda rng: (_year(rng), (d := int(rng.integers(0, 9))), d + 2,
                 int(rng.integers(10, 51))))
_pq("Q1.2", ("yearmonthnum", "discount_lo", "discount_hi",
             "quantity_lo", "quantity_hi"),
    (199401, 4, 6, 26, 35),
    {"date": lambda t, p: t["yearmonthnum"] == p[0]},
    lambda t, p: ((t["discount"] >= p[1]) & (t["discount"] <= p[2])
                  & (t["quantity"] >= p[3]) & (t["quantity"] <= p[4])),
    lambda rng: (_ym(rng), (d := int(rng.integers(0, 9))), d + 2,
                 (q := int(rng.integers(1, 41))), q + 9))
_pq("Q1.3", ("weeknuminyear", "year", "discount_lo", "discount_hi",
             "quantity_lo", "quantity_hi"),
    (6, 1994, 5, 7, 26, 35),
    {"date": lambda t, p: ((t["weeknuminyear"] == p[0])
                           & (t["year"] == p[1]))},
    lambda t, p: ((t["discount"] >= p[2]) & (t["discount"] <= p[3])
                  & (t["quantity"] >= p[4]) & (t["quantity"] <= p[5])),
    lambda rng: (int(rng.integers(1, 53)), _year(rng),
                 (d := int(rng.integers(0, 9))), d + 2,
                 (q := int(rng.integers(1, 41))), q + 9))
# --- Q2.x: part ⋈ supplier ⋈ date ----------------------------------------
_pq("Q2.1", ("p_category", "s_region"), (12, 1),
    {"part": lambda t, p: t["category"] == p[0],
     "supplier": lambda t, p: t["region"] == p[1]},
    None,
    lambda rng: (int(rng.integers(0, CATEGORIES)),
                 int(rng.integers(0, REGIONS))))
_pq("Q2.2", ("brand_lo", "brand_hi", "s_region"), (260, 267, 2),
    {"part": lambda t, p: (t["brand"] >= p[0]) & (t["brand"] <= p[1]),
     "supplier": lambda t, p: t["region"] == p[2]},
    None,
    lambda rng: ((b := int(rng.integers(0, BRANDS - 7))), b + 7,
                 int(rng.integers(0, REGIONS))))
_pq("Q2.3", ("p_brand", "s_region"), (260, 3),
    {"part": lambda t, p: t["brand"] == p[0],
     "supplier": lambda t, p: t["region"] == p[1]},
    None,
    lambda rng: (int(rng.integers(0, BRANDS)),
                 int(rng.integers(0, REGIONS))))
# --- Q3.x: customer ⋈ supplier ⋈ date -------------------------------------
_pq("Q3.1", ("c_region", "s_region", "year_lo", "year_hi"),
    (2, 2, 1992, 1997),
    {"customer": lambda t, p: t["region"] == p[0],
     "supplier": lambda t, p: t["region"] == p[1],
     "date": lambda t, p: (t["year"] >= p[2]) & (t["year"] <= p[3])},
    None,
    lambda rng: (int(rng.integers(0, REGIONS)),
                 int(rng.integers(0, REGIONS)), *_year_range(rng)))
_pq("Q3.2", ("c_nation", "s_nation", "year_lo", "year_hi"),
    (14, 14, 1992, 1997),
    {"customer": lambda t, p: t["nation"] == p[0],
     "supplier": lambda t, p: t["nation"] == p[1],
     "date": lambda t, p: (t["year"] >= p[2]) & (t["year"] <= p[3])},
    None,
    lambda rng: (int(rng.integers(0, NATIONS)),
                 int(rng.integers(0, NATIONS)), *_year_range(rng)))
_pq("Q3.3", ("city_a", "city_b", "year_lo", "year_hi"),
    (141, 145, 1992, 1997),
    {"customer": lambda t, p: (t["city"] == p[0]) | (t["city"] == p[1]),
     "supplier": lambda t, p: (t["city"] == p[0]) | (t["city"] == p[1]),
     "date": lambda t, p: (t["year"] >= p[2]) & (t["year"] <= p[3])},
    None,
    lambda rng: (int(rng.integers(0, CITIES)), int(rng.integers(0, CITIES)),
                 *_year_range(rng)))
_pq("Q3.4", ("city_a", "city_b", "yearmonthnum"), (141, 145, 199712),
    {"customer": lambda t, p: (t["city"] == p[0]) | (t["city"] == p[1]),
     "supplier": lambda t, p: (t["city"] == p[0]) | (t["city"] == p[1]),
     "date": lambda t, p: t["yearmonthnum"] == p[2]},
    None,
    lambda rng: (int(rng.integers(0, CITIES)), int(rng.integers(0, CITIES)),
                 _ym(rng)))
# --- Q4.x: all four dims ----------------------------------------------------
_pq("Q4.1", ("c_region", "s_region", "mfgr_a", "mfgr_b"), (1, 1, 0, 1),
    {"customer": lambda t, p: t["region"] == p[0],
     "supplier": lambda t, p: t["region"] == p[1],
     "part": lambda t, p: (t["mfgr"] == p[2]) | (t["mfgr"] == p[3])},
    None,
    lambda rng: (int(rng.integers(0, REGIONS)),
                 int(rng.integers(0, REGIONS)),
                 (m := int(rng.integers(0, MFGRS))),
                 int(rng.integers(0, MFGRS))))
_pq("Q4.2", ("c_region", "s_region", "mfgr_a", "mfgr_b",
             "year_a", "year_b"), (1, 1, 0, 1, 1997, 1998),
    {"customer": lambda t, p: t["region"] == p[0],
     "supplier": lambda t, p: t["region"] == p[1],
     "part": lambda t, p: (t["mfgr"] == p[2]) | (t["mfgr"] == p[3]),
     "date": lambda t, p: (t["year"] == p[4]) | (t["year"] == p[5])},
    None,
    lambda rng: (int(rng.integers(0, REGIONS)),
                 int(rng.integers(0, REGIONS)),
                 int(rng.integers(0, MFGRS)), int(rng.integers(0, MFGRS)),
                 (y := _year(rng)), min(y + 1, YEARS[1])))
_pq("Q4.3", ("c_region", "s_nation", "p_category", "year_a", "year_b"),
    (1, 6, 3, 1997, 1998),
    {"customer": lambda t, p: t["region"] == p[0],
     "supplier": lambda t, p: t["nation"] == p[1],
     "part": lambda t, p: t["category"] == p[2],
     "date": lambda t, p: (t["year"] == p[3]) | (t["year"] == p[4])},
    None,
    lambda rng: (int(rng.integers(0, REGIONS)),
                 int(rng.integers(0, NATIONS)),
                 int(rng.integers(0, CATEGORIES)),
                 (y := _year(rng)), min(y + 1, YEARS[1])))

assert sorted(PARAM_QUERIES) == sorted(SSB_QUERIES)
