"""The 13 SSB queries (Q1.1-Q4.3), spec-driven, with pluggable join engine.

PyTorch port of the read side of ``repro.engine.queries``.  Modes:

  * "jspim"    -- joins through the prebuilt ``DimIndex`` probe; dimension
                  predicates applied while streaming results back (§4.1.5).
  * "baseline" -- sort-merge joins.
  * "pid"      -- partitioned-hash joins (PID-Join-style partition passes).

Every query returns ``(total, groups)``, int32: ``groups`` is a dense
vector over the composite group-key space (segment-summed revenue), so
agreement between modes, and with the JAX package, is exact.

Execution (eager; no compiled programs):

  * **Probe cache** -- fact FK columns are query-independent, so each
    dimension is probed once per engine (``probe_rows``) and the
    ``(found, dim_row)`` pair is reused by every query touching it.
  * **Cold composed path** -- ``run(use_cache=False)`` probes per query;
    filtered dimensions go through ``probe_filter_rows``.
  * **Mega path** -- ``run(fusion="mega")`` answers a query with one
    ``fused_query`` launch over per-slot attribute planes.

Durability, mutation hooks, epoch snapshots, ingest and the planner wait
for later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.dictionary import encode
from repro_torch.core.hash_table import hash_bucket
from repro_torch.core.policy import ExecutionPolicy, check_value
from repro_torch.engine import baselines
from repro_torch.engine.join import (DimIndex, build_dim_index,
                                     effective_index, lookup, lookup_filtered)
from repro_torch.engine.table import Table, resolve_device
from repro_torch.kernels.fused_query import fused_query
from repro_torch.kernels.ref import segment_sum

FACT_FK = {"customer": "custkey", "supplier": "suppkey",
           "part": "partkey", "date": "orderdate"}
DIM_PK = {"customer": "custkey", "supplier": "suppkey",
          "part": "partkey", "date": "datekey"}


@dataclasses.dataclass(frozen=True)
class QuerySpec:
    name: str
    dim_filters: dict[str, Callable[[Table], torch.Tensor]]
    fact_filter: Callable[[Table], torch.Tensor] | None
    measure: Callable[[Table], torch.Tensor]
    group_by: tuple[tuple[str, str, int], ...] = ()  # (dim, col, cardinality)

    def joined_dims(self) -> tuple[str, ...]:
        return tuple(sorted(set(self.dim_filters)
                            | {d for d, _, _ in self.group_by}))


def _between(col, lo, hi):
    return lambda t: (t[col] >= lo) & (t[col] <= hi)


def _eq(col, v):
    return lambda t: t[col] == v


def _in(col, vals):
    def f(t):
        m = torch.zeros_like(t[col], dtype=torch.bool)
        for v in vals:
            m = m | (t[col] == v)
        return m
    return f


def _rev(t):
    return t["revenue"]


def _profit(t):
    return t["revenue"] - t["supplycost"]


def _discounted(t):
    return t["extendedprice"] * t["discount"]


SSB_QUERIES: dict[str, QuerySpec] = {}


def _q(name, dim_filters, fact_filter, measure, group_by=()):
    SSB_QUERIES[name] = QuerySpec(name, dim_filters, fact_filter, measure,
                                  tuple(group_by))


# --- Q1.x: filter-heavy, single date join -------------------------------
_q("Q1.1", {"date": _eq("year", 1993)},
   lambda t: (t["discount"] >= 1) & (t["discount"] <= 3) & (t["quantity"] < 25),
   _discounted)
_q("Q1.2", {"date": _eq("yearmonthnum", 199401)},
   lambda t: (t["discount"] >= 4) & (t["discount"] <= 6)
   & (t["quantity"] >= 26) & (t["quantity"] <= 35),
   _discounted)
_q("Q1.3", {"date": lambda t: (t["weeknuminyear"] == 6) & (t["year"] == 1994)},
   lambda t: (t["discount"] >= 5) & (t["discount"] <= 7)
   & (t["quantity"] >= 26) & (t["quantity"] <= 35),
   _discounted)
# --- Q2.x: part ⋈ supplier ⋈ date ----------------------------------------
_q("Q2.1", {"part": _eq("category", 12), "supplier": _eq("region", 1)},
   None, _rev, [("date", "year", 7), ("part", "brand", 1000)])
_q("Q2.2", {"part": _between("brand", 260, 267), "supplier": _eq("region", 2)},
   None, _rev, [("date", "year", 7), ("part", "brand", 1000)])
_q("Q2.3", {"part": _eq("brand", 260), "supplier": _eq("region", 3)},
   None, _rev, [("date", "year", 7), ("part", "brand", 1000)])
# --- Q3.x: customer ⋈ supplier ⋈ date -------------------------------------
_q("Q3.1", {"customer": _eq("region", 2), "supplier": _eq("region", 2),
            "date": _between("year", 1992, 1997)},
   None, _rev, [("customer", "nation", 25), ("supplier", "nation", 25),
                ("date", "year", 7)])
_q("Q3.2", {"customer": _eq("nation", 14), "supplier": _eq("nation", 14),
            "date": _between("year", 1992, 1997)},
   None, _rev, [("customer", "city", 250), ("supplier", "city", 250),
                ("date", "year", 7)])
_q("Q3.3", {"customer": _in("city", (141, 145)), "supplier": _in("city", (141, 145)),
            "date": _between("year", 1992, 1997)},
   None, _rev, [("customer", "city", 250), ("supplier", "city", 250),
                ("date", "year", 7)])
_q("Q3.4", {"customer": _in("city", (141, 145)), "supplier": _in("city", (141, 145)),
            "date": _eq("yearmonthnum", 199712)},
   None, _rev, [("customer", "city", 250), ("supplier", "city", 250),
                ("date", "year", 7)])
# --- Q4.x: all four dims ----------------------------------------------------
_q("Q4.1", {"customer": _eq("region", 1), "supplier": _eq("region", 1),
            "part": _in("mfgr", (0, 1))},
   None, _profit, [("date", "year", 7), ("customer", "nation", 25)])
_q("Q4.2", {"customer": _eq("region", 1), "supplier": _eq("region", 1),
            "part": _in("mfgr", (0, 1)), "date": _in("year", (1997, 1998))},
   None, _profit, [("date", "year", 7), ("supplier", "nation", 25),
                   ("part", "category", 25)])
_q("Q4.3", {"customer": _eq("region", 1), "supplier": _eq("nation", 6),
            "part": _eq("category", 3), "date": _in("year", (1997, 1998))},
   None, _profit, [("date", "year", 7), ("supplier", "city", 250),
                   ("part", "brand", 1000)])


def _clip_rows(r: torch.Tensor, n: int) -> torch.Tensor:
    return r.clamp(0, n - 1).long()


def _filter_aggregate(spec: QuerySpec, fact_cols, dim_cols, probes):
    """Shared tail of every query: filter-on-the-fly -> mask -> measure ->
    segment-sum.  ``probes[dim] = (found, dim_row)``."""
    fact = Table(fact_cols)
    n_rows = fact.n_rows
    mask = torch.ones(n_rows, dtype=torch.bool, device=fact.device)
    rows: dict[str, torch.Tensor] = {}
    for dim in spec.joined_dims():
        found, r = probes[dim]
        rows[dim] = r
        mask = mask & found
        if dim in spec.dim_filters:
            dmask = spec.dim_filters[dim](Table(dim_cols[dim]))
            # filter-on-the-fly while streaming results (paper §4.1.5)
            mask = mask & dmask[_clip_rows(r, dmask.shape[0])]
    if spec.fact_filter is not None:
        mask = mask & spec.fact_filter(fact)
    contrib = torch.where(mask, spec.measure(fact).to(torch.int32), 0)
    # torch sums int32 into int64: the cast back wraps mod 2^32 like jnp.sum
    total = contrib.sum().to(torch.int32)
    if not spec.group_by:
        return total, total[None]
    # dense composite group key (small spaces by construction)
    gk = torch.zeros(n_rows, dtype=torch.int32, device=fact.device)
    size = 1
    for dim, col, card in spec.group_by:
        c = dim_cols[dim][col]
        gk = gk * card + torch.remainder(c[_clip_rows(rows[dim], c.shape[0])],
                                         card)
        size *= card
    return total, segment_sum(contrib, torch.where(mask, gk, 0), size)


def _mega_operands(spec: QuerySpec, fact_cols, dim_cols, indexes):
    """Build the ``fused_query`` operands for one SSB query.

    Per joined dimension: the per-slot *attribute plane* --
    ``(group_key*stride << 1) | pred_bit`` for unique in-range payloads,
    -1 for dup/invalid slots -- over the hash table, plus the probe codes
    and bucket ids; the kernel gathers the bucket rows itself.  Strides are
    suffix products of the group cardinalities, so the composite key is a
    plain sum across dimensions, equal to ``_filter_aggregate``'s.
    """
    fact = Table(fact_cols)
    measure = spec.measure(fact).to(torch.int32)
    if spec.fact_filter is not None:
        measure = torch.where(spec.fact_filter(fact), measure, 0)
    size = 1
    for _, _, card in spec.group_by:
        size *= card
    strides: dict[str, tuple[str, int, int]] = {}
    rem = size
    for dim, col, card in spec.group_by:
        rem //= card
        strides[dim] = (col, card, rem)
    dim_ops = []
    for dim in spec.joined_dims():
        table = indexes[dim].table
        dt = Table(dim_cols[dim])
        n = dt.n_rows
        payload = table.values >> 1
        clip = _clip_rows(payload, n)
        ok = (payload >= 0) & (payload < n) & ((table.values & 1) == 0)
        p = (spec.dim_filters[dim](dt)[clip].to(torch.int32)
             if dim in spec.dim_filters else torch.ones_like(payload))
        g = torch.zeros_like(payload)
        if dim in strides:
            col, card, stride = strides[dim]
            g = torch.remainder(dt[col][clip], card) * stride
        attr = torch.where(ok, (g << 1) | p, -1).to(torch.int32)
        codes = encode(indexes[dim].dictionary, fact_cols[FACT_FK[dim]])
        bids = hash_bucket(codes, table.num_buckets, table.hash_mode)
        dim_ops.append((codes, bids, table.keys, attr))
    return tuple(dim_ops), measure, size


class _QueryRunner:
    """Query execution over ``tables``/``indexes`` and a ``probe_dim``.

    ``SSBEngine`` supplies the state and the probe cache; the epoch
    snapshots of a later slice answer queries through the same methods.
    """

    policy: ExecutionPolicy
    tables: dict[str, Table]
    indexes: dict[str, DimIndex]

    @property
    def mode(self) -> str:
        return self.policy.mode

    @property
    def probe_impl(self) -> str:
        return self.policy.kernel

    def probe_dim(self, dim: str) -> tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    # -- join primitive: (found, dim_row) per fact row ---------------------
    def _join(self, dim: str, dim_mask: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """Probe one dimension.  With ``dim_mask`` on the CUDA kernel the
        predicate is folded into the probe (``probe_filter_rows``)."""
        fk = self.tables["lineorder"][FACT_FK[dim]]
        if self.mode == "jspim":
            index = self.indexes[dim]
            if dim_mask is not None and self.probe_impl == "cuda":
                pr = lookup_filtered(index, fk, dim_mask, impl="cuda")
            else:
                pr = lookup(index, fk, impl=self.probe_impl)
            return pr.found, torch.where(pr.found, pr.payload, -1)
        dk = self.tables[dim][DIM_PK[dim]]
        if self.mode == "baseline":
            return baselines.sort_merge_join_unique(fk, dk)
        return baselines.partitioned_hash_join_unique(fk, dk)

    # -- execution ---------------------------------------------------------
    def _cols(self, dims):
        fact_cols = dict(self.tables["lineorder"].columns)
        return fact_cols, {d: dict(self.tables[d].columns) for d in dims}

    def _run_mega(self, name: str) -> tuple[torch.Tensor, torch.Tensor]:
        """One ``fused_query`` launch: probe, filter, aggregate."""
        spec = SSB_QUERIES[name]
        fact_cols, dim_cols = self._cols(spec.joined_dims())
        idx = {d: effective_index(self.indexes[d])
               for d in spec.joined_dims()}
        dim_ops, fmeasure, size = _mega_operands(spec, fact_cols, dim_cols,
                                                 idx)
        return fused_query(dim_ops, fmeasure, num_segments=size)

    def run(self, name: str, *, use_cache: bool | None = None,
            fusion: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """Execute one query.

        ``use_cache=True`` (policy default) consumes the cross-query probe
        cache; ``use_cache=False`` probes cold, folding each filtered
        dimension's predicate into the probe on the CUDA kernel.
        ``fusion="mega"`` routes a jspim query through one ``fused_query``
        launch instead (the probe cache is not consulted).
        """
        spec = SSB_QUERIES[name]
        use_cache = self.policy.use_cache if use_cache is None else use_cache
        fusion = self.policy.fusion if fusion is None else fusion
        check_value("fusion", fusion)
        if fusion == "mega" and self.mode == "jspim":
            return self._run_mega(name)
        fact_cols, dim_cols = self._cols(spec.joined_dims())
        if use_cache:
            probes = {d: self.probe_dim(d) for d in spec.joined_dims()}
        else:
            probes = {}
            for d in spec.joined_dims():
                dmask = (spec.dim_filters[d](Table(dim_cols[d]))
                         if d in spec.dim_filters else None)
                probes[d] = self._join(d, dmask)
        return _filter_aggregate(spec, fact_cols, dim_cols, probes)

    def run_all(self, names=None, *, use_cache: bool | None = None,
                fusion: str | None = None
                ) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
        """All (or the named) queries, probing each dimension at most once.

        ``fusion="composed"`` runs the queries one by one through ``run``;
        ``"mega"`` probes every joined dimension once up front (through the
        cache when ``use_cache``) and runs all query tails on the shared
        probes, as the JAX package's one-dispatch suite does.
        """
        names = list(names) if names is not None else sorted(SSB_QUERIES)
        use_cache = self.policy.use_cache if use_cache is None else use_cache
        fusion = self.policy.fusion if fusion is None else fusion
        check_value("fusion", fusion)
        if fusion == "composed":
            return {n: self.run(n, use_cache=use_cache, fusion="composed")
                    for n in names}
        dims = sorted({d for n in names for d in SSB_QUERIES[n].joined_dims()})
        fact_cols, dim_cols = self._cols(dims)
        probes = {d: self.probe_dim(d) if use_cache else self._join(d)
                  for d in dims}
        return {n: _filter_aggregate(SSB_QUERIES[n], fact_cols, dim_cols,
                                     probes) for n in names}


class SSBEngine(_QueryRunner):
    """Executes SSB queries with joins delegated to the selected engine.

    ``policy`` (an :class:`ExecutionPolicy`, default: jspim mode on the
    CUDA kernels, gathered schedule, composed fusion) holds every knob.
    ``device`` defaults to the CUDA card and must hold the tables; with no
    card and no ``device="cpu"`` the constructor raises ``RuntimeError``.
    ``indexes`` adopts prebuilt ``DimIndex``es (``engine/convert.py``
    carries the JAX package's over) instead of building them.
    """

    def __init__(self, tables: dict[str, Table], *,
                 indexes: dict[str, DimIndex] | None = None,
                 policy: ExecutionPolicy | None = None, device=None):
        self.policy = policy if policy is not None else ExecutionPolicy()
        self.device = resolve_device(device)
        for name, t in tables.items():
            if t.device != self.device:
                raise ValueError(f"table {name!r} lives on {t.device}, the "
                                 f"engine runs on {self.device}")
        self.tables = tables
        self.indexes: dict[str, DimIndex] = {}
        if self.mode == "jspim":
            if indexes is not None:
                self.indexes = dict(indexes)
            else:
                # built once, reused across queries (§3.2.3 persistence)
                for dim, pk in DIM_PK.items():
                    self.indexes[dim] = build_dim_index(tables[dim][pk])
        # cross-query probe cache: dim -> (found, dim_row) over fact rows
        self._probe_cache: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}
        self._hits = 0
        self._misses = 0
        self._invalidations = 0

    @property
    def build_stats(self):
        """Final index geometry per dimension (jspim mode)."""
        return {d: ix.stats for d, ix in self.indexes.items()}

    # -- cross-query probe cache ------------------------------------------
    def probe_dim(self, dim: str) -> tuple[torch.Tensor, torch.Tensor]:
        """Cached (found, dim_row) for one dimension (probe once, reuse)."""
        hit = self._probe_cache.get(dim)
        if hit is not None:
            self._hits += 1
            return hit
        self._misses += 1
        out = self._probe_cache[dim] = self._join(dim)
        return out

    def warm_cache(self, dims=None) -> None:
        """Probe every (or the given) dimension into the cache up front."""
        for dim in (dims if dims is not None else DIM_PK):
            self.probe_dim(dim)

    def invalidate_probe_cache(self, dim: str | None = None) -> None:
        """Drop cached probes: all dims, or one."""
        if dim is None:
            self._invalidations += len(self._probe_cache)
            self._probe_cache.clear()
        elif dim in self._probe_cache:
            self._invalidations += 1
            del self._probe_cache[dim]

    def cache_info(self) -> dict:
        return {"hits": self._hits, "misses": self._misses,
                "invalidations": self._invalidations,
                "cached_dims": sorted(self._probe_cache)}
