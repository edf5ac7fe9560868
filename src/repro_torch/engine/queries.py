"""The 13 SSB queries (Q1.1-Q4.3), spec-driven, with pluggable join engine.

PyTorch port of ``repro.engine.queries``: the read side and the dimension
mutation path.  Modes:

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
    filtered dimensions go through ``probe_filter_rows`` (or, with a live
    delta, ``probe_filter_rows_delta``).
  * **Mega path** -- ``run(fusion="mega")`` answers a query with one
    ``fused_query`` launch over per-slot attribute planes, the delta's
    included.

Probe schedules (§3.3): every dimension carries a ``SchedulePlan``
(``plans``), from ``plan_probe`` over the fact-side skew measured when its
index was built.  ``schedule="auto"`` lets the planner pick per dimension;
"gathered" / "stream" / "deduped" / "hot_cold" force one everywhere.  A
dimension is re-planned when its delta appears or grows and after it is
compacted.  Every planner prices on the engine's device type, the cost
model's ``"cpu"`` or ``"cuda"`` entry (``core/costmodel.py``).
``fusion="auto"`` asks ``plan_query`` how ``run_all`` runs on the probe
cache; a cold suite and a single ``run`` take the composed path.

Mutation (§3.2.3): ``ingest`` / ``append_rows`` buffer dimension ops in a
per-dimension delta, ``compact`` folds it back (``auto_compact`` asks
``plan_compaction``), and the update commands rewrite table cells; each
drops the dimension's cached probes.

Fact-side streaming append: ``append_fact_rows`` lands new lineorder rows
in a pow2-bucketed capacity tail (``Table.append_tail``) and *extends* the
probe cache: only the padded tail is probed, under each dimension's plan
with the delta overlay included, and spliced into the cached
``(found, dim_row)`` (``join.extend_cached_probe``).  A monotone
``fact_epoch`` stamps every cache entry, and after heavy append the
fact-side skew is re-measured and drifted dimensions re-planned
(``planner.skew_drift``).  Queries run over the physical (capacity-padded)
rows: padding FKs are ``EMPTY_KEY`` and join nothing.  ``epoch`` counts
every mutation that changes the engine's state.

Epoch snapshots (MVCC): ``snapshot()`` freezes one consistent image
(tables, indexes with their deltas, plans, the probe cache) as an
``EpochSnapshot`` (``engine/snapshot.py``) that answers queries through
the same ``_QueryRunner`` methods while ``append_fact_rows`` / ``ingest``
/ ``compact`` advance the engine.  Three sites write tensors in place: the
fact tail, the probe-cache splice and the in-place compaction merge.  Each
checks the buffer *generation* it would write against the generations
the live snapshots pin, and writes a fresh generation instead when one is
pinned; once the last snapshot pinning it is released (or collected), the
in-place writes re-arm.  Mutations serialize under one reentrant lock;
queries and snapshots take none.

Mutation hooks: every published mutation is delivered as a
``MutationEvent`` to the hooks registered with ``add_mutation_hook`` (the
incremental view maintenance of ``repro_torch.ivm`` rides on them), in
mutation order, under the engine lock, once its epoch has published.

Durability (DESIGN.md §10, ``repro_torch.durability``): ``persist(root)``
writes a genesis checkpoint and opens a write-ahead log; from then on
every mutation batch is appended and fsynced (``_wal_log``, after
validation and before any state changes) and, once its epoch publishes,
the cost model weighs a checkpoint (``_wal_publish``).  ``open(root)``
recovers an engine from the newest verified checkpoint plus the log's
replay.  ``close()`` refuses every later mutation; queries and held
snapshots keep answering.

Counters: ``cache_info()`` (probe-cache hits, misses, invalidations),
``fact_append_info()`` (appends, tail extensions and re-probes, fact-side
skew measurements and re-plans), ``ingest_info()`` (ingest batches,
``compactions``, per-dim delta occupancy) and ``snapshot_info()``
(snapshots taken and live, pinned copies, and ``snapshot_reprobes``: the
lazy probes snapshots made of dimensions the engine had not cached when
they froze, counted here so that the count outlives the snapshots).

Spans (``repro_torch.trace``; the recorder is off by default and a site
then costs one flag check): ``engine.append_fact_rows``,
``engine.append_rows`` and ``engine.ingest`` around the outermost such
call, ``engine.extend_probe`` around each cached dimension's tail
extension in an append (with the planner's ``decision``),
``engine.compact`` around each merge (with its ``flavor`` and the
``est_merge_s`` of the plan that chose it), ``engine.skew_measure`` around
each measurement of a fact FK column's skew (at build and on a
re-measure), ``engine.skew_replan`` around each re-plan it triggers (with
the ``old`` and ``new`` schedule and whether the decision ``changed``),
and ``engine.lock_wait`` where acquiring the engine lock (``site``: the
mutation, ``snapshot``, ``release``, ``prepare_compact``,
``publish_compact``) waited ``trace.LOCK_WAIT_MIN_S`` or more.
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
import threading
import weakref
from typing import Callable

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import hash_table as _ht
from repro_torch.core.delta import TOMBSTONE, delta_is_empty, delta_stats
from repro_torch.core.dictionary import encode
from repro_torch.core.lookup import build_hot_table, hot_hit_count
from repro_torch.core.planner import (FACT_REMEASURE_FRAC, TOP_SHARE_DRIFT,
                                      CompactionPlan, FactAppendPlan,
                                      SchedulePlan, plan_compaction,
                                      plan_fact_append, plan_probe,
                                      plan_query, refine_plan, skew_drift)
from repro_torch.core.policy import (ExecutionPolicy, check_value,
                                     resolve_policy)
from repro_torch.core.skew import top_keys
from repro_torch.engine import baselines
from repro_torch.engine.join import (DimIndex, build_dim_index,
                                     compact_index, effective_index,
                                     extend_cached_probe, found_rows,
                                     ingest_index, lookup, lookup_filtered,
                                     measure_fact_skew, probe_fn_for)
from repro_torch.engine.table import Table, resolve_device, tail_bucket
from repro_torch.kernels.fused_query import fused_query
from repro_torch.kernels.ref import segment_sum

FACT_FK = {"customer": "custkey", "supplier": "suppkey",
           "part": "partkey", "date": "orderdate"}
DIM_PK = {"customer": "custkey", "supplier": "suppkey",
          "part": "partkey", "date": "datekey"}


def _check_batch_col(arg: str, values, *,
                     expect_len: int | None = None) -> np.ndarray:
    """API-boundary validation of one host batch column: a 1-D integer
    array in the int32 range, of ``expect_len`` rows when given.  Raises
    ``ValueError`` naming the argument."""
    a = values.cpu().numpy() if torch.is_tensor(values) else np.asarray(values)
    if a.dtype.kind not in "iu":
        raise ValueError(f"{arg}: expected an integer array, got dtype "
                         f"{a.dtype}")
    if a.ndim != 1:
        raise ValueError(f"{arg}: expected a 1-D array, got shape "
                         f"{tuple(a.shape)}")
    if a.size and (int(a.min()) < -(2 ** 31)
                   or int(a.max()) > 2 ** 31 - 1):
        raise ValueError(f"{arg}: values exceed the engine's int32 key "
                         "space")
    if expect_len is not None and a.shape[0] != expect_len:
        raise ValueError(f"{arg}: length {a.shape[0]} != {expect_len} "
                         "(ragged batch)")
    return a.astype(np.int32, copy=False)


@dataclasses.dataclass(frozen=True)
class MutationEvent:
    """One published mutation, as delivered to registered hooks.

    ``kind`` is ``ingest`` / ``append_rows`` / ``append_fact_rows`` /
    ``compact`` / ``raw_update``, ``meta`` and ``arrays`` the validated
    batch (host numpy arrays), and ``epoch`` / ``fact_epoch`` the engine's
    counters at delivery, after the mutation published: a hook that has
    processed the event is exactly as fresh as the engine.  Delivery runs
    under the engine's mutation lock, in mutation order.
    """

    kind: str
    meta: dict
    arrays: dict
    epoch: int
    fact_epoch: int


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
    # comparisons and ``|`` only, so the host oracle runs it on numpy too
    def f(t):
        m = t[col] == vals[0]
        for v in vals[1:]:
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

    Per joined dimension: the probe codes, the hash table's key plane, the
    per-slot *attribute plane* -- ``(group_key*stride << 1) | pred_bit``
    for unique in-range payloads, -1 for dup/invalid slots -- and the
    table's hash mode; the kernel hashes the codes and gathers the bucket
    rows itself.  With a live delta, the raw fact keys, the delta's key
    plane, the same attribute plane over the delta's words (tombstones -1)
    and its hash mode follow, as the 8-tuple ``fused_query`` takes.
    Strides are suffix products of the group cardinalities, so the
    composite key is a plain sum across dimensions, equal to
    ``_filter_aggregate``'s.
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
        idx = indexes[dim]
        dt = Table(dim_cols[dim])
        n = dt.n_rows
        pred = spec.dim_filters[dim](dt) if dim in spec.dim_filters else None

        def attr_of(words, invalid, dim=dim, dt=dt, n=n, pred=pred):
            payload = words >> 1
            clip = _clip_rows(payload, n)
            ok = (payload >= 0) & (payload < n) & ~invalid
            p = (pred[clip].to(torch.int32) if pred is not None
                 else torch.ones_like(payload))
            g = torch.zeros_like(payload)
            if dim in strides:
                col, card, stride = strides[dim]
                g = torch.remainder(dt[col][clip], card) * stride
            return torch.where(ok, (g << 1) | p, -1).to(torch.int32)

        table = idx.table
        fk = fact_cols[FACT_FK[dim]]
        ops = (encode(idx.dictionary, fk), table.keys,
               attr_of(table.values, (table.values & 1) == 1),
               table.hash_mode)
        if idx.delta is not None:
            d = idx.delta
            ops += (fk.to(torch.int32), d.keys,
                    attr_of(d.words, d.words == TOMBSTONE), d.hash_mode)
        dim_ops.append(ops)
    return tuple(dim_ops), measure, size


class _QueryRunner:
    """Query execution over ``tables``/``indexes`` and a ``probe_dim``.

    ``SSBEngine`` supplies the live state and its probe cache, an
    ``EpochSnapshot`` a frozen image of it; both answer queries through
    these same methods, so an old epoch is served by the code path the
    head runs.
    """

    policy: ExecutionPolicy
    device: torch.device
    tables: dict[str, Table]
    indexes: dict[str, DimIndex]
    plans: dict[str, SchedulePlan]
    _hot_codes: dict[str, torch.Tensor]

    @property
    def mode(self) -> str:
        return self.policy.mode

    @property
    def probe_impl(self) -> str:
        return self.policy.kernel

    @property
    def schedule(self) -> str:
        return self.policy.schedule

    def probe_dim(self, dim: str) -> tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    # -- join primitive: (found, dim_row) per fact row ---------------------
    def _join(self, dim: str, dim_mask: torch.Tensor | None = None, *,
              eager: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """Probe one dimension under its planned schedule.  With
        ``dim_mask`` on the CUDA kernel the predicate is folded into the
        probe (``probe_filter_rows``, or ``probe_filter_rows_delta`` with a
        live delta) whatever the schedule, as in the JAX package.  With
        ``eager`` the plan is ignored: the gathered probe of the reference
        loop (``run_eager``)."""
        fk = self.tables["lineorder"][FACT_FK[dim]]
        if self.mode == "jspim":
            index = self.indexes[dim]
            if dim_mask is not None and self.probe_impl == "cuda":
                return found_rows(lookup_filtered(index, fk, dim_mask,
                                                  impl="cuda"))
            if eager:
                return found_rows(lookup(index, fk, impl=self.probe_impl))
            return found_rows(lookup(index, fk, impl=self.probe_impl,
                                     plan=self.plans.get(dim),
                                     hot_codes=self._hot_codes.get(dim)))
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
        launch instead (the probe cache is not consulted); ``"auto"``
        takes the composed path, as the reference's ``run`` does.
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

    def _plan_fusion(self, n_queries: int) -> str:
        """``plan_query``'s shape for ``run_all`` on the probe cache, priced
        on this image's device.  The suite's tails are plain PyTorch
        whatever the probe kernel, so it prices ``kernel="torch"`` (the
        reference's ``"xla"``)."""
        return plan_query(self.tables["lineorder"].n_rows, n_queries,
                          backend=self.device.type, kernel="torch").fusion

    def run_all(self, names=None, *, use_cache: bool | None = None,
                fusion: str | None = None
                ) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
        """All (or the named) queries, probing each dimension at most once.

        ``fusion="composed"`` runs the queries one by one through ``run``;
        ``"mega"`` probes every joined dimension once up front (through the
        cache when ``use_cache``) and runs all query tails on the shared
        probes, as the JAX package's one-dispatch suite does; ``"auto"``
        asks ``plan_query`` on the cache and takes ``"composed"`` cold.
        """
        names = list(names) if names is not None else sorted(SSB_QUERIES)
        use_cache = self.policy.use_cache if use_cache is None else use_cache
        fusion = self.policy.fusion if fusion is None else fusion
        check_value("fusion", fusion)
        if fusion == "auto":
            fusion = self._plan_fusion(len(names)) if use_cache \
                else "composed"
        if fusion == "composed":
            return {n: self.run(n, use_cache=use_cache, fusion="composed")
                    for n in names}
        dims = sorted({d for n in names for d in SSB_QUERIES[n].joined_dims()})
        fact_cols, dim_cols = self._cols(dims)
        probes = {d: self.probe_dim(d) if use_cache else self._join(d)
                  for d in dims}
        return {n: _filter_aggregate(SSB_QUERIES[n], fact_cols, dim_cols,
                                     probes) for n in names}


# the mutations spanned as ``engine.<name>``, at their outermost call
_WRITE_SPANS = frozenset({"engine.append_fact_rows", "engine.append_rows",
                          "engine.ingest"})


def _write_attrs(sig: inspect.Signature, args: tuple, kwargs: dict) -> dict:
    """A write span's attributes from the call's arguments: ``dim``,
    ``op`` and ``rows`` (the batch's length) where the call has them."""
    bound = sig.bind(*args, **kwargs)
    bound.apply_defaults()
    arg = bound.arguments
    out = {k: arg[k] for k in ("dim", "op") if k in arg}
    batch = arg.get("rows", arg.get("keys"))
    if isinstance(batch, dict):
        batch = next(iter(batch.values()), ())
    try:
        out["rows"] = len(batch)
    except TypeError:
        pass
    return out


def _mutates(fn):
    """Mutation-method guard: the engine's reentrant lock, so a snapshot
    (a serving tier's refresh) or a background compaction's publish never
    sees half a mutation, and the closed check, so a mutation after
    ``close()`` is a clear ``RuntimeError`` rather than a write to a closed
    log.  Reentrant because mutations compose (``append_rows`` drives
    ``ingest``, which may drive ``compact``).  A mutation that raises
    leaves no staged event behind: a later publish would deliver a batch
    the engine never applied.  With the recorder on, the outermost
    ``append_fact_rows`` / ``append_rows`` / ``ingest`` is spanned, and a
    wait for the lock recorded."""
    name = f"engine.{fn.__name__}"
    sig = inspect.signature(fn) if name in _WRITE_SPANS else None

    @functools.wraps(fn)
    def wrapper(self, *a, **k):
        sp = trace.NO_SPAN
        if sig is not None and trace.enabled() and \
                not trace.within(_WRITE_SPANS):
            sp = trace.span(name)
        with sp, trace.locked(self._mu, fn.__name__):
            if sp is not trace.NO_SPAN:
                # named under the lock: work between a writer's two calls
                # would let a waiting snapshot in between them
                sp.set(**_write_attrs(sig, (self, *a), k))
            self._check_open()
            try:
                return fn(self, *a, **k)
            except BaseException:
                self._pending_events.clear()
                raise
    return wrapper


class SSBEngine(_QueryRunner):
    """Executes SSB queries with joins delegated to the selected engine.

    ``policy`` (an :class:`ExecutionPolicy`, default: jspim mode on the
    CUDA kernels, ``schedule="auto"``, ``fusion="auto"``) holds every knob.
    The positional ``mode`` / ``probe_impl`` / ``schedule`` arguments are
    the legacy spellings, resolved into the policy (``resolve_policy``;
    ``probe_impl`` is ``"torch"`` or ``"cuda"``); one that disagrees with
    an explicit ``policy`` raises ``ValueError``.  ``device`` defaults to
    the CUDA card and must hold the tables; with no card and no
    ``device="cpu"`` the constructor raises ``RuntimeError``.  ``indexes``
    adopts prebuilt ``DimIndex``es (``engine/convert.py`` carries the JAX
    package's over) instead of building them; their ``fact_skew`` feeds
    the planner.  The engine takes its own copy of their table planes,
    which its compactions write in place, so engines built on one
    ``indexes`` mapping never see each other's compactions.
    """

    def __init__(self, tables: dict[str, Table], mode: str | None = None,
                 probe_impl: str | None = None, schedule: str | None = None,
                 *, indexes: dict[str, DimIndex] | None = None,
                 policy: ExecutionPolicy | None = None, device=None):
        self.policy = resolve_policy(policy, mode=mode,
                                     probe_impl=probe_impl,
                                     schedule=schedule)
        self.device = resolve_device(device)
        for name, t in tables.items():
            if t.device != self.device:
                raise ValueError(f"table {name!r} lives on {t.device}, the "
                                 f"engine runs on {self.device}")
        # own dicts: ``append_rows`` and ``compact`` replace entries, and
        # must not reach another engine built from the same mappings
        self.tables = dict(tables)
        fact = self.tables["lineorder"]
        if fact.tail_owned:
            # another engine's append chain writes into these buffers in
            # place (its next rows land in our padding): take a copy
            self.tables["lineorder"] = Table(
                {k: v.clone() for k, v in fact.columns.items()},
                valid_rows=fact.valid_rows, tail_owned=True)
        self.indexes: dict[str, DimIndex] = {}
        self.plans: dict[str, SchedulePlan] = {}
        self._hot_codes: dict[str, torch.Tensor] = {}
        n_fact = fact.n_rows
        if self.mode == "jspim":
            if indexes is not None:
                self.indexes = {
                    d: dataclasses.replace(ix, table=dataclasses.replace(
                        ix.table, keys=ix.table.keys.clone(),
                        values=ix.table.values.clone()))
                    for d, ix in indexes.items()}
            else:
                # built once, reused across queries (§3.2.3 persistence);
                # the fact FK column rides along so BuildStats records its
                # skew (measured on the engine's device, over the logical
                # rows: capacity padding is not data)
                for dim, pk in DIM_PK.items():
                    self.indexes[dim] = build_dim_index(
                        tables[dim][pk],
                        fact_keys=fact[FACT_FK[dim]][:n_fact], dim=dim)
            for dim in self.indexes:
                self._plan_dim(dim)
        # cross-query probe cache: dim -> (found, dim_row) over the
        # physical fact rows, each entry stamped with the fact epoch it is
        # consistent with
        self._probe_cache: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}
        self._probe_epoch: dict[str, int] = {}
        # dims whose cached tensors were made by the extension path and
        # handed to no caller since: the next splice writes them in place
        self._cache_owned: set[str] = set()
        # bumped by every mutation that changes the engine's state
        self._epoch = 0
        # -- epoch snapshots ----------------------------------------------
        # mutations serialize under this lock (queries take none), and a
        # closed engine refuses them
        self._mu = threading.RLock()
        self._closed = False
        # the durability tier: attached by ``persist`` / ``open``; None is
        # a volatile engine
        self._durability = None
        # live snapshots, held weakly: one nobody references stops pinning
        # even unreleased.  A generation counts the buffer families the
        # engine allocates for one piece of state; a snapshot pins the
        # generations it reads, and an in-place write to the current
        # generation is allowed only while no live snapshot pins it
        self._snapshots: "weakref.WeakSet" = weakref.WeakSet()
        self._snapshots_taken = 0
        self._pin_copies = 0       # in-place writes a pin turned into copies
        # lazy probes snapshots made (their own lock: a snapshot counts on
        # a serving thread, and the engine lock may be held by a writer)
        self._snapshot_reprobes = 0
        self._count_mu = threading.Lock()
        self._fact_gen = 0         # the fact table's capacity buffers
        self._cache_gens: dict[str, int] = {}  # each dim's cached probes
        self._index_gens: dict[str, int] = {}  # each dim's main-table planes
        self._fact_epoch = 0
        self._fact_appends = 0
        self._fact_rows_appended = 0
        self._tail_extensions = 0
        self._tail_reprobes = 0
        self._skew_replans = 0
        # fact FK columns measured: one a dimension at build (adopted
        # indexes bring their own), then one a dimension per re-measure
        self._skew_measures = len(self.indexes) if indexes is None else 0
        self._skew_measured_rows = n_fact
        self._hits = 0
        self._misses = 0
        self._invalidations = 0
        self._ingest_batches = 0
        self._compactions = 0
        # mutation-hook fan-out: observers (the IVM suites) see each
        # validated batch, staged before the state changes and delivered
        # once the epoch publishes; ``_view_suites`` is what ``snapshot()``
        # asks for maintained answers
        self._mutation_hooks: list[Callable] = []
        self._pending_events: list[tuple] = []
        self._view_suites: list = []

    # -- skew-adaptive probe planning (§3.3) -------------------------------
    def _plan_dim(self, dim: str) -> None:
        """Plan the probe schedule for one dimension and stage its hot
        codes (hottest-first, or the full code range for a full map)."""
        idx = self.indexes[dim]
        st = idx.stats
        force = None if self.schedule == "auto" else self.schedule
        if st is None or st.fact_skew is None:
            self.plans[dim] = SchedulePlan(schedule=force or "gathered")
            return
        # the code space is the dictionary's, not n_unique: deleted keys'
        # codes stay allocated, so a full map sized by n_unique would drop
        # live keys whose codes sit past it
        plan = plan_probe(st.fact_skew, bucket_width=st.bucket_width,
                          backend=self.device.type, impl=self.probe_impl,
                          code_space=int(idx.dictionary.n),
                          hash_mode=idx.table.hash_mode,
                          delta_slots=(0 if idx.delta is None
                                       else idx.delta.num_slots),
                          force=force)
        if plan.schedule == "hot_cold":
            fact = self.tables["lineorder"]
            fk = fact[FACT_FK[dim]]
            if plan.full_map:
                hot = torch.arange(plan.hot_entries, dtype=torch.int32,
                                   device=self.device)
            else:
                # rank hot keys over the logical rows only (capacity
                # padding would rank EMPTY_KEY as a hot key); the cold
                # capacity stays sized to the physical stream the probes
                # run over
                hot = encode(idx.dictionary, torch.as_tensor(
                    top_keys(fk[:fact.n_rows], plan.hot_entries),
                    device=self.device))
                # tighten the cold capacity to the exact measured count
                ht = build_hot_table(idx.table, hot, plan.hot_slots,
                                     probe_fn=probe_fn_for(self.probe_impl))
                codes = encode(idx.dictionary, fk)
                cold = int(fk.shape[0]
                           - hot_hit_count(idx.table, ht, codes))
                plan = refine_plan(plan, cold, int(fk.shape[0]))
            self._hot_codes[dim] = hot
        self.plans[dim] = plan

    @property
    def build_stats(self):
        """Final index geometry per dimension (jspim mode)."""
        return {d: ix.stats for d, ix in self.indexes.items()}

    # -- cross-query probe cache ------------------------------------------
    def probe_dim(self, dim: str) -> tuple[torch.Tensor, torch.Tensor]:
        """Cached (found, dim_row) for one dimension (probe once, reuse).

        Entries are stamped with the fact epoch they were probed (or
        tail-extended) at; a stale stamp reads as a miss.  The returned
        tensors never change afterwards: the engine gives up writing them
        in place, so the next append extends a copy.
        """
        hit = self._probe_cache.get(dim)
        if hit is not None:
            if self._probe_epoch.get(dim) == self._fact_epoch:
                self._hits += 1
                self._cache_owned.discard(dim)
                return hit
            self.invalidate_probe_cache(dim)  # stale epoch: defensive drop
        self._misses += 1
        out = self._probe_cache[dim] = self._join(dim)
        self._probe_epoch[dim] = self._fact_epoch
        # fresh tensors: a new generation no snapshot pins yet (the caller
        # holds them, so the next splice copies all the same)
        self._cache_gens[dim] = self._cache_gens.get(dim, 0) + 1
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
            self._cache_owned.clear()
        elif dim in self._probe_cache:
            self._invalidations += 1
            del self._probe_cache[dim]
            self._cache_owned.discard(dim)

    def cache_info(self) -> dict:
        return {"hits": self._hits, "misses": self._misses,
                "invalidations": self._invalidations,
                "cached_dims": sorted(self._probe_cache),
                "fact_epoch": self._fact_epoch}

    @property
    def epoch(self) -> int:
        """Monotone state epoch: bumped by every mutation that changes the
        engine's state (fact append, dimension ingest and deletes, the
        §3.2.3 update commands, compaction)."""
        return self._epoch

    # -- epoch snapshots ----------------------------------------------------
    def snapshot(self) -> "EpochSnapshot":
        """Freeze the current image as an ``EpochSnapshot``.

        The snapshot shares this engine's tensors (no copy) and answers
        queries bit-identically at this epoch while the engine advances.
        The engine's in-place writes (fact tail, probe-cache splice,
        compaction merge) never touch a generation a live snapshot pins:
        the first such mutation after the snapshot writes a fresh
        generation, and the in-place writes re-arm on it.  Release the
        snapshot (``release()``, a ``with`` block, or dropping it) to
        retire its pins.
        """
        # a freeze never interleaves with a mutation
        with trace.locked(self._mu, "snapshot"):
            snap = self._make_snapshot()
            self._snapshots.add(snap)
            self._snapshots_taken += 1
        return snap

    def _make_snapshot(self):
        from repro_torch.engine.snapshot import EpochSnapshot

        return EpochSnapshot(self)

    def _live_snapshots(self) -> list:
        with self._mu:  # release() discards from the set under this lock
            return [s for s in self._snapshots if not s.released]

    def _fact_pinned(self) -> bool:
        """Does a live snapshot pin the current fact capacity buffers?"""
        return any(s._pin_fact_gen == self._fact_gen
                   for s in self._live_snapshots())

    def _cache_pinned(self, dim: str) -> bool:
        """Does a live snapshot pin ``dim``'s current cached probes?"""
        g = self._cache_gens.get(dim, 0)
        return any(s._pin_cache_gens.get(dim) == g
                   for s in self._live_snapshots())

    def _index_pinned(self, dim: str) -> bool:
        """Does a live snapshot pin ``dim``'s current main-table planes?"""
        g = self._index_gens.get(dim, 0)
        return any(s._pin_index_gens.get(dim) == g
                   for s in self._live_snapshots())

    def _count_snapshot_reprobe(self) -> None:
        with self._count_mu:
            self._snapshot_reprobes += 1

    def snapshot_info(self) -> dict:
        """Epoch, snapshot and pin counters, and the lazy probes snapshots
        made (``snapshot_reprobes``)."""
        return {"epoch": self._epoch,
                "live_snapshots": len(self._live_snapshots()),
                "snapshots_taken": self._snapshots_taken,
                "pin_copies": self._pin_copies,
                "fact_gen": self._fact_gen,
                "snapshot_reprobes": self._snapshot_reprobes}

    # -- write-ahead log and mutation hooks ----------------------------------
    def _wal_log(self, kind: str, meta: dict | None = None,
                 arrays: dict | None = None) -> None:
        """Write-ahead hook, after validation and before any state changes:
        the durability tier appends and fsyncs the record, stamped with the
        epoch this mutation will publish (not on a volatile engine, nor
        during recovery's replay, which re-drives the API from the log);
        and the validated batch is staged for the mutation hooks, which
        ``_wal_publish`` delivers once the epoch publishes, so observers
        only see batches the engine applied."""
        d = self._durability
        if d is not None and not d.replaying:
            d.log_mutation(self, kind, meta, arrays)
        if self._mutation_hooks:
            self._pending_events.append(
                (kind, dict(meta or {}), dict(arrays or {})))

    def _wal_publish(self) -> None:
        """Post-publish hook: the durability tier weighs a checkpoint (the
        cost model's replay debt against the state write), then the staged
        batches reach the mutation hooks."""
        d = self._durability
        if d is not None and not d.replaying:
            d.on_publish(self)
        self._notify_hooks()

    def _notify_hooks(self) -> None:
        """Deliver staged batches to the hooks, in mutation order, under
        the engine lock (at the ``_wal_publish`` call sites).  Nested
        mutations (an auto-compaction inside ``ingest``, ``ingest`` inside
        ``append_rows``) stage several events that all drain at the
        outermost publish, stamped with the final epoch: the epoch their
        combined effect is visible at."""
        if not self._pending_events:
            return
        pending, self._pending_events = self._pending_events, []
        for kind, meta, arrays in pending:
            ev = MutationEvent(kind=kind, meta=meta, arrays=arrays,
                               epoch=self._epoch,
                               fact_epoch=self._fact_epoch)
            for hook in list(self._mutation_hooks):
                hook(ev)

    def add_mutation_hook(self, fn: Callable) -> None:
        """Subscribe ``fn(event: MutationEvent)`` to published mutations.
        Hooks run under the engine lock; keep them cheap and never call
        back into the engine's mutation methods from one."""
        with self._mu:
            self._mutation_hooks.append(fn)

    def remove_mutation_hook(self, fn: Callable) -> None:
        """Unsubscribe a hook added with ``add_mutation_hook``."""
        with self._mu:
            self._mutation_hooks.remove(fn)
            if not self._mutation_hooks:
                self._pending_events.clear()

    def register_view_suite(self, suite) -> None:
        """Attach a maintained-view suite (``repro_torch.ivm``): its hook
        subscribes to mutations, and ``snapshot()`` freezes its answers
        whenever it is fresh at the frozen epoch."""
        with self._mu:
            self._view_suites.append(suite)
            self._mutation_hooks.append(suite._on_event)

    def unregister_view_suite(self, suite) -> None:
        """Detach a suite registered with ``register_view_suite``."""
        with self._mu:
            self._view_suites.remove(suite)
            self._mutation_hooks.remove(suite._on_event)
            if not self._mutation_hooks:
                self._pending_events.clear()

    # -- durability (WAL + checkpoints, DESIGN.md §10) ----------------------
    def persist(self, root: str, **kw):
        """Start durability for this engine at a fresh ``root``.

        Writes a genesis checkpoint of the current epoch, opens the WAL
        and attaches the manager: from here every mutation batch is logged
        and fsynced before its epoch publishes, and checkpoints are taken
        on the cost model's trigger.  Recover later with
        ``SSBEngine.open(root)``.  Keyword arguments pass through to
        ``DurabilityManager`` (``fs``, ``keep``, ``min_log_bytes``,
        ``safety``, ``auto_checkpoint``); returns the manager.
        """
        from repro_torch.durability.manager import DurabilityManager

        with self._mu:
            self._check_open()
            if self._durability is not None:
                raise ValueError("this engine is already durable at "
                                 f"{self._durability.root!r}")
            return DurabilityManager.create(root, self, **kw)

    @classmethod
    def open(cls, root: str, **kw) -> "SSBEngine":
        """Recover an engine from a durability root (DESIGN.md §10), on the
        card unless ``device=`` names another.

        Restores the newest checkpoint whose leaves verify (falling back
        to older steps on corruption), truncates the WAL's torn tail,
        replays the log's suffix through the normal mutation API, and
        returns the engine with the log open for new mutations.  Keyword
        arguments pass through to ``durability.open_engine``.
        """
        from repro_torch.durability.manager import open_engine

        return open_engine(root, **kw)

    @property
    def durability(self):
        """The attached ``DurabilityManager``, or None (volatile engine)."""
        return self._durability

    def close(self) -> None:
        """Close the engine: detach durability and refuse every later
        mutation with ``RuntimeError``.  Idempotent.  A closed engine (and
        its live snapshots) keeps answering queries, so a serving tier can
        drain its reads while a recovered incarnation takes over."""
        with self._mu:
            if self._closed:
                return
            self._closed = True
            if self._durability is not None:
                self._durability.close()
                self._durability = None

    @property
    def closed(self) -> bool:
        return self._closed

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError(
                "engine is closed: mutations are refused (queries and "
                "held snapshots keep working; reopen the durability root "
                "with SSBEngine.open, or build a new engine, to mutate)")

    # -- §3.2.3 update commands (invalidate the affected dim's probes) -----
    def _replace_table(self, dim: str, table) -> None:
        if self._durability is not None:
            raise RuntimeError(
                "entry_update/index_update/table_update are raw §3.2.3 "
                "cell writes outside the WAL mandate: a durable engine "
                "would silently lose them on recovery; use ingest / "
                "append_rows, or close() durability first")
        self.indexes[dim] = dataclasses.replace(self.indexes[dim],
                                                table=table)
        # the update wrote fresh planes: a new generation (snapshots keep
        # the old table object)
        self._index_gens[dim] = self._index_gens.get(dim, 0) + 1
        self._epoch += 1
        self.invalidate_probe_cache(dim)
        if self._mutation_hooks:
            # a raw cell write bypasses the log (volatile engines only) and
            # cannot be maintained incrementally: observers invalidate on
            # this kind
            self._pending_events.append(("raw_update", {"dim": dim}, {}))
            self._notify_hooks()

    @_mutates
    def entry_update(self, dim: str, bucket, slot, key, value_word) -> None:
        """Entry Update: overwrite one (bucket, slot) cell of ``dim``.

        The paper's raw DRAM-cell write: ``key`` is a stored dictionary
        *code* (or EMPTY_KEY), not a raw dimension key."""
        self._replace_table(dim, _ht.entry_update(
            self.indexes[dim].table, bucket, slot, key, value_word))

    @_mutates
    def index_update(self, dim: str, key, new_payload) -> None:
        """Index Update: search raw ``key`` in ``dim``; update its payload.

        The table is keyed by dictionary codes, so the raw key is encoded
        first; an absent key encodes to NO_CODE and the update no-ops."""
        raw = torch.as_tensor(key, device=self.device).to(torch.int32)
        code = encode(self.indexes[dim].dictionary, raw.reshape(1))[0]
        self._replace_table(dim, _ht.index_update(
            self.indexes[dim].table, code, new_payload))

    @_mutates
    def table_update(self, dim: str, bucket_ids, new_keys,
                     new_values) -> None:
        """Table Update: burst-write whole buckets of ``dim``."""
        self._replace_table(dim, _ht.table_update(
            self.indexes[dim].table, bucket_ids, new_keys, new_values))

    # -- streaming ingest: delta buffer + compaction ------------------------
    @_mutates
    def ingest(self, dim: str, keys, payloads=None, *, op: str = "upsert",
               auto_compact: bool = True,
               _wal: bool = True) -> CompactionPlan:
        """Absorb a batch of index ops into ``dim``'s delta buffer.

        ``keys`` are raw dimension keys; ``op`` is "insert" / "upsert"
        (``payloads`` = dimension-row indices) or "delete" (tombstones).
        Drops the dimension's cached probes, then, when ``auto_compact``
        and the planner says so, folds the delta into the main table.
        Returns the planner's decision either way.  Batches are validated
        here and rejected with a ``ValueError`` naming the argument.
        ``_wal`` is internal: ``append_rows`` logs one record (and stages
        one event) covering its own ingest.
        """
        if self.mode != "jspim":
            raise ValueError("ingest requires jspim mode (no index to "
                             f"maintain in mode={self.mode!r})")
        if dim not in self.indexes:
            raise ValueError(f"dim: unknown dimension {dim!r} (have "
                             f"{sorted(self.indexes)})")
        if op not in ("insert", "upsert", "delete"):
            raise ValueError(f"op: expected insert/upsert/delete, "
                             f"got {op!r}")
        keys = _check_batch_col("keys", keys)
        if np.any(keys == _ht.EMPTY_KEY):
            raise ValueError("keys: EMPTY_KEY is reserved as the hash "
                             "slot sentinel and cannot be ingested")
        if op == "delete":
            payloads = None
        else:
            if payloads is None:
                raise ValueError(f"payloads: required for op={op!r} "
                                 "(the new dimension-row indices)")
            payloads = _check_batch_col("payloads", payloads,
                                        expect_len=keys.shape[0])
        if keys.shape[0] == 0:  # zero ops change no state
            return self.compaction_plan(dim)
        if _wal:
            arrays = {"keys": keys}
            if payloads is not None:
                arrays["payloads"] = payloads
            self._wal_log("ingest", {"dim": dim, "op": op}, arrays)
        before = self.indexes[dim].delta
        self.indexes[dim] = ingest_index(self.indexes[dim], keys, payloads,
                                         op=op)
        self._ingest_batches += 1
        # the delta is fresh but the main-table planes are the previous
        # index's: their generation stays, so a snapshot taken before the
        # ingest still pins them against an in-place compaction
        self._epoch += 1
        self.invalidate_probe_cache(dim)
        after = self.indexes[dim].delta
        if before is None or before.num_slots != after.num_slots:
            # the delta appeared (or grew): re-plan so the estimates price
            # the live overlay (it is schedule-independent, so the pick
            # itself cannot change)
            self._plan_dim(dim)
        plan = self.compaction_plan(dim)
        if auto_compact and plan.compact:
            self.compact(dim, _plan=plan)
        if _wal:
            self._wal_publish()
        return plan

    @_mutates
    def append_rows(self, dim: str, rows, *,
                    auto_compact: bool = True) -> None:
        """Append new rows to a dimension table and index them.

        ``rows`` maps every column of ``dim`` to a 1-D array of new values
        (validated: integer, 1-D, equal lengths).  The dimension table
        grows; in jspim mode the new PK -> row-index mappings stream into
        the delta buffer (no index rebuild); in every mode the dimension's
        cached probes drop.  A zero-row append is a no-op.
        ``auto_compact`` passes through to ``ingest``.
        """
        if dim not in DIM_PK:
            raise ValueError(f"dim: unknown dimension {dim!r} (have "
                             f"{sorted(DIM_PK)})")
        t = self.tables[dim]
        missing = set(t.names()) ^ set(rows)
        if missing:
            raise ValueError(f"append_rows({dim!r}) column mismatch: "
                             f"{sorted(missing)}")
        cols_np: dict[str, np.ndarray] = {}
        n_new: int | None = None
        for k in t.names():
            cols_np[k] = _check_batch_col(f"rows[{k!r}]", rows[k],
                                          expect_len=n_new)
            if n_new is None:
                n_new = cols_np[k].shape[0]
        if n_new == 0:
            return
        if self.mode == "jspim":
            # reject before any state changes: the internal ingest would
            # raise after the table grew, tearing the append
            if np.any(cols_np[DIM_PK[dim]] == _ht.EMPTY_KEY):
                raise ValueError(f"rows[{DIM_PK[dim]!r}]: EMPTY_KEY is "
                                 "reserved as the hash slot sentinel and "
                                 "cannot be a dimension primary key")
        self._wal_log("append_rows", {"dim": dim}, cols_np)
        n0 = t.n_rows
        self.tables[dim] = t.append(cols_np)
        if self.mode == "jspim":
            self.ingest(dim, cols_np[DIM_PK[dim]],
                        np.arange(n0, n0 + n_new, dtype=np.int32),
                        op="insert", auto_compact=auto_compact,
                        _wal=False)
        else:
            self._epoch += 1
            self.invalidate_probe_cache(dim)
        self._wal_publish()

    # -- fact-side streaming append: probe-cache tail extension ------------
    @_mutates
    def append_fact_rows(self, rows, *, extend_cache: bool = True) -> dict:
        """Append new lineorder rows; extend cached probes over the tail.

        ``rows`` maps every lineorder column to a 1-D integer array of new
        values (validated here; a bad column raises ``ValueError`` naming
        it).  The fact table grows through the pow2-bucketed capacity tail
        (``Table.append_tail``), FK columns padded with ``EMPTY_KEY`` so
        that padding never joins.  Each cached dimension probe is then
        *extended*: the padded tail alone is probed under the dimension's
        plan (delta overlay included) and spliced in.  ``plan_fact_append``
        prices that against a cold re-probe of the grown stream, on the
        engine's device, and a dimension whose extension loses is
        invalidated instead.  ``extend_cache=False`` invalidates every
        cached dimension.  A zero-row append is a strict no-op.

        The first append copies the fact columns into fresh capacity
        buffers, so tables shared with another engine or a caller never
        change; later appends write the tail window in place, unless a
        live snapshot pins those buffers: then the append writes a copy
        (counted in ``snapshot_info()["pin_copies"]``) and the next one
        writes that copy in place.  Probe tuples a caller took from
        ``probe_dim`` never change either, and the cached probes a live
        snapshot pins are extended into copies the same way.

        Returns a report: rows appended, the new fact epoch, whether the
        capacity grew, the per-dimension decision, and the dimensions
        re-planned for skew drift.
        """
        fact = self.tables["lineorder"]
        new_cols, n_new = self._fact_batch(rows)
        if n_new == 0:  # strict no-op: nothing moved, nothing invalidates
            return {"appended": 0, "epoch": self._fact_epoch, "dims": {},
                    "capacity_grew": False, "skew_replanned": []}
        self._wal_log("append_fact_rows", {}, new_cols)
        n0 = fact.n_rows
        pad_values = {FACT_FK[d]: _ht.EMPTY_KEY for d in FACT_FK}
        # one bucket for both write windows (table tail and cache splice)
        bp = tail_bucket(n_new)
        will_grow = n0 + bp > fact.n_physical
        if fact.tail_owned and not will_grow and self._fact_pinned():
            # a live snapshot reads these buffers: write a fresh generation
            # (a growing append writes fresh buffers whatever the pins, so
            # there a pin changes, and counts, nothing)
            fact = dataclasses.replace(fact, tail_owned=False)
            self._pin_copies += 1
        grown = fact.append_tail(new_cols, pad_values, bucket=bp)
        capacity_grew = grown.n_physical != fact.n_physical
        if capacity_grew or not fact.tail_owned:
            self._fact_gen += 1  # fresh buffers: no snapshot pins them yet
        self.tables["lineorder"] = grown
        self._epoch += 1
        self._fact_epoch += 1
        self._fact_appends += 1
        self._fact_rows_appended += int(n_new)
        report = {"appended": int(n_new), "epoch": self._fact_epoch,
                  "capacity_grew": capacity_grew, "dims": {}}
        if self.mode != "jspim":  # no index: probes must rerun from cold
            self.invalidate_probe_cache()
            report["skew_replanned"] = []
            self._wal_publish()
            return report
        for dim in sorted(self._probe_cache):
            with trace.span("engine.extend_probe", dim=dim) as sp:
                self._extend_cached(dim, grown, n0, bp, extend_cache, report)
                sp.set(decision=report["dims"][dim])
        report["skew_replanned"] = self._maybe_replan_fact_skew()
        self._wal_publish()
        return report

    def _extend_cached(self, dim: str, grown: Table, n0: int, bp: int,
                       extend_cache: bool, report: dict) -> None:
        """One cached dimension's part of ``append_fact_rows``: extend its
        probes over the padded tail, or drop them where the planner (or
        ``extend_cache=False``) says so; the decision goes into
        ``report["dims"]``."""
        ap = self._fact_append_plan(dim, bp, n0)
        if not (extend_cache and ap.extend):
            self.invalidate_probe_cache(dim)
            self._tail_reprobes += 1
            report["dims"][dim] = ap.reason if extend_cache \
                else "invalidated"
            return
        found, row = self._probe_cache[dim]
        owned = dim in self._cache_owned
        pinned_copy = owned and self._cache_pinned(dim)
        if pinned_copy:  # a live snapshot reads them: splice a copy
            owned = False
        fresh = not owned  # a copying splice makes a new generation
        if found.shape[0] != grown.n_physical:  # capacity grew: re-pad
            pad = grown.n_physical - found.shape[0]
            found = torch.cat([found, found.new_zeros(pad)])
            row = torch.cat([row, row.new_full((pad,), -1)])
            # fresh buffers, nobody else holds them (the concatenation
            # copied, pinned or not)
            owned, fresh, pinned_copy = True, True, False
        if pinned_copy:
            self._pin_copies += 1
        # the padded FK window just written into the fact column
        fk_tail = grown[FACT_FK[dim]].narrow(0, n0, bp)
        self._probe_cache[dim] = extend_cached_probe(
            effective_index(self.indexes[dim]), found, row, fk_tail, n0,
            self._hot_codes.get(dim), impl=self.probe_impl,
            plan=self.plans.get(dim), owned=owned)
        self._probe_epoch[dim] = self._fact_epoch
        self._cache_owned.add(dim)
        if fresh:
            self._cache_gens[dim] = self._cache_gens.get(dim, 0) + 1
        self._tail_extensions += 1
        report["dims"][dim] = "extended"

    def _fact_batch(self, rows) -> tuple[dict[str, np.ndarray], int]:
        """``append_fact_rows``' validated batch: every lineorder column,
        a 1-D int32 host array each, all of one length (a bad column
        raises ``ValueError`` naming it), and that length."""
        names = self.tables["lineorder"].names()
        missing = set(names) ^ set(rows)
        if missing:
            raise ValueError(f"append_fact_rows column mismatch: "
                             f"{sorted(missing)}")
        new_cols: dict[str, np.ndarray] = {}
        n_new: int | None = None
        for k in names:
            new_cols[k] = _check_batch_col(f"rows[{k!r}]", rows[k],
                                           expect_len=n_new)
            if n_new is None:
                n_new = new_cols[k].shape[0]
        return new_cols, n_new

    def _fact_append_plan(self, dim: str, n_tail: int,
                          n_cached: int) -> FactAppendPlan:
        """The planner's extend-or-reprobe decision for one cached dim."""
        idx = self.indexes[dim]
        st = idx.stats
        sk = st.fact_skew if st is not None else None
        return plan_fact_append(
            self.plans.get(dim) or SchedulePlan(schedule="gathered"),
            n_tail=n_tail, n_cached=n_cached,
            distinct=(sk.distinct if sk is not None
                      else int(idx.table.n_unique)),
            bucket_width=idx.table.bucket_width,
            delta_slots=0 if idx.delta is None else idx.delta.num_slots,
            backend=self.device.type)

    def _maybe_replan_fact_skew(self, force: bool = False) -> list[str]:
        """Re-measure fact-side skew after heavy append; re-plan drifters.

        Once the logical stream has grown ``FACT_REMEASURE_FRAC`` past the
        last measurement (or on ``force``), each dimension's FK column is
        re-measured over the logical rows; dimensions whose curve moved
        ``TOP_SHARE_DRIFT`` get fresh stats and a fresh plan.  When the
        decision (schedule and geometry) is unchanged the old plan and
        index metadata stay.  Cached probes stay either way: every
        schedule gives the same probes.
        """
        if self.mode != "jspim":
            return []
        fact = self.tables["lineorder"]
        n_valid = fact.n_rows
        base = max(1, self._skew_measured_rows)
        if not force and (n_valid - base) / base < FACT_REMEASURE_FRAC:
            return []
        self._skew_measured_rows = n_valid
        replanned: list[str] = []
        for dim in DIM_PK:
            idx = self.indexes[dim]
            st = idx.stats
            if st is None:
                continue
            fresh = measure_fact_skew(fact[FACT_FK[dim]][:n_valid], dim)
            self._skew_measures += 1
            if (st.fact_skew is not None
                    and skew_drift(st.fact_skew, fresh) < TOP_SHARE_DRIFT):
                continue
            with trace.span("engine.skew_replan", dim=dim) as sp:
                self.indexes[dim] = dataclasses.replace(
                    idx, stats=dataclasses.replace(st, fact_skew=fresh))
                old = self.plans.get(dim)
                self._plan_dim(dim)
                new = self.plans.get(dim)
                same = old is not None and (
                    old.schedule, old.hot_entries, old.hot_slots,
                    old.cold_capacity, old.full_map) == (
                    new.schedule, new.hot_entries, new.hot_slots,
                    new.cold_capacity, new.full_map)
                if same:
                    # same decision, fresher estimates: keep the old plan
                    # and index metadata (the drift trigger re-evaluates
                    # against the old baseline at the next re-measure)
                    self.plans[dim] = old
                    self.indexes[dim] = idx
                sp.set(old=None if old is None else old.schedule,
                       new=new.schedule, changed=not same)
            self._skew_replans += 1
            replanned.append(dim)
        return replanned

    @property
    def fact_epoch(self) -> int:
        """Monotone fact-snapshot counter (bumped per non-empty append);
        every probe-cache entry carries the epoch it is consistent with."""
        return self._fact_epoch

    def fact_append_info(self) -> dict:
        """Fact-side append/extension counters + tail geometry."""
        fact = self.tables["lineorder"]
        return {"fact_epoch": self._fact_epoch,
                "appends": self._fact_appends,
                "rows_appended": self._fact_rows_appended,
                "tail_extensions": self._tail_extensions,
                "tail_reprobes": self._tail_reprobes,
                "skew_measures": self._skew_measures,
                "skew_replans": self._skew_replans,
                "n_valid": fact.n_rows,
                "n_physical": fact.n_physical}

    def compaction_plan(self, dim: str) -> CompactionPlan:
        """The planner's compact-or-defer decision for ``dim`` right now,
        priced in the flavor ``compact`` would take (``swap`` while a live
        snapshot pins the planes)."""
        idx = self.indexes[dim]
        st = idx.stats
        ds = delta_stats(idx.delta) if idx.delta is not None else None
        return plan_compaction(
            delta_entries=0 if ds is None else ds.n_entries,
            delta_slots=0 if ds is None else ds.num_slots,
            fill_frac=0.0 if ds is None else ds.fill_frac,
            worst_bucket_frac=0.0 if ds is None else ds.worst_bucket_frac,
            n_build=(st.n_build if st is not None
                     else int(idx.table.n_build)),
            n_dict=int(idx.dictionary.n),
            bucket_width=idx.table.bucket_width,
            expected_probes=self.tables["lineorder"].n_rows,
            backend=self.device.type, pinned=self._index_pinned(dim))

    @_mutates
    def compact(self, dim: str, *, _plan: CompactionPlan | None = None
                ) -> None:
        """Fold ``dim``'s delta into its main table.

        With no buffered ops this is a strict no-op: no epoch, no cache
        invalidation, no re-plan (an all-empty delta is only stripped).
        While a live snapshot pins the main-table planes the merge takes
        the **swap** flavor (fresh planes; the snapshot keeps reading the
        old ones, and ``pin_copies`` counts it); otherwise the **in-place**
        flavor writes the touched bucket rows into the planes, so an index
        object taken from ``engine.indexes`` before the call must not be
        read after it: take a snapshot to keep reading it.  ``_plan`` is
        internal: the decision of an ``ingest`` that compacts, whose
        estimate a traced merge records.
        """
        idx = self.indexes[dim]
        if delta_is_empty(idx.delta):
            if idx.delta is not None:
                self.indexes[dim] = dataclasses.replace(idx, delta=None)
            return
        # logged after the empty check (an empty compact publishes nothing,
        # so it logs nothing); auto-compactions arrive here too, so replay
        # reproduces the live fold points
        self._wal_log("compact", {"dim": dim})
        pinned = self._index_pinned(dim)
        if pinned:
            self._pin_copies += 1
        # a merge no plan chose (a direct call) records no estimate
        est = {} if _plan is None else {"est_merge_s": _plan.est_merge_s}
        with trace.span("engine.compact", dim=dim,
                        flavor="swap" if pinned else "in_place", **est):
            self.indexes[dim] = compact_index(idx, donate=not pinned)
        self._publish_compaction(dim)
        self._wal_publish()

    def _publish_compaction(self, dim: str) -> None:
        # either flavor leaves a generation no snapshot pins: the swap
        # wrote fresh planes, and the in-place merge wrote unpinned ones
        self._index_gens[dim] = self._index_gens.get(dim, 0) + 1
        self._epoch += 1
        self._compactions += 1
        self.invalidate_probe_cache(dim)
        # the code space and geometry changed: re-plan
        self._plan_dim(dim)

    # -- background compaction (off the serving path) ---------------------
    def prepare_compact(self, dim: str):
        """Stage ``dim``'s merge without holding up queries or ingest.

        Runs ``compact_index``'s swap flavor (fresh planes; the live
        table, every snapshot and every cached probe stay untouched) with
        the engine lock released during the merge, so a background thread
        can fold while the serving path answers.  Returns a token for
        ``publish_compact``, or ``None`` when there is nothing to fold.
        """
        with trace.locked(self._mu, "prepare_compact"):
            self._check_open()
            if dim not in self.indexes:
                raise ValueError(f"dim: unknown dimension {dim!r} (have "
                                 f"{sorted(self.indexes)})")
            idx = self.indexes[dim]
        if delta_is_empty(idx.delta):
            return None
        # no plan chose this merge: its span has no estimate
        with trace.span("engine.compact", dim=dim, flavor="swap"):
            return dim, idx, compact_index(idx, donate=False)

    def publish_compact(self, prepared) -> bool:
        """Publish a staged merge as one epoch.  Returns ``False`` (the
        merge dropped, nothing changed) when the dimension's index changed
        after ``prepare_compact`` read it: the merge folded a delta that
        is no longer the live one, and publishing would lose the newer
        ops.  The caller stages again."""
        if prepared is None:
            return False
        dim, source, merged = prepared
        with trace.locked(self._mu, "publish_compact"):
            self._check_open()
            if self.indexes[dim] is not source:
                return False
            self._wal_log("compact", {"dim": dim})
            self.indexes[dim] = merged
            self._publish_compaction(dim)
            self._wal_publish()
            return True

    def ingest_info(self) -> dict:
        """Ingest/compaction counters + per-dim delta occupancy."""
        deltas = {d: dataclasses.asdict(delta_stats(ix.delta))
                  for d, ix in self.indexes.items() if ix.delta is not None}
        return {"ingest_batches": self._ingest_batches,
                "compactions": self._compactions, "deltas": deltas}

    # -- the reference loop: no cache, no schedule -------------------------
    def run_eager(self, name: str) -> tuple[torch.Tensor, torch.Tensor]:
        """The seed per-query loop: every joined dimension probed afresh
        (no probe cache, no schedule, no filter kernel), then the shared
        query tail.  Kept as the reference the other paths are held
        against."""
        spec = SSB_QUERIES[name]
        fact_cols, dim_cols = self._cols(spec.joined_dims())
        probes = {d: self._join(d, eager=True) for d in spec.joined_dims()}
        return _filter_aggregate(spec, fact_cols, dim_cols, probes)
