"""Incremental view maintenance for the SSB suite: O(batch) per mutation.

PyTorch port of ``repro.ivm.maintain``.  :class:`MaintainedSuite`
subscribes to an :class:`SSBEngine`'s mutation hooks and keeps all 13 SSB
answers current per mutation batch by touching only the rows the batch
changed:

- ``append_fact_rows``: the new fact rows contribute weight ``+1``
  through every view's filter -> mask -> segment-sum tail, which is
  linear.
- ``ingest`` (insert, upsert, delete) / ``append_rows``: only the join is
  bilinear, so it carries chain-rule state: the maintained per-dimension
  probe rows (fact row -> dimension row, or -1) and postings (dimension
  key -> fact rows).  A key whose mapping changes retracts the old
  contribution of exactly its posting rows (weight ``-1`` under the old
  state) and re-adds them (``+1`` under the new).
- ``compact``: a change of representation, not of the logical map: no-op.
- ``raw_update`` (§3.2.3 cell writes) and any unknown kind invalidate the
  suite; ``rebuild()`` recovers, and the serving tier recomputes
  meanwhile.

The state is host numpy, as in the reference: the suite copies the
engine's tables (and its indexes' logical key -> row maps) off the card
once, at attach and rebuild, and afterwards reads only each event's
arrays.  The reference keeps the maps and postings in Python dicts and
walks the fact rows one by one; here they are sorted arrays (a key map
of sorted keys beside their rows, postings as sorted ``key << 32 | row``
runs, one per attach and per fact append, merged when they pile up), so
the walk is a sort, which an SF10 attach needs.  Evaluation mirrors the
reference's operation for operation (int32 per-element ops, int64
accumulation, clip-gathers against the current dimension length), so the
answers are the reference's and the engine's bit for bit.
"""
from __future__ import annotations

import time
import traceback

import numpy as np

from repro_torch.core.delta import weighted_entries
from repro_torch.core.dictionary import decode
from repro_torch.core.hash_table import EMPTY_KEY, table_entries
from repro_torch.engine.queries import DIM_PK, FACT_FK, SSB_QUERIES
from repro_torch.ivm.views import QueryView, _Cols

_ROW_MASK = np.int64(0xFFFFFFFF)
# postings runs kept apart before they are merged into one
MAX_POSTING_RUNS = 8


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)


def _last_wins(keys: np.ndarray, *cols: np.ndarray):
    """Sorted unique ``keys`` with each one's last occurrence of ``cols``
    (a batch applied in order: the last write wins)."""
    keys = np.asarray(keys, np.int64)
    u, first_rev = np.unique(keys[::-1], return_index=True)
    last = keys.shape[0] - 1 - first_rev
    return (u, *(np.asarray(c)[last] for c in cols))


class _Grow:
    """Amortized-append host column: a capacity-doubling numpy buffer."""

    __slots__ = ("buf", "n")

    def __init__(self, a: np.ndarray):
        a = np.asarray(a)
        self.n = int(a.shape[0])
        cap = max(16, 1 << max(1, int(self.n)).bit_length())
        self.buf = np.empty((cap,), a.dtype)
        self.buf[:self.n] = a

    def view(self) -> np.ndarray:
        return self.buf[:self.n]

    def append(self, a: np.ndarray) -> None:
        a = np.asarray(a, self.buf.dtype)
        m = int(a.shape[0])
        if self.n + m > self.buf.shape[0]:
            cap = 1 << int(self.n + m).bit_length()
            nb = np.empty((cap,), self.buf.dtype)
            nb[:self.n] = self.buf[:self.n]
            self.buf = nb
        self.buf[self.n:self.n + m] = a
        self.n += m


class _KeyMap:
    """Raw dimension key -> dimension row, as sorted keys beside rows."""

    __slots__ = ("keys", "rows")

    def __init__(self, keys: np.ndarray, rows: np.ndarray):
        self.keys = keys   # sorted unique int64
        self.rows = rows   # int64

    def find(self, q: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(present, position) of sorted unique keys ``q``; a position is
        meaningful only where present."""
        if self.keys.shape[0] == 0:
            return np.zeros(q.shape, bool), np.zeros(q.shape, np.int64)
        pos = np.searchsorted(self.keys, q)
        pc = np.minimum(pos, self.keys.shape[0] - 1)
        return (pos < self.keys.shape[0]) & (self.keys[pc] == q), pc

    def rows_of(self, q: np.ndarray) -> np.ndarray:
        """Row of each key of ``q`` (any order, repeats), -1 where absent:
        the reference's ``km.get(key, -1)``."""
        u, inv = np.unique(np.asarray(q, np.int64), return_inverse=True)
        present, pc = self.find(u)
        if self.keys.shape[0] == 0:
            return np.full(inv.size, -1, np.int64)
        return np.where(present, self.rows[pc], -1)[inv.reshape(-1)]

    def update(self, keys: np.ndarray, rows: np.ndarray,
               present: np.ndarray) -> None:
        """Set (``present``) or remove each of the sorted unique ``keys``."""
        found, pc = self.find(keys)
        self.rows[pc[found & present]] = rows[found & present]
        keep = np.ones(self.keys.shape[0], bool)
        keep[pc[found & ~present]] = False
        new = ~found & present
        kk, kr = self.keys[keep], self.rows[keep]
        at = np.searchsorted(kk, keys[new])
        self.keys = np.insert(kk, at, keys[new])
        self.rows = np.insert(kr, at, rows[new])


class _Postings:
    """Dimension key -> the fact rows holding it, as sorted runs of packed
    ``key << 32 | row`` (EMPTY_KEY rows left out: no key maps there)."""

    __slots__ = ("runs",)

    def __init__(self):
        self.runs: list[np.ndarray] = []

    def add(self, fk: np.ndarray, base: int) -> np.ndarray:
        """Post fact rows ``base..base+len(fk)``; returns the new run."""
        fk = np.asarray(fk)
        keep = np.flatnonzero(fk != EMPTY_KEY)
        run = (fk[keep].astype(np.int64) << 32) | (keep + np.int64(base))
        run.sort()
        self.runs.append(run)
        if len(self.runs) > MAX_POSTING_RUNS:
            merged = np.concatenate(self.runs)
            merged.sort()
            self.runs = [merged]
        return run

    def rows_of(self, keys: np.ndarray) -> np.ndarray:
        """The fact rows holding any of the sorted unique ``keys``."""
        keys = np.asarray(keys, np.int64)
        out = []
        for run in self.runs:
            lo = np.searchsorted(run, keys << 32)
            hi = np.searchsorted(run, (keys << 32) | _ROW_MASK, side="right")
            counts = hi - lo
            total = int(counts.sum())
            if total == 0:
                continue
            starts = np.repeat(lo - (np.cumsum(counts) - counts), counts)
            out.append(run[starts + np.arange(total)] & _ROW_MASK)
        if not out:
            return np.zeros(0, np.int64)
        return np.concatenate(out)


def _rows_through(run: np.ndarray, km: _KeyMap, n: int,
                  base: int) -> np.ndarray:
    """Maintained probe rows of fact rows ``base..base+n`` from their
    sorted posting run: each distinct key looked up once."""
    rr = np.full(n, -1, np.int32)
    if run.shape[0]:
        keys = run >> 32
        starts = np.flatnonzero(np.concatenate(([True],
                                                keys[1:] != keys[:-1])))
        counts = np.diff(np.append(starts, keys.shape[0]))
        found = km.rows_of(keys[starts])
        rr[(run & _ROW_MASK) - base] = np.repeat(found, counts)
    return rr


class _LazyRows:
    """Fact columns gathered at ``rows`` on first use."""

    __slots__ = ("_fact", "_rows", "_cache")

    def __init__(self, fact: dict, rows):
        self._fact, self._rows, self._cache = fact, rows, {}

    def __getitem__(self, name):
        col = self._cache.get(name)
        if col is None:
            col = self._cache[name] = self._fact[name][self._rows]
        return col


class MaintainedSuite:
    """All 13 SSB results maintained per mutation batch.

    Build with :meth:`attach` (builds the state and registers the hook
    atomically under the engine lock)::

        suite = MaintainedSuite.attach(engine)
        engine.append_fact_rows(rows)      # the suite absorbs the batch
        suite.results()["Q1.1"]            # == engine.run_all()["Q1.1"]

    ``valid`` turns False on a mutation the suite cannot maintain (a raw
    §3.2.3 cell write, an internal inconsistency); the suite then ignores
    events until :meth:`rebuild`.  Consumers check :meth:`fresh_at`
    before serving.
    """

    def __init__(self, engine, names=None):
        if engine.mode != "jspim":
            raise ValueError("MaintainedSuite requires jspim mode (the "
                             "maintained join state mirrors the delta-"
                             f"overlay index; mode={engine.mode!r})")
        self._engine = engine
        self.names = tuple(sorted(names if names is not None
                                  else SSB_QUERIES))
        for n in self.names:
            if n not in SSB_QUERIES:
                raise ValueError(f"unknown query {n!r}")
        self.stats = {"events": 0, "maintain_s": 0.0, "rebuilds": 0,
                      "invalidations": 0, "errors": 0, "rows_touched": 0}
        self.last_error: str | None = None
        with engine._mu:
            self._init_state()

    @classmethod
    def attach(cls, engine, names=None) -> "MaintainedSuite":
        """Build the suite and subscribe it, atomically (no mutation can
        land between the state build and the hook registration)."""
        with engine._mu:
            suite = cls(engine, names)
            engine.register_view_suite(suite)
        return suite

    def detach(self) -> None:
        self._engine.unregister_view_suite(self)

    # -- state construction ------------------------------------------------
    def _init_state(self) -> None:
        eng = self._engine
        fact = eng.tables["lineorder"]
        # logical rows only (a prefix: capacity padding never joins; a
        # sharded engine refuses the attach at more than 1 shard)
        n = fact.n_rows
        self._fact = {k: _Grow(_np(fact[k][:n])) for k in fact.names()}
        self._n = n
        self._dims, self._dim_n, self._km = {}, {}, {}
        self._rows, self._post, self._over = {}, {}, {}
        self._dmasks = {}
        for dim in DIM_PK:
            t = eng.tables[dim]
            self._dims[dim] = {k: _Grow(_np(t[k])) for k in t.names()}
            self._dim_n[dim] = t.n_rows
            self._km[dim] = self._build_key_map(dim)
            post = self._post[dim] = _Postings()
            run = post.add(self._fact[FACT_FK[dim]].view(), 0)
            rr = _rows_through(run, self._km[dim], n, 0)
            self._rows[dim] = _Grow(rr)
            self._over[dim] = np.flatnonzero(rr >= self._dim_n[dim])
        self._views = [QueryView(SSB_QUERIES[q]) for q in self.names]
        self._apply(1, slice(0, n))
        self.valid = True
        self.epoch = eng.epoch
        self.fact_epoch = eng.fact_epoch

    def _build_key_map(self, dim: str) -> _KeyMap:
        """Raw key -> dimension row as the engine's probe resolves it: the
        main table's entries (the last of a key's entries wins), then the
        delta's weighted entries in order (``+1`` sets, ``-1`` removes)."""
        idx = self._engine.indexes[dim]
        codes, payloads, valid = table_entries(idx.table)
        keys = _np(decode(idx.dictionary, codes))
        ok = _np(valid).astype(bool)
        km = _KeyMap(*_last_wins(keys[ok], _np(payloads)[ok].astype(
            np.int64)))
        if idx.delta is not None:
            dk, dp, dw = (_np(x) for x in weighted_entries(idx.delta))
            op = dw != 0
            u, rows, w = _last_wins(dk[op], dp[op].astype(np.int64), dw[op])
            km.update(u, rows, w > 0)
        return km

    def rebuild(self) -> None:
        """Recover from invalidation: rebuild the state from the live
        engine (under its lock, so no batch is half-absorbed)."""
        with self._engine._mu:
            self._init_state()
        self.stats["rebuilds"] += 1

    # -- serving surface ---------------------------------------------------
    def fresh_at(self, epoch: int) -> bool:
        """Is the maintained answer exactly the image at ``epoch``?"""
        return self.valid and self.epoch == epoch

    def results(self) -> dict:
        """``{name: (total, groups)}`` copies, safe to hold across further
        mutations."""
        return {v.spec.name: v.result() for v in self._views}

    def view(self, name: str) -> QueryView:
        return self._views[self.names.index(name)]

    # -- mutation-hook delivery --------------------------------------------
    def _on_event(self, ev) -> None:
        t0 = time.perf_counter()
        try:
            if self.valid:
                self._dispatch(ev)
        except Exception:
            # never serve an answer the state may have torn: invalidate,
            # keep the traceback, and let the engine's mutation go on
            self.valid = False
            self.stats["errors"] += 1
            self.last_error = traceback.format_exc()
        finally:
            self.epoch = ev.epoch
            self.fact_epoch = ev.fact_epoch
            self.stats["events"] += 1
            self.stats["maintain_s"] += time.perf_counter() - t0

    def _dispatch(self, ev) -> None:
        if ev.kind == "append_fact_rows":
            self._on_append_fact(ev.arrays)
        elif ev.kind == "ingest":
            self._on_ingest(ev.meta["dim"], ev.meta["op"], ev.arrays)
        elif ev.kind == "append_rows":
            self._on_append_dim(ev.meta["dim"], ev.arrays)
        elif ev.kind == "compact":
            pass  # a change of representation: the logical map is fixed
        else:
            # raw_update (§3.2.3 cell writes) or an unknown kind: not
            # maintainable; invalidate and let readers recompute
            self.valid = False
            self.stats["invalidations"] += 1

    # -- event handlers ----------------------------------------------------
    def _on_append_fact(self, cols: dict) -> None:
        n_new = int(np.asarray(cols["orderkey"]).shape[0])
        n0 = self._n
        for k, g in self._fact.items():
            g.append(cols[k])
        self._n = n0 + n_new
        if self._n != self._engine.tables["lineorder"].n_rows:
            self.valid = False  # mirror out of step: never serve wrong
            self.stats["invalidations"] += 1
            return
        for dim in DIM_PK:
            run = self._post[dim].add(cols[FACT_FK[dim]], n0)
            rr = _rows_through(run, self._km[dim], n_new, n0)
            self._rows[dim].append(rr)
            self._over[dim] = np.concatenate(
                [self._over[dim], n0 + np.flatnonzero(rr >= self._dim_n[dim])])
        self.stats["rows_touched"] += n_new
        self._apply(1, slice(n0, self._n))

    def _changed(self, dim: str, keys: np.ndarray, rows: np.ndarray,
                 present: np.ndarray):
        """The batch's keys (sorted unique, last write wins) whose mapping
        moves: set where absent or mapped elsewhere, removed where
        present (an upsert to the same row changes nothing)."""
        km = self._km[dim]
        found, pc = km.find(keys)
        if km.keys.shape[0] == 0:
            moved = present
        else:
            moved = np.where(present, ~found | (km.rows[pc] != rows), found)
        return keys[moved], rows[moved], present[moved]

    def _affected_rows(self, dim: str, keys: np.ndarray,
                       with_over: bool = False) -> np.ndarray:
        aff = self._post[dim].rows_of(keys)
        if with_over:
            aff = np.concatenate([aff, self._over[dim]])
        return np.unique(aff)

    def _repoint(self, dim: str, changed, aff: np.ndarray) -> None:
        """Phase B of the join chain rule: commit the new key mappings and
        refresh the maintained probe rows of the affected fact rows."""
        self._km[dim].update(*changed)
        rr = self._km[dim].rows_of(self._fact[FACT_FK[dim]].view()[aff])
        self._rows[dim].view()[aff] = rr
        over = self._over[dim]
        self._over[dim] = np.union1d(over[~np.isin(over, aff)],
                                     aff[rr >= self._dim_n[dim]])

    def _on_ingest(self, dim: str, op: str, arrays: dict) -> None:
        keys = np.asarray(arrays["keys"])
        if op == "delete":
            u, = _last_wins(keys)
            changed = self._changed(dim, u, np.zeros(u.shape, np.int64),
                                    np.zeros(u.shape, bool))
        else:
            u, rows = _last_wins(keys, np.asarray(arrays["payloads"],
                                                  np.int64))
            changed = self._changed(dim, u, rows, np.ones(u.shape, bool))
        if changed[0].shape[0] == 0:
            return
        aff = self._affected_rows(dim, changed[0])
        self.stats["rows_touched"] += aff.shape[0]
        self._apply(-1, aff)             # retract under the old mapping
        self._repoint(dim, changed, aff)
        self._apply(1, aff)              # re-add under the new mapping

    def _on_append_dim(self, dim: str, cols: dict) -> None:
        pk = np.asarray(cols[DIM_PK[dim]])
        n0 = self._dim_n[dim]
        u, rows = _last_wins(pk, n0 + np.arange(pk.shape[0], dtype=np.int64))
        changed = self._changed(dim, u, rows, np.ones(u.shape, bool))
        # over-range rows re-evaluate too: their clip target (the
        # dimension's last row) moves when the table grows, even where
        # their key's mapping does not
        aff = self._affected_rows(dim, changed[0], with_over=True)
        self.stats["rows_touched"] += aff.shape[0]
        self._apply(-1, aff)             # old columns, old length, old map
        for k, g in self._dims[dim].items():
            g.append(cols[k])
        self._dim_n[dim] = n0 + pk.shape[0]
        if self._dim_n[dim] != self._engine.tables[dim].n_rows:
            self.valid = False
            self.stats["invalidations"] += 1
            return
        for key in [k for k in self._dmasks if k[1] == dim]:
            del self._dmasks[key]        # filter masks follow the length
        self._repoint(dim, changed, aff)
        self._apply(1, aff)              # new columns, new length, new map

    # -- weighted evaluation ----------------------------------------------
    def _dmask(self, spec, dim: str) -> np.ndarray:
        key = (spec.name, dim)
        dm = self._dmasks.get(key)
        if dm is None:
            dm = np.asarray(spec.dim_filters[dim](_Cols(
                {k: g.view() for k, g in self._dims[dim].items()})))
            self._dmasks[key] = dm
        return dm

    def _apply(self, sign: int, idx) -> None:
        """Push the weighted contribution of fact rows ``idx`` (a slice or
        an index array) under the current chain-rule state through every
        view's linear tail.  Each view's join mask comes first; the fact
        filter, measure and group key, all elementwise, are evaluated on
        the rows the mask keeps (the reference evaluates them on every
        row and masks after: the same records)."""
        if isinstance(idx, slice):
            n = idx.stop - idx.start

            def at(sel):  # fact rows of positions ``sel`` in ``idx``
                return sel + idx.start
        else:
            n = idx.shape[0]

            def at(sel):
                return idx[sel]
        if n == 0:
            return
        rows = {d: self._rows[d].view()[idx] for d in DIM_PK}
        fact = {k: g.view() for k, g in self._fact.items()}
        joined, clipped = {}, {}

        def clip(dim, size):
            key = (dim, size)
            c = clipped.get(key)
            if c is None:
                c = clipped[key] = np.clip(rows[dim], 0, size - 1)
            return c

        for view in self._views:
            spec = view.spec
            mask = None
            for dim in spec.joined_dims():
                m = joined.get(dim)
                if m is None:
                    m = joined[dim] = rows[dim] >= 0
                if dim in spec.dim_filters:
                    dm = self._dmask(spec, dim)
                    m = m & dm[clip(dim, dm.shape[0])]
                mask = m if mask is None else mask & m
            sel = np.flatnonzero(mask)
            if spec.fact_filter is not None:
                keep = np.asarray(spec.fact_filter(_LazyRows(fact, at(sel))))
                sel = sel[keep]
            ft = _LazyRows(fact, at(sel))
            measure = np.asarray(spec.measure(ft)).astype(np.int64)
            gk = None
            if spec.group_by:
                gk = np.zeros(sel.shape[0], np.int64)
                for dim, col, card in spec.group_by:
                    c = self._dims[dim][col].view()
                    gk = gk * card + (c[clip(dim, c.shape[0])[sel]] % card)
            view.apply(np.ones(sel.shape[0], bool), measure, gk, sign)
