"""The sharded fact engine: rank-parallel mutation and query.

PyTorch port of ``repro.engine.shard``, the software form of JSPIM's
rank-level parallelism (§3.3): every rank holds the shared dimension
indexes (dictionary, hash table, delta buffer, all small next to the fact
table) and owns one contiguous shard of every fact column, so probes,
tail extensions and appends need no traffic between ranks.

The ranks are the regions of a ``ShardMesh`` on one device
(``launch/mesh.py``): each fact column is ONE ``(ndev * shard_cap,)``
int32 tensor, and ``col.view(ndev, shard_cap)[r]`` is shard ``r``.  That
is the reference's sharded array seen whole, bit for bit, so the parent
engine's whole-column paths (the query tails, the mega path, snapshots)
run on it unchanged, as the reference's do.

:class:`ShardedSSBEngine` subclasses :class:`SSBEngine` and keeps its
contract (probe cache with epoch stamps, snapshot pins, WAL and mutation
hooks, dimension ingest and compaction) while re-implementing the fact
side:

* **Per-shard capacity tails.**  Each region behaves like
  ``Table.append_tail``'s pow2-bucketed tail.  ``append_fact_rows``
  splits a batch into ``ndev`` contiguous sub-batches; a short last one
  is padded with *dead rows* (every FK ``EMPTY_KEY``, measures 0) so the
  per-shard windows stay uniform.  Dead rows miss every probe and every
  SSB query joins at least one dimension, so they fall out of every
  aggregate; int32 sums are exact under any row partition, so the answers
  equal a single-device engine's bit for bit.
* **Sharded probes.**  Probes and probe-cache tail extensions run region
  by region (``join.sharded_probe_program``, ``sharded_extend_program``).
* **Epoch stamps.**  Every publish writes the new epoch into an
  ``(ndev,)`` stamp tensor before the hooks run; ``snapshot()`` checks
  that the stamps are uniform and equal the engine epoch, so a torn
  publish fails loudly instead of freezing a mixed-epoch image.
* **Reshard** (``reshard``) re-opens the logical image on another mesh
  through ``launch/elastic.py:shard_fact_columns``: fact columns pad to
  the new shard multiple, dimension state carries over, the answers stay
  the same.
* **Streamed open** (``from_streamed``): dimensions are generated on the
  host, fact rows arrive in chunks (``engine/ssb.py:stream_ssb_fact``)
  appended straight into the shard tails.

Caveats, as in the reference: ``mode="jspim"`` with ``kernel="torch"``
only and no ``stream``/``hot_cold`` schedule
(``core.policy.validate_sharded``); ``Table.trimmed()`` on the sharded
fact table is meaningless (live rows are not a physical prefix: use
``logical_fact_columns``).  For the same reason, at more than one shard
``persist`` and ``register_view_suite`` (the IVM attach) raise: the
checkpoint and the maintained views read the fact table as a prefix of
its live rows.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import hash_table as _ht
from repro_torch.core.planner import SchedulePlan
from repro_torch.core.policy import (ExecutionPolicy, resolve_policy,
                                     validate_sharded)
from repro_torch.engine.join import (DimIndex, build_dim_index,
                                     effective_index, sharded_extend_program)
from repro_torch.engine.queries import DIM_PK, FACT_FK, SSBEngine, _mutates
from repro_torch.engine.snapshot import ShardedEpochSnapshot, sharded_join
from repro_torch.engine.table import (TAIL_GROWTH_BATCHES, TAIL_MIN_BUCKET,
                                      TAIL_RESERVE_FRAC, Table, round_up,
                                      tail_bucket)
from repro_torch.launch import elastic
from repro_torch.launch.mesh import ShardMesh, make_data_mesh

_FK_COLS = frozenset(FACT_FK.values())

# what the prefix readers' refusal names
_PREFIX_CAVEAT = ("the live fact rows of a sharded engine are not a prefix "
                  "of its columns, and this path reads them as one "
                  "(ROADMAP Queue 3, the prefix-read caveat); reshard to 1 "
                  "shard first")


def _grow_regions(col: torch.Tensor, ndev: int, cap: int, new_cap: int,
                  fill: int) -> torch.Tensor:
    """``col``'s ``ndev`` regions of ``cap`` rows, each extended to
    ``new_cap`` rows with ``fill``: a concatenation along the region
    axis, into fresh buffers."""
    out = torch.full((ndev, new_cap), fill, dtype=col.dtype,
                     device=col.device)
    out[:, :cap] = col.view(ndev, cap)
    return out.view(-1)


class ShardedSSBEngine(SSBEngine):
    """:class:`SSBEngine` with the fact table split into shard regions.

    ``mesh`` (a ``ShardMesh``; default: one shard on the card) names the
    regions and the device; ``axis`` the shard axis.  Every table must
    already live on ``mesh.device``, or the constructor raises as
    ``SSBEngine`` does.  Everything the parent serves (``run``,
    ``run_all``, ``probe_dim``, ``snapshot``, ``ingest``, ``append_rows``,
    ``compact``) works unchanged; fact appends and probes run shard by
    shard.  Answers are bit-identical to a single-device
    :class:`SSBEngine` over the same logical rows.

    ``policy=None`` resolves to ``ExecutionPolicy(kernel="torch")``, the
    sharded subspace's only kernel: the port's global default kernel is
    ``"cuda"``, where the reference's is ``"xla"``, which its sharded
    subspace holds.  An explicit ``kernel="cuda"`` raises with the
    reference's message.
    """

    def __init__(self, tables: dict[str, Table], *,
                 mesh: ShardMesh | None = None, axis: str = "data",
                 indexes: dict[str, DimIndex] | None = None,
                 policy: ExecutionPolicy | None = None,
                 min_bucket: int = TAIL_MIN_BUCKET):
        pol = validate_sharded(resolve_policy(policy) if policy is not None
                               else ExecutionPolicy(kernel="torch"))
        if mesh is None:
            mesh = make_data_mesh(1, axis=axis)
        for name, t in tables.items():
            if t.device != mesh.device:
                raise ValueError(f"table {name!r} lives on {t.device}, the "
                                 f"engine runs on {mesh.device}")
        self.mesh = mesh
        self.axis = axis
        self._ndev = int(mesh.shape[axis])
        self._min_bucket = int(min_bucket)
        fact = tables["lineorder"]
        n0 = fact.n_rows
        self._fills = {k: (_ht.EMPTY_KEY if k in _FK_COLS else 0)
                       for k in fact.names()}
        cols = {k: fact[k][:n0] for k in fact.names()}
        for col in sorted(_FK_COLS):
            if n0 and bool((cols[col] == _ht.EMPTY_KEY).any()):
                raise ValueError(
                    f"lineorder[{col!r}] contains EMPTY_KEY: the sentinel "
                    "marks dead shard-filler rows and cannot appear in live "
                    "fact rows")
        # the initial per-shard capacity follows append_tail's reserve rule
        per = elastic.shard_multiple(n0, self._ndev) // self._ndev
        if n0:
            reserve = max(TAIL_GROWTH_BATCHES * self._min_bucket,
                          int(per * TAIL_RESERVE_FRAC))
            cap = round_up(per + reserve, self._min_bucket)
        else:
            cap = 0  # the first append grows from empty
        sharded, cap, per = elastic.shard_fact_columns(
            cols, mesh, axis=axis, fills=self._fills, cap_per_shard=cap)
        tables = dict(tables)
        tables["lineorder"] = Table(sharded, valid_rows=n0)
        if indexes is None and pol.mode == "jspim":
            # built from the (small) dimension tables only: the fact FK
            # columns are not measured, so planning is shard-local
            indexes = {dim: build_dim_index(tables[dim][pk])
                       for dim, pk in DIM_PK.items()}
        super().__init__(tables, indexes=indexes, policy=pol,
                         device=mesh.device)
        self._shard_cap = cap      # physical rows per shard
        self._shard_valid = per    # written rows per shard (live + dead)
        self._n_live = n0          # live rows across the mesh
        self._shard_owned = False  # buffers the next write may reuse
        # (start, per, n_live) per append window: the layout record that
        # reassembles the logical row order from the regions
        self._windows: list[tuple[int, int, int]] = \
            [(0, per, n0)] if n0 else []
        self._stamp()

    # -- streamed open at scale --------------------------------------------
    @classmethod
    def from_streamed(cls, sf: float, seed: int = 0, *,
                      mesh: ShardMesh | None = None, axis: str = "data",
                      chunk_rows: int = 1 << 20,
                      policy: ExecutionPolicy | None = None,
                      min_bucket: int = TAIL_MIN_BUCKET
                      ) -> "ShardedSSBEngine":
        """Open SSB at scale factor ``sf`` without materializing the fact
        table on the host: dimensions are generated on the mesh's device,
        fact rows stream in ``chunk_rows``-row appends straight into the
        per-shard capacity tails."""
        from repro_torch.engine.ssb import (LINEORDER_COLUMNS,
                                            generate_ssb_dims,
                                            stream_ssb_fact)

        if mesh is None:
            mesh = make_data_mesh(1, axis=axis)
        tables = generate_ssb_dims(sf, seed, device=mesh.device)
        tables["lineorder"] = Table.from_numpy(
            {k: np.zeros((0,), np.int32) for k in LINEORDER_COLUMNS},
            mesh.device)
        eng = cls(tables, mesh=mesh, axis=axis, policy=policy,
                  min_bucket=min_bucket)
        for chunk in stream_ssb_fact(sf, seed, chunk_rows=chunk_rows):
            eng.append_fact_rows(chunk)
        return eng

    # -- shard-local planning ------------------------------------------------
    def _plan_dim(self, dim: str) -> None:
        """Shard-local planning: no pull of the sharded FK column for
        hot-key ranking (``validate_sharded`` rejected the schedules that
        need one).  Every schedule gives the same answers, so this
        affects cost, not results."""
        force = None if self.schedule == "auto" else self.schedule
        self.plans[dim] = SchedulePlan(schedule=force or "gathered")

    def _maybe_replan_fact_skew(self, force: bool = False) -> list[str]:
        """Skew re-measurement reads a whole FK column as one stream; the
        shard-local plans are static."""
        return []

    # -- the sharded join primitive -----------------------------------------
    def _join(self, dim: str, dim_mask: torch.Tensor | None = None, *,
              eager: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """Always the sharded probe: with ``kernel="torch"`` the parent
        never folds ``dim_mask`` into a probe (the query tail applies it),
        and ``eager`` only drops a plan the sharded probe does not take."""
        return sharded_join(self, dim, self.mesh, self.axis)

    # -- sharded fact append -------------------------------------------------
    @_mutates
    def append_fact_rows(self, rows, *, extend_cache: bool = True) -> dict:
        """Append lineorder rows: every shard takes its own tail slice.

        The batch splits into ``ndev`` contiguous sub-batches (the last
        padded with dead rows so the windows stay uniform); the
        ``(ndev, bp)`` tail lands at ``[:, start:start + bp]`` of every
        region, in place when the engine owns the buffers and no live
        snapshot pins them, into a fresh generation otherwise.  Capacity
        grows per shard by the reserve rule, and each cached dimension
        probe extends per shard (``sharded_extend_program``).  Pins, the
        WAL record and the publish mirror the parent; the publish also
        stamps the new epoch on every shard.

        Live rows must not carry ``EMPTY_KEY`` in an FK column: the
        sentinel marks the dead filler rows.
        """
        fact = self.tables["lineorder"]
        new_cols, n_new = self._fact_batch(rows)
        if n_new == 0:  # strict no-op, like the parent
            return {"appended": 0, "epoch": self._fact_epoch, "dims": {},
                    "capacity_grew": False, "skew_replanned": []}
        for col in sorted(_FK_COLS):
            if (new_cols[col] == _ht.EMPTY_KEY).any():
                raise ValueError(
                    f"rows[{col!r}] contains EMPTY_KEY: reserved for dead "
                    "shard-filler rows; live fact rows cannot carry the "
                    "sentinel")
        self._wal_log("append_fact_rows", {}, new_cols)
        ndev = self._ndev
        per = -(-n_new // ndev)            # live + dead rows per shard
        bp = tail_bucket(per, self._min_bucket)
        tails: dict[str, torch.Tensor] = {}
        for k, v in new_cols.items():
            fill = self._fills[k]
            buf = np.full((ndev, bp), fill, np.int32)
            flat = np.full((ndev * per,), fill, np.int32)
            flat[:n_new] = v
            buf[:, :per] = flat.reshape(ndev, per)
            tails[k] = torch.from_numpy(buf).to(self.device)
        start = self._shard_valid
        grow = start + bp > self._shard_cap
        pinned = self._fact_pinned()
        if self._shard_owned and not grow and pinned:
            self._pin_copies += 1
        cols = dict(fact.columns)
        capacity_grew = False
        if grow:
            reserve = max(TAIL_GROWTH_BATCHES * bp,
                          int(self._shard_cap * TAIL_RESERVE_FRAC))
            new_cap = round_up(start + bp + reserve, bp)
            cols = {k: _grow_regions(v, ndev, self._shard_cap, new_cap,
                                     self._fills[k])
                    for k, v in cols.items()}
            self._shard_cap = new_cap
            capacity_grew = True
        if grow or not self._shard_owned or pinned:
            self._fact_gen += 1  # fresh buffers: no snapshot pins them
        if not (grow or (self._shard_owned and not pinned)):
            cols = {k: v.clone() for k, v in cols.items()}
        for k, v in cols.items():
            v.view(ndev, self._shard_cap)[:, start:start + bp].copy_(
                tails[k])
        self._shard_valid = start + per
        self._n_live += int(n_new)
        self._windows.append((start, per, int(n_new)))
        self.tables["lineorder"] = Table(cols, valid_rows=self._n_live)
        self._shard_owned = True
        self._epoch += 1
        self._fact_epoch += 1
        self._fact_appends += 1
        self._fact_rows_appended += int(n_new)
        report = {"appended": int(n_new), "epoch": self._fact_epoch,
                  "capacity_grew": capacity_grew, "dims": {}}
        for dim in sorted(self._probe_cache):
            ap = self._fact_append_plan(dim, bp, start)
            if not (extend_cache and ap.extend):
                self.invalidate_probe_cache(dim)
                self._tail_reprobes += 1
                report["dims"][dim] = ap.reason if extend_cache \
                    else "invalidated"
                continue
            found, row = self._probe_cache[dim]
            owned = dim in self._cache_owned
            pinned_copy = False
            if owned and self._cache_pinned(dim):
                owned = False
                pinned_copy = True
            fresh = not owned
            if found.shape[0] != ndev * self._shard_cap:  # capacity grew
                old = found.shape[0] // ndev
                found = _grow_regions(found, ndev, old, self._shard_cap,
                                      False)
                row = _grow_regions(row, ndev, old, self._shard_cap, -1)
                owned, fresh = True, True
                pinned_copy = False
            if pinned_copy:
                self._pin_copies += 1
            plan = self.plans.get(dim)
            key_plan = plan if plan is not None and \
                plan.schedule == "deduped" else None
            extend = sharded_extend_program(self.mesh, self.axis,
                                            self.probe_impl, key_plan,
                                            donate=owned)
            self._probe_cache[dim] = extend(
                effective_index(self.indexes[dim]), None, found, row,
                tails[FACT_FK[dim]].view(-1), start)
            self._probe_epoch[dim] = self._fact_epoch
            self._cache_owned.add(dim)
            if fresh:
                self._cache_gens[dim] = self._cache_gens.get(dim, 0) + 1
            self._tail_extensions += 1
            report["dims"][dim] = "extended"
        report["skew_replanned"] = self._maybe_replan_fact_skew()
        self._wal_publish()
        return report

    # -- epoch stamps --------------------------------------------------------
    def _stamp(self) -> None:
        """Publish the engine epoch on every shard: a fresh ``(ndev,)``
        tensor (never written in place, so a snapshot's stays)."""
        self._epoch_stamps = torch.full((self._ndev,), self._epoch,
                                        dtype=torch.int32,
                                        device=self.mesh.device)

    def _wal_publish(self) -> None:
        # stamp BEFORE the observers run: a hook (or a snapshot taken from
        # one) already sees every shard at the new epoch
        self._stamp()
        super()._wal_publish()

    def _replace_table(self, dim: str, table) -> None:
        # the §3.2.3 cell writes bypass _wal_publish: re-stamp here, so the
        # stamps never fall behind the engine epoch
        super()._replace_table(dim, table)
        self._stamp()

    def _make_snapshot(self) -> ShardedEpochSnapshot:
        stamps = self._epoch_stamps.cpu().numpy()
        if stamps.size and not (stamps == self._epoch).all():
            raise RuntimeError(
                f"mixed-epoch shard image: per-shard epoch stamps "
                f"{stamps.tolist()} != engine epoch {self._epoch}; a "
                "mutation path failed to publish on every shard")
        return ShardedEpochSnapshot(self)

    # -- the prefix readers --------------------------------------------------
    def persist(self, root: str, **kw):
        """``SSBEngine.persist`` at 1 shard, where the live rows are a
        prefix; at more shards it raises ``NotImplementedError`` (the
        checkpoint would capture the wrong rows)."""
        if self._ndev > 1:
            raise NotImplementedError(f"persist at {self._ndev} shards: "
                                      + _PREFIX_CAVEAT)
        return super().persist(root, **kw)

    def register_view_suite(self, suite) -> None:
        """``SSBEngine.register_view_suite`` (the IVM attach) at 1 shard;
        at more shards it raises ``NotImplementedError``."""
        if self._ndev > 1:
            raise NotImplementedError(
                f"maintained views at {self._ndev} shards: "
                + _PREFIX_CAVEAT)
        super().register_view_suite(suite)

    # -- logical view and re-sharding ----------------------------------------
    def logical_fact_columns(self) -> dict[str, np.ndarray]:
        """The live fact rows in append order, on the host.

        Reassembled from the regions through the append-window record,
        dead filler rows dropped: the mesh-agnostic image ``reshard`` (and
        any oracle) consumes, the sharded form of ``Table.trimmed()``."""
        fact = self.tables["lineorder"]
        out = {}
        for k, v in fact.columns.items():
            regions = v.view(self._ndev, self._shard_cap)
            parts = [regions[:, s:s + p].reshape(-1)[:n]
                     for s, p, n in self._windows]
            out[k] = (torch.cat(parts).cpu().numpy() if parts
                      else np.zeros((0,), np.int32))
        return out

    def shard_info(self) -> dict:
        """Mesh and per-shard layout counters."""
        return {"devices": self._ndev, "axis": self.axis,
                "shard_capacity": self._shard_cap,
                "shard_valid": self._shard_valid,
                "live_rows": self._n_live,
                "dead_rows": self._shard_valid * self._ndev - self._n_live,
                "windows": len(self._windows)}

    def reshard(self, new_mesh: ShardMesh, *,
                axis: str | None = None) -> "ShardedSSBEngine":
        """Re-open this engine's logical image on another mesh.

        The fact columns are reassembled on the host and re-laid out for
        the new shard count (``shard_fact_columns``: padded to the shard
        multiple, never axis-dropped); dimension tables, indexes and
        deltas carry over (the new engine copies the index planes); plans
        are made again.  The new engine is volatile and answers
        bit-identically to this one.
        """
        axis = axis or self.axis
        tables = dict(self.tables)
        tables["lineorder"] = Table.from_numpy(self.logical_fact_columns(),
                                               new_mesh.device)
        return type(self)(tables, mesh=new_mesh, axis=axis,
                          indexes=dict(self.indexes), policy=self.policy,
                          min_bucket=self._min_bucket)
