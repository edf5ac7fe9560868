"""Epoch snapshots: queries at a frozen epoch while the engine advances.

PyTorch port of ``repro.engine.snapshot`` without the sharded snapshot.
``SSBEngine.snapshot()`` freezes one consistent image (dimension tables,
dictionaries, hash tables, delta buffers, the fact table, the probe cache
and the plans, all at the engine's current epoch) as an
:class:`EpochSnapshot`.  The engine keeps advancing its own image
(``append_fact_rows`` / ``ingest`` / ``compact``), each step one epoch,
while the snapshot keeps answering at its epoch:

* **No copy at the freeze.**  The snapshot holds the engine's tensors.
  Tensors are mutable, so the engine's three in-place writes (the fact
  tail, the probe-cache splice, the in-place compaction merge) check the
  buffer generation they would write against the generations the live
  snapshots pin (``_pin_*``), and write a fresh generation instead when
  one is pinned.  The first such mutation after a snapshot copies; the
  in-place writes then re-arm on the copy, and on the old generation too
  once every snapshot pinning it is released or collected.
* **No invalidation.**  A snapshot's probe cache only grows (lazy probes
  of dimensions the engine had not cached at the freeze, against the
  snapshot's own image); its plans never change.
* **The same code path.**  A snapshot runs queries through the engine's
  ``_QueryRunner`` methods, so an old epoch is answered exactly as the
  head would have answered it.
"""
from __future__ import annotations

import torch

from repro_torch.engine.queries import DIM_PK, SSBEngine, _QueryRunner


class EpochSnapshot(_QueryRunner):
    """One consistent, frozen image of an :class:`SSBEngine` at one epoch.

    Obtained from ``SSBEngine.snapshot()``.  Offers the engine's read
    surface (``probe_dim``, ``warm_cache``, ``run``, ``run_all`` on every
    path) and answers bit-identically to the freeze instant however far
    the engine advances.  Release it when done (``release()``, or a
    ``with`` block) so the engine's in-place writes re-arm; a released
    snapshot refuses queries with ``RuntimeError``.
    """

    def __init__(self, engine: SSBEngine):
        self.engine: SSBEngine | None = engine
        self.epoch = engine.epoch
        self.fact_epoch = engine.fact_epoch
        self.policy = engine.policy  # frozen dataclass: sharing it freezes it
        # the image: shallow copies of the engine's dicts.  Their values
        # (Tables, DimIndexes, plans, probe tuples) are never written once
        # published, except where a pin below forbids it.  The fact table
        # is an unowned view, so not even an append on the snapshot's own
        # table object could write the shared capacity buffers
        tables = dict(engine.tables)
        tables["lineorder"] = tables["lineorder"].pinned_view()
        self.tables = tables
        self.indexes = dict(engine.indexes)
        self.plans = dict(engine.plans)
        self._hot_codes = dict(engine._hot_codes)
        # only the probe entries consistent with the fact epoch
        self._probe_cache = {
            d: e for d, e in engine._probe_cache.items()
            if engine._probe_epoch.get(d) == engine._fact_epoch}
        # the buffer generations this image reads: the engine's in-place
        # writes compare them with their current generations
        self._pin_fact_gen = engine._fact_gen
        self._pin_cache_gens = {d: engine._cache_gens.get(d, 0)
                                for d in self._probe_cache}
        self._pin_index_gens = {d: engine._index_gens.get(d, 0)
                                for d in self.indexes}
        self._released = False

    # -- lifecycle ---------------------------------------------------------
    @property
    def released(self) -> bool:
        return self._released

    def release(self) -> None:
        """Retire this snapshot's pins (idempotent).  Drops every tensor
        reference and leaves the engine's snapshot set, so the engine's
        next mutation may write in place again unless another live
        snapshot pins the same generation."""
        if self._released:
            return
        self._released = True
        if self.engine is not None:
            # under the engine lock: a mutation on another thread may be
            # iterating the snapshot set
            with self.engine._mu:
                self.engine._snapshots.discard(self)
        self.engine = None
        self.tables = {}
        self.indexes = {}
        self.plans = {}
        self._hot_codes = {}
        self._probe_cache = {}

    def epoch_lag(self) -> int:
        """How many epochs the engine has advanced past this image (0: the
        snapshot is fresh).  The serving tier reports it with every
        response."""
        self._check_live()
        return max(0, self.engine.epoch - self.epoch)

    def __enter__(self) -> "EpochSnapshot":
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def _check_live(self) -> None:
        if self._released:
            raise RuntimeError(
                "EpochSnapshot was released: its pins are retired and the "
                "engine may have written the tensors it read")

    # -- read surface ------------------------------------------------------
    def probe_dim(self, dim: str) -> tuple[torch.Tensor, torch.Tensor]:
        """``(found, dim_row)`` for one dimension at this epoch.  Entries
        frozen from the engine are served as they are; a dimension the
        engine had not cached is probed against the snapshot's own image
        and kept here (the engine's cache is never touched)."""
        self._check_live()
        hit = self._probe_cache.get(dim)
        if hit is not None:
            return hit
        out = self._probe_cache[dim] = self._join(dim)
        return out

    def warm_cache(self, dims=None) -> None:
        """Probe every (or the given) dimension into the snapshot cache."""
        for dim in (dims if dims is not None else DIM_PK):
            self.probe_dim(dim)

    def run(self, name: str, *, use_cache: bool | None = None,
            fusion: str | None = None):
        self._check_live()
        return super().run(name, use_cache=use_cache, fusion=fusion)

    def run_all(self, names=None, *, use_cache: bool | None = None,
                fusion: str | None = None):
        self._check_live()
        return super().run_all(names, use_cache=use_cache, fusion=fusion)

    def cache_info(self) -> dict:
        return {"epoch": self.epoch, "fact_epoch": self.fact_epoch,
                "cached_dims": sorted(self._probe_cache),
                "released": self._released}
