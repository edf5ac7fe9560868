"""Durability tier: WAL + epoch checkpoints + crash recovery (DESIGN.md §10).

PyTorch port of ``repro.durability.manager``; a root written by either
package recovers in the other.  The in-memory engine owns the hot path
(queries run against published epochs exactly as before) while this tier
makes every published epoch recoverable.  The engine's mutation methods
call in around each epoch publish:

* ``log_mutation``: append + fsync one WAL record stamped with the epoch
  the mutation is about to publish.  Only after it returns does the
  engine apply the mutation and bump its epoch, so the log never runs
  behind published state.
* ``on_publish``: after the bump, weigh the accumulated log suffix
  against a fresh checkpoint (``core.planner.plan_checkpoint``, priced on
  the engine's device type) and, when replay debt wins, write the
  engine's logical state through an ``EpochSnapshot`` into
  ``checkpoint/manager.py``'s atomic write-fsync-rename protocol.

Recovery (``open_engine``) is the state machine find-checkpoint -> verify
-> replay -> publish: newest checkpoint first, falling back to older ones
on :class:`~repro_torch.checkpoint.manager.CheckpointCorruptError`; then
the WAL records with epochs past the checkpoint replay **through the
normal mutation API** (the same delta, compaction and tail-append code
as live ingest, auto-compaction off so that logged ``compact`` records
replay the original fold points).  The recovered state equals some
prefix of published epochs: a durable but unpublished final record
replays too, which is legal because its epoch was never observable in
the dead process.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from repro_torch.checkpoint.manager import (CheckpointCorruptError,
                                            CheckpointManager, load_arrays,
                                            steps)
from repro_torch.core.planner import (CKPT_MIN_LOG_BYTES, CKPT_SAFETY,
                                      CheckpointPlan, plan_checkpoint)
from repro_torch.durability.fsio import OsFS
from repro_torch.durability.state import (build_engine_from_state,
                                          engine_state, state_nbytes)
from repro_torch.durability.wal import WALRecord, WriteAheadLog

WAL_NAME = "wal.log"
CKPT_SUBDIR = "ckpt"


class RecoveryError(RuntimeError):
    """No consistent state could be recovered from a durability root."""


def _sync(engine) -> None:
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)


class DurabilityManager:
    """Owns one durability root: ``<root>/wal.log`` + ``<root>/ckpt/``.

    Create with :meth:`create` (genesis: checkpoint the engine's current
    epoch, then start logging) and reopen with :func:`open_engine`; the
    engine calls the hook surface (``log_mutation`` / ``on_publish``)
    from its mutation methods.  ``replaying`` suppresses both hooks while
    recovery drives mutations through the engine API.

    Measurements: ``last_plan`` is the decision of the latest
    ``on_publish``; ``last_checkpoint`` the parts of the latest save
    (seconds of the device-to-host copies, CRC, writes with fsync, rename,
    the whole save under the engine lock, and its bytes); ``recovery``
    (on a recovered manager) the seconds of ``open_engine``'s load with
    verification, its device build and its replay, and the records
    replayed.
    """

    def __init__(self, root: str, fs=None, *, keep: int = 3,
                 min_log_bytes: int = CKPT_MIN_LOG_BYTES,
                 safety: float = CKPT_SAFETY,
                 auto_checkpoint: bool = True):
        self.root = root
        self.fs = fs or OsFS()
        self.wal_path = os.path.join(root, WAL_NAME)
        self.ckpt = CheckpointManager(os.path.join(root, CKPT_SUBDIR),
                                      keep=keep)
        self.min_log_bytes = min_log_bytes
        self.safety = safety
        self.auto_checkpoint = auto_checkpoint
        self.replaying = False
        self.wal: WriteAheadLog | None = None
        self.records_logged = 0
        self.bytes_logged = 0
        self.checkpoints_taken = 0
        self.last_ckpt_epoch: int | None = None
        self.bytes_since_ckpt = 0
        self.records_since_ckpt = 0
        self.last_plan: CheckpointPlan | None = None
        self.last_checkpoint: dict | None = None
        self.recovery: dict | None = None

    # -- lifecycle ---------------------------------------------------------
    @classmethod
    def create(cls, root: str, engine, fs=None, **kw) -> "DurabilityManager":
        """Start durability for ``engine`` at a fresh ``root``.

        The epoch's state checkpoint lands before the first WAL byte, so
        recovery always ends at a consistent state however early a crash
        hits: the corrupt-checkpoint fallback bottoms out at genesis,
        never at "nothing".
        """
        mgr = cls(root, fs, **kw)
        if engine.mode != "jspim":
            raise ValueError("durability requires jspim mode (the index "
                             "state is what checkpoints capture)")
        if mgr.fs.exists(mgr.wal_path) or steps(mgr.ckpt.dir):
            raise ValueError(f"durability root {root!r} already holds a "
                             "log or checkpoints; use open_engine to "
                             "recover it")
        os.makedirs(root, exist_ok=True)
        mgr.checkpoint(engine)
        mgr.wal, _ = WriteAheadLog.open(mgr.wal_path, mgr.fs)
        engine._durability = mgr
        return mgr

    def close(self) -> None:
        if self.wal is not None:
            self.wal.close()
            self.wal = None

    # -- engine hook surface ----------------------------------------------
    def log_mutation(self, engine, kind: str, meta: dict | None = None,
                     arrays=None) -> None:
        """Make one mutation batch durable before the engine applies it:
        stamped with ``engine.epoch + 1``, the epoch this mutation will
        publish; returns only after the record is fsynced."""
        if self.wal is None:
            raise RuntimeError(
                "durability manager is closed: the WAL handle is gone, so "
                "this mutation could not be made durable; reopen the "
                "root with SSBEngine.open before mutating")
        n = self.wal.append(kind, engine.epoch + 1, meta, arrays)
        self.records_logged += 1
        self.bytes_logged += n
        self.bytes_since_ckpt += n
        self.records_since_ckpt += 1

    def checkpoint_plan(self, engine) -> CheckpointPlan:
        """The cost model's checkpoint-or-defer decision right now, priced
        on the engine's device type."""
        return plan_checkpoint(
            log_bytes=self.bytes_since_ckpt,
            n_records=self.records_since_ckpt,
            state_bytes=state_nbytes(engine),
            backend=engine.device.type,
            safety=self.safety, min_log_bytes=self.min_log_bytes)

    def on_publish(self, engine) -> None:
        """Post-publish hook: checkpoint when replay debt says so."""
        if not self.auto_checkpoint:
            return
        self.last_plan = self.checkpoint_plan(engine)
        if self.last_plan.checkpoint:
            self.checkpoint(engine)

    def checkpoint(self, engine) -> str:
        """Write the engine's current epoch into the checkpoint store.

        Serializes from an ``EpochSnapshot`` under the engine lock (held
        already when called from a mutation's publish), so no mutation
        moves the epoch or the counters while the leaves stream out.
        """
        timings: dict = {}
        t = time.perf_counter()
        with engine._mu, engine.snapshot() as snap:
            tree, meta = engine_state(snap)
            path = self.ckpt.save(snap.epoch, tree, extra=meta,
                                  timings=timings)
            self.checkpoints_taken += 1
            self.last_ckpt_epoch = snap.epoch
            self.bytes_since_ckpt = 0
            self.records_since_ckpt = 0
            timings["lock_s"] = time.perf_counter() - t
        self.last_checkpoint = dict(timings, epoch=self.last_ckpt_epoch)
        return path

    def info(self) -> dict:
        return {"records_logged": self.records_logged,
                "bytes_logged": self.bytes_logged,
                "wal_bytes": 0 if self.wal is None else self.wal.size,
                "checkpoints_taken": self.checkpoints_taken,
                "last_ckpt_epoch": self.last_ckpt_epoch,
                "bytes_since_ckpt": self.bytes_since_ckpt,
                "records_since_ckpt": self.records_since_ckpt}


def apply_record(engine, rec: WALRecord) -> None:
    """Replay one WAL record through the normal mutation API."""
    # the decoded arrays are read-only views of the log's bytes, which
    # torch refuses to share: writable copies
    m, a = rec.meta, {k: np.array(v) for k, v in rec.arrays.items()}
    if rec.kind == "ingest":
        engine.ingest(m["dim"], a["keys"], a.get("payloads"),
                      op=m["op"], auto_compact=False)
    elif rec.kind == "append_rows":
        engine.append_rows(m["dim"], dict(a), auto_compact=False)
    elif rec.kind == "append_fact_rows":
        engine.append_fact_rows(dict(a))
    elif rec.kind == "compact":
        engine.compact(m["dim"])
    else:  # encode_record rejects unknown kinds; decode cannot mint one
        raise RecoveryError(f"unknown WAL record kind {rec.kind!r}")


def open_engine(root: str, *, fs=None, device=None, policy=None,
                probe_impl: str | None = None, schedule: str | None = None,
                keep: int = 3, min_log_bytes: int = CKPT_MIN_LOG_BYTES,
                safety: float = CKPT_SAFETY, auto_checkpoint: bool = True):
    """Recover an ``SSBEngine`` from a durability root, on ``device`` (the
    card unless the caller names another; no card and no ``device="cpu"``
    raises ``RuntimeError``).

    find-checkpoint -> verify -> replay -> publish: restores the newest
    checkpoint whose leaves verify (CRC32 per leaf; corruption falls back
    to the next older step), truncates the WAL's torn tail, replays every
    record with an epoch past the checkpoint through the normal mutation
    API, and returns the engine with durability attached again and the
    log open for new mutations.
    """
    fs = fs or OsFS()
    ckpt_dir = os.path.join(root, CKPT_SUBDIR)
    candidates = sorted(steps(ckpt_dir), reverse=True)
    if not candidates:
        raise RecoveryError(f"no checkpoint under {ckpt_dir!r}: not a "
                            "durability root (or genesis never completed)")
    last_err: Exception | None = None
    arrays = meta = ckpt_epoch = None
    t = time.perf_counter()
    for step in candidates:
        try:
            arrays, meta = load_arrays(ckpt_dir, step, verify=True)
            ckpt_epoch = step
            break
        except CheckpointCorruptError as e:
            last_err = e
    if arrays is None:
        raise RecoveryError(
            f"all {len(candidates)} checkpoints under {ckpt_dir!r} failed "
            f"verification; newest error: {last_err}") from last_err
    t1 = time.perf_counter()
    engine = build_engine_from_state(arrays, meta, device=device,
                                     policy=policy, probe_impl=probe_impl,
                                     schedule=schedule)
    del arrays
    _sync(engine)
    t2 = time.perf_counter()
    mgr = DurabilityManager(root, fs, keep=keep,
                            min_log_bytes=min_log_bytes, safety=safety,
                            auto_checkpoint=auto_checkpoint)
    mgr.wal, records = WriteAheadLog.open(mgr.wal_path, fs)
    mgr.last_ckpt_epoch = ckpt_epoch
    engine._durability = mgr
    mgr.replaying = True
    replayed = 0
    try:
        for rec in records:
            if rec.epoch <= engine.epoch:
                continue  # already reflected in the checkpoint
            apply_record(engine, rec)
            if engine.epoch != rec.epoch:
                raise RecoveryError(
                    f"replay epoch skew: record publishes {rec.epoch}, "
                    f"engine landed at {engine.epoch}: the log and the "
                    "mutation API disagree about epoch accounting")
            mgr.bytes_since_ckpt += rec.nbytes
            mgr.records_since_ckpt += 1
            replayed += 1
    finally:
        mgr.replaying = False
    _sync(engine)
    mgr.recovery = {"load_s": t1 - t, "build_s": t2 - t1,
                    "replay_s": time.perf_counter() - t2,
                    "records_replayed": replayed,
                    "checkpoint_epoch": ckpt_epoch}
    return engine
