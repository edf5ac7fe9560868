"""Filesystem seam for the durability tier (DESIGN.md §10).

PyTorch port's copy of ``repro.durability.fsio`` (host-only Python).

The WAL writes through a tiny FS interface instead of ``os`` directly so
the crash-injection harness can substitute a page-cache-faithful fake:

* :class:`OsFS` — the real thing.  ``fsync`` uses ``fdatasync`` where the
  platform has it (the WAL appends to one preallocated-name file, so the
  data sync is the durability point; metadata timestamps are not).
* :class:`FailpointFS` — an in-memory filesystem that models exactly the
  crash semantics a real kernel gives a single-writer logger: ``write``
  lands in a volatile buffer (the page cache), ``fsync`` moves the buffer
  to the durable image, and a simulated kill (:class:`CrashPoint`) leaves
  the durable image plus **any prefix** of the unsynced buffer — the
  kernel may have written back part of the cache, so a torn tail is the
  legal outcome the WAL's record framing must absorb.

Every I/O call is one numbered *op*; ``arm(crash_at, mode)`` schedules a
kill at a chosen op with a chosen overlap ("before" the op's bytes enter
the cache, a "partial" prefix, or "after" — durable record, process dead
before the in-memory epoch publish).  Non-WAL crash sites (the checkpoint
writer's leaf writes / fsyncs / renames) participate through ``hit``:
they run on the real filesystem but consume ops from the same schedule,
so one randomized schedule sweeps kill points across both durability
paths.
"""
from __future__ import annotations

import os

from repro_torch.durability.faults import CrashPoint, OpSchedule

__all__ = ["CrashPoint", "OsFS", "FailpointFS"]


class _OsAppendFile:
    """Append handle over a real file: buffered write + explicit sync."""

    def __init__(self, path: str):
        self._f = open(path, "ab")

    def write(self, data: bytes) -> None:
        self._f.write(data)

    def fsync(self) -> None:
        self._f.flush()
        fd = self._f.fileno()
        if hasattr(os, "fdatasync"):
            os.fdatasync(fd)
        else:  # pragma: no cover - non-POSIX hosts
            os.fsync(fd)

    def close(self) -> None:
        self._f.close()


class OsFS:
    """The real filesystem, behind the WAL's I/O seam."""

    def makedirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def file_size(self, path: str) -> int:
        return os.path.getsize(path)

    def read_bytes(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def truncate(self, path: str, size: int) -> None:
        with open(path, "rb+") as f:
            f.truncate(size)

    def open_append(self, path: str) -> _OsAppendFile:
        return _OsAppendFile(path)

    def hit(self, site: str) -> None:
        """Crash-site marker: a no-op on the real filesystem."""


class _FailpointFile:
    """Append handle over a :class:`FailpointFS` path."""

    def __init__(self, fs: "FailpointFS", path: str):
        self.fs = fs
        self.path = path
        self.closed = False

    def write(self, data: bytes) -> None:
        self.fs._write(self.path, data)

    def fsync(self) -> None:
        self.fs._fsync(self.path)

    def close(self) -> None:
        # a clean close eventually reaches the disk even without fsync
        # (the kernel writes the cache back); crashes bypass close().
        if not self.closed:
            self.closed = True
            self.fs._flush(self.path)


class FailpointFS:
    """In-memory FS with page-cache crash semantics and a kill schedule.

    ``durable`` holds the bytes that survive a crash; ``unsynced`` the
    per-path page-cache tail written but not yet fsynced.  ``arm`` a kill
    at op ``crash_at`` (every ``write``/``fsync``/``hit`` consumes one op
    number) with a ``mode``:

    * ``"before"``  — the op's payload never reaches the cache,
    * ``"partial"`` — a random strict prefix of it does (torn write),
    * ``"after"``   — the op completes, the process dies right after
      (for an fsync: durable record, unpublished epoch).

    At the kill, each path's durable image additionally absorbs a random
    prefix of its unsynced tail — the kernel's concurrent writeback —
    then :class:`CrashPoint` is raised.  ``disarm`` before recovery.
    """

    def __init__(self, rng):
        self.rng = rng
        self.durable: dict[str, bytes] = {}
        self.unsynced: dict[str, bytearray] = {}
        self.sched = OpSchedule()

    # -- kill schedule (delegated to the shared OpSchedule) ----------------
    @property
    def op(self) -> int:
        return self.sched.op

    @property
    def mode(self) -> str:
        return self.sched.mode

    @property
    def crashed_at(self) -> tuple[int, str, str] | None:
        return self.sched.crashed_at

    def arm(self, crash_at: int, mode: str = "after",
            site: str | None = None) -> None:
        """Kill at op ``crash_at``; with ``site`` the count is over ops
        whose site name starts with it (e.g. ``"ckpt_"`` aims the kill at
        the checkpoint writer's syscalls regardless of how many WAL ops
        precede them)."""
        self.sched.arm(crash_at, mode, site)

    def disarm(self) -> None:
        self.sched.disarm()

    def _tick(self, site: str) -> bool:
        return self.sched.tick(site)

    def _crash(self, site: str):
        # kernel writeback: any prefix of each unsynced tail may be on
        # disk by the time the process is gone
        for path, buf in self.unsynced.items():
            keep = int(self.rng.integers(0, len(buf) + 1))
            self.durable[path] = self.durable.get(path, b"") + bytes(buf[:keep])
        self.unsynced.clear()
        self.disarm()
        raise CrashPoint(f"simulated kill at op {self.crashed_at[0]} "
                         f"({site}, mode={self.mode})")

    # -- fs surface --------------------------------------------------------
    def makedirs(self, path: str) -> None:
        pass

    def exists(self, path: str) -> bool:
        return path in self.durable or path in self.unsynced

    def file_size(self, path: str) -> int:
        return len(self.durable.get(path, b""))

    def read_bytes(self, path: str) -> bytes:
        if path not in self.durable and path not in self.unsynced:
            raise FileNotFoundError(path)
        # reads see the cache too (only a crash loses it)
        return self.durable.get(path, b"") + bytes(self.unsynced.get(path, b""))

    def truncate(self, path: str, size: int) -> None:
        data = self.read_bytes(path)
        self.durable[path] = data[:size]
        self.unsynced.pop(path, None)

    def open_append(self, path: str) -> _FailpointFile:
        self.durable.setdefault(path, b"")
        return _FailpointFile(self, path)

    def hit(self, site: str) -> None:
        """External crash site (checkpoint writer): consumes one op."""
        if self._tick(site):
            self._crash(site)

    # -- write/sync semantics ---------------------------------------------
    def _write(self, path: str, data: bytes) -> None:
        buf = self.unsynced.setdefault(path, bytearray())
        if self._tick("write"):
            if self.mode == "partial":
                keep = int(self.rng.integers(0, max(1, len(data))))
                buf.extend(data[:keep])
            elif self.mode == "after":
                buf.extend(data)
            self._crash("write")
        buf.extend(data)

    def _fsync(self, path: str) -> None:
        if self._tick("fsync"):
            if self.mode == "after":
                self._flush(path)
            self._crash("fsync")
        self._flush(path)

    def _flush(self, path: str) -> None:
        buf = self.unsynced.pop(path, None)
        if buf:
            self.durable[path] = self.durable.get(path, b"") + bytes(buf)
