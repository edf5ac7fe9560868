"""Epoch-keyed write-ahead mutation log (DESIGN.md §10).

PyTorch port's copy of ``repro.durability.wal``: the same framing and the
same ``json.dumps(sort_keys=True)`` header, so that both packages write
the same bytes for the same mutation and read each other's logs.

One record per engine mutation batch (``ingest`` / ``append_rows`` /
``append_fact_rows`` / ``compact``), framed so that the *durable prefix
at any crash instant* is parseable:

    file   := MAGIC(8) record*
    record := len(u32 LE) crc32(u32 LE) payload[len]
    payload:= meta_len(u32 LE) meta_json[meta_len] array_bytes...

``meta_json`` carries the record kind, the epoch the mutation publishes,
the free-form op metadata, and an ordered array directory (name / dtype /
shape); the raw array bytes follow in directory order.  The CRC covers
the whole payload, so a record either replays exactly or reads as the
crash frontier.

Durability contract (enforced by the engine hooks, not here): a record is
appended **and fsynced before** the engine applies the mutation and bumps
its epoch — so every epoch the engine ever published has its record on
disk, and the log may at most run *ahead* of published state (a durable
record whose epoch the dying process never published replays on recovery,
which is the correct outcome: the caller was never told the epoch
existed, and replaying it is indistinguishable from the op landing).

``scan``/``open`` implement torn-tail truncation: the first short or
checksum-failing record marks the end of the log — everything after it is
writeback debris from the crash, dropped (on ``open``, physically
truncated), never an error.
"""
from __future__ import annotations

import dataclasses
import json
import struct
import zlib

import numpy as np

from repro_torch.durability.fsio import OsFS

MAGIC = b"JWAL0001"
_HDR = struct.Struct("<II")       # record length + payload crc32
_MLEN = struct.Struct("<I")       # meta_json length

# mutation record kinds; everything except "compact" is *semantic* (it
# changes query-visible state) — compaction is replayed for fidelity of
# the delta/merge code path but is invisible to query results
KINDS = ("ingest", "append_rows", "append_fact_rows", "compact")
SEMANTIC_KINDS = ("ingest", "append_rows", "append_fact_rows")


class WALError(RuntimeError):
    """Structural log violation that is NOT a legal torn tail."""


@dataclasses.dataclass(frozen=True)
class WALRecord:
    kind: str
    epoch: int                     # the epoch this mutation publishes
    meta: dict
    arrays: dict[str, np.ndarray]
    nbytes: int                    # framed on-disk size of the record


def encode_record(kind: str, epoch: int, meta: dict | None = None,
                  arrays: dict[str, np.ndarray] | None = None) -> bytes:
    if kind not in KINDS:
        raise WALError(f"unknown WAL record kind {kind!r}")
    arrays = arrays or {}
    order = sorted(arrays)
    head = {"kind": kind, "epoch": int(epoch), "meta": meta or {},
            "arrays": [{"name": n, "dtype": str(arrays[n].dtype),
                        "shape": list(arrays[n].shape)} for n in order]}
    mb = json.dumps(head, sort_keys=True).encode()
    payload = b"".join([_MLEN.pack(len(mb)), mb,
                        *(np.ascontiguousarray(arrays[n]).tobytes()
                          for n in order)])
    return _HDR.pack(len(payload), zlib.crc32(payload)) + payload


def _decode_payload(payload: bytes, nbytes: int) -> WALRecord:
    (mlen,) = _MLEN.unpack_from(payload)
    head = json.loads(payload[_MLEN.size:_MLEN.size + mlen])
    off = _MLEN.size + mlen
    arrays: dict[str, np.ndarray] = {}
    for d in head["arrays"]:
        a = np.frombuffer(payload, dtype=np.dtype(d["dtype"]), offset=off,
                          count=int(np.prod(d["shape"], dtype=np.int64)))
        arrays[d["name"]] = a.reshape(d["shape"])
        off += a.nbytes
    return WALRecord(kind=head["kind"], epoch=head["epoch"],
                     meta=head["meta"], arrays=arrays, nbytes=nbytes)


def scan(data: bytes) -> tuple[list[WALRecord], int]:
    """Parse a durable log image; returns (records, clean_length).

    ``clean_length`` is the byte offset of the first torn/corrupt record
    (== ``len(data)`` for a clean log): a crashed writer's file is valid
    up to it and writeback debris after it.  A file too short to hold the
    magic — including empty — parses as a zero-record log to rewrite.
    """
    if len(data) < len(MAGIC) or data[:len(MAGIC)] != MAGIC:
        return [], 0
    records: list[WALRecord] = []
    off = len(MAGIC)
    while off + _HDR.size <= len(data):
        n, crc = _HDR.unpack_from(data, off)
        end = off + _HDR.size + n
        if n < _MLEN.size or end > len(data):
            break                          # torn length/payload
        payload = data[off + _HDR.size:end]
        if zlib.crc32(payload) != crc:
            break                          # torn or corrupt payload
        try:
            records.append(_decode_payload(payload, end - off))
        except Exception as e:  # crc-valid but unparseable: writer bug
            raise WALError(f"undecodable WAL record at offset {off}") from e
        off = end
    return records, off


class WriteAheadLog:
    """Single-writer append handle with fsync-per-record durability."""

    def __init__(self, path: str, fs=None):
        self.path = path
        self.fs = fs or OsFS()
        self._file = None
        self.size = 0            # bytes through the last appended record
        self.records_written = 0

    @classmethod
    def open(cls, path: str, fs=None) -> tuple["WriteAheadLog",
                                               list[WALRecord]]:
        """Open for append; returns the log plus the surviving records.

        A torn tail (partial final record) is physically truncated away;
        a missing file is created.  Either way the returned handle is
        positioned at a clean record boundary.
        """
        wal = cls(path, fs)
        records: list[WALRecord] = []
        fresh = True
        if wal.fs.exists(path):
            data = wal.fs.read_bytes(path)
            records, clean = scan(data)
            if clean > 0:
                if clean < len(data):
                    wal.fs.truncate(path, clean)
                wal.size = clean
                fresh = False
        wal._file = wal.fs.open_append(path)
        if fresh:
            if wal.fs.exists(path) and wal.fs.file_size(path) > 0:
                wal.fs.truncate(path, 0)  # pre-magic debris: rewrite
            wal._file.write(MAGIC)
            wal._file.fsync()
            wal.size = len(MAGIC)
        return wal, records

    def append(self, kind: str, epoch: int, meta: dict | None = None,
               arrays: dict[str, np.ndarray] | None = None) -> int:
        """Append one record and make it durable; returns its byte size."""
        if self._file is None:
            raise WALError("WAL is closed")
        rec = encode_record(kind, epoch, meta, arrays)
        self._file.write(rec)
        self._file.fsync()
        self.size += len(rec)
        self.records_written += 1
        return len(rec)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


def read_records(path: str, fs=None) -> list[WALRecord]:
    """Read-only scan of a log file's durable image (recovery / tests)."""
    fs = fs or OsFS()
    if not fs.exists(path):
        return []
    return scan(fs.read_bytes(path))[0]
