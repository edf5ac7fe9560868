"""Checkpointing: atomic, resumable, integrity-checked.

PyTorch port of ``repro.checkpoint.manager``, writing the same files:

Layout:  <dir>/step_<N>/  -- one ``.npy`` per leaf + ``manifest.json`` with
the flattened tree paths.  Writes go to ``step_<N>.tmp`` and are renamed
only after every leaf file and the manifest are fsynced: a crash mid-save
never corrupts the latest checkpoint, ``latest_step`` ignores ``.tmp``
dirs (restart-safe), and the stale ``.tmp`` a crashed save leaves behind
is garbage-collected on the next ``save``/``latest_step``.

Integrity: the manifest stores a CRC32 of every leaf's raw bytes,
verified on restore; a corrupt leaf raises :class:`CheckpointCorruptError`
naming the leaf, so callers with older checkpoints (the durability tier's
recovery path) can fall back instead of loading garbage.

A tree is nested dicts (and lists or tuples) of tensors or numpy arrays.
It flattens in the reference's order: dict keys sorted at every level,
a leaf named by its dotted path (``tables.lineorder.lo_revenue``), so
``leaf_00007.npy`` is the same leaf in both packages and either package
reads the other's checkpoints.  Leaves are written with ``np.save`` from
``tensor.cpu().numpy()`` (one blocking copy a leaf on the current
stream); a ``bfloat16`` leaf is stored as its ``uint16`` view and
restored as a ``torch.bfloat16`` tensor.  ``np.save``, ``os.fsync`` and
``os.replace`` are reached through the module names ``np`` and ``os``, so
``durability.faults.checkpoint_crash_sites`` can report them as crash
sites.  ``restore(..., shardings=)`` places leaves on a shard mesh
(``launch/mesh.py:Placement``), the reference's elastic re-placement.
"""
from __future__ import annotations

import json
import os
import shutil
import time
import zlib

import numpy as np
import torch


class CheckpointCorruptError(ValueError):
    """A checkpoint failed integrity verification (names the bad piece)."""


def _flatten(tree, path: tuple = ()) -> list[tuple[str, object]]:
    """``[(dotted path, leaf)]`` in the reference's leaf order: dict keys
    sorted at every level, sequences by index, ``None`` holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in _flatten(v, path + (str(i),))]
    return [(".".join(path), tree)]


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def _placements(template, shardings) -> list:
    """One placement (or ``None``) per leaf of ``template``, in leaf
    order: ``shardings`` follows ``template``'s structure down to its
    leaves, and a ``None`` node leaves every leaf below it unplaced."""
    if template is None:
        return []
    if isinstance(template, dict):
        return [p for k in sorted(template)
                for p in _placements(template[k], None if shardings is None
                                     else shardings[k])]
    if isinstance(template, (list, tuple)):
        return [p for i, v in enumerate(template)
                for p in _placements(v, None if shardings is None
                                     else shardings[i])]
    return [shardings]


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(host array as stored, logical dtype name) of one leaf."""
    if torch.is_tensor(leaf):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:  # npy has no bf16: the uint16 view
            return t.view(torch.int16).cpu().numpy().view(np.uint16), \
                "bfloat16"
        arr = t.cpu().numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _fsync_dir(path: str) -> None:
    """Best-effort directory fsync (makes the rename itself durable)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - platforms without dir fds
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover
        pass
    finally:
        os.close(fd)


def _gc_tmp(ckpt_dir: str) -> None:
    """Remove stale ``step_*.tmp`` dirs left behind by a crashed save."""
    if not os.path.isdir(ckpt_dir):
        return
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and d.endswith(".tmp"):
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None, *,
         timings: dict | None = None) -> str:
    """Atomic write of a tree checkpoint; returns the final directory.

    ``extra`` (JSON-serializable) rides along in the manifest: the
    durability tier stores the engine's static metadata (epochs, hash
    modes, build geometry) next to the array leaves this way.
    ``timings``, when given, receives the seconds of each part of the
    save (``d2h_s``: device-to-host copies, ``crc_s``, ``write_s``: leaf
    and manifest writes with their fsyncs, ``rename_s``: the commit
    rename with the directory fsyncs) and the leaf ``bytes``.
    """
    clock = {"d2h_s": 0.0, "crc_s": 0.0, "write_s": 0.0, "rename_s": 0.0,
             "bytes": 0}
    _gc_tmp(ckpt_dir)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    if extra is not None:
        manifest["extra"] = extra
    for i, (path, leaf) in enumerate(_flatten(tree)):
        t = time.perf_counter()
        arr, dtype = _to_host(leaf)
        if not arr.flags.c_contiguous:  # (ascontiguousarray makes 0-d 1-d)
            arr = np.array(arr, order="C")
        t1 = time.perf_counter()
        fn = f"leaf_{i:05d}.npy"
        with open(os.path.join(tmp, fn), "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        t2 = time.perf_counter()
        crc = zlib.crc32(arr)
        clock["d2h_s"] += t1 - t
        clock["write_s"] += t2 - t1
        clock["crc_s"] += time.perf_counter() - t2
        clock["bytes"] += arr.nbytes
        manifest["leaves"].append(
            {"path": path, "file": fn, "dtype": dtype,
             "shape": list(arr.shape), "crc32": crc})
    t = time.perf_counter()
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    t1 = time.perf_counter()
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _fsync_dir(ckpt_dir)
    clock["write_s"] += t1 - t
    clock["rename_s"] += time.perf_counter() - t1
    if timings is not None:
        timings.update(clock)
    return final


def steps(ckpt_dir: str) -> list[int]:
    """All complete checkpoint steps, ascending (``.tmp`` dirs ignored)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(ckpt_dir: str) -> int | None:
    _gc_tmp(ckpt_dir)
    all_steps = steps(ckpt_dir)
    return all_steps[-1] if all_steps else None


def _load_leaf(step_dir: str, entry: dict, verify: bool) -> np.ndarray:
    """One leaf as stored (a ``bfloat16`` leaf as its ``uint16`` view)."""
    fp = os.path.join(step_dir, entry["file"])
    try:
        arr = np.load(fp)
    except Exception as e:
        raise CheckpointCorruptError(
            f"checkpoint leaf {entry['path']!r} ({fp}) is unreadable: "
            f"{e}") from e
    if verify and "crc32" in entry:
        crc = zlib.crc32(np.ascontiguousarray(arr))
        if crc != entry["crc32"]:
            raise CheckpointCorruptError(
                f"checkpoint leaf {entry['path']!r} ({fp}) failed CRC32 "
                f"verification: stored {entry['crc32']:#010x}, "
                f"computed {crc:#010x}")
    return arr


def _read_manifest(d: str, step: int) -> dict:
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"checkpoint step {step} at {d} has no readable manifest: "
            f"{e}") from e


def restore(ckpt_dir: str, step: int, template, device=None,
            shardings=None, verify: bool = True):
    """Restore into the structure of ``template`` (a tree of tensors).

    Each leaf lands on ``device``, or where its template leaf lives when
    ``device`` is None.  ``shardings`` (elastic placement) is a tree
    matching ``template`` whose leaves are ``None`` or a
    ``launch.mesh.Placement(mesh, spec)``: a placed leaf lands on
    ``mesh.device`` with its logical shape (on the one-device region mesh
    a sharded and a replicated leaf hold the same tensor, so a dimension
    its axis does not divide needs no clamp); a spec naming an axis the
    mesh lacks raises ``KeyError``.  Leaf CRCs are
    verified when the manifest carries them (``verify=True``); a mismatch
    raises :class:`CheckpointCorruptError` naming the corrupt leaf.
    """
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    manifest = _read_manifest(d, step)
    leaves = _flatten(template)
    assert len(leaves) == len(manifest["leaves"]), (
        f"checkpoint has {len(manifest['leaves'])} leaves, template "
        f"{len(leaves)}: structure mismatch")
    places = _placements(template, shardings)
    out = []
    for entry, (_, tmpl), place in zip(manifest["leaves"], leaves, places):
        arr = _load_leaf(d, entry, verify)
        assert list(arr.shape) == list(tmpl.shape), (
            entry["path"], arr.shape, tmpl.shape)
        if entry["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if place is not None:
            unknown = [a for e in place.spec if e is not None
                       for a in (e if isinstance(e, tuple) else (e,))
                       if a not in place.mesh.axis_names]
            if unknown:
                raise KeyError(f"{entry['path']}: spec {place.spec} names "
                               f"axes {unknown} not in the mesh's "
                               f"{place.mesh.axis_names}")
            dev = place.mesh.device
        else:
            dev = device if device is not None else getattr(tmpl, "device",
                                                            "cpu")
        out.append(t.to(dev))
    return _unflatten(template, iter(out))


def load_arrays(ckpt_dir: str, step: int, verify: bool = True
                ) -> tuple[dict[str, np.ndarray], dict | None]:
    """Template-free restore: ``{dotted-tree-path: host array}`` + extra.

    The durability tier's recovery path: it has no template (the engine
    is *built from* the checkpoint), so leaves come back keyed by the
    manifest's flattened tree paths, with CRC verification on by default
    (a ``bfloat16`` leaf comes back as its stored ``uint16`` view).
    Raises :class:`CheckpointCorruptError` on a missing manifest, an
    unreadable leaf, or a CRC mismatch: never returns partial state.
    """
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    manifest = _read_manifest(d, step)
    out = {e["path"]: _load_leaf(d, e, verify) for e in manifest["leaves"]}
    return out, manifest.get("extra")


class CheckpointManager:
    """keep-last-k rotation + auto-resume."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        os.makedirs(ckpt_dir, exist_ok=True)

    def save(self, step: int, tree, extra: dict | None = None, *,
             timings: dict | None = None) -> str:
        path = save(self.dir, step, tree, extra=extra, timings=timings)
        for s in steps(self.dir)[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)
        return path

    def latest(self) -> int | None:
        return latest_step(self.dir)

    def steps(self) -> list[int]:
        return steps(self.dir)

    def restore_latest(self, template, device=None):
        s = self.latest()
        if s is None:
            return None, None
        return s, restore(self.dir, s, template, device)
