"""Build and load the port's CUDA kernels: ``nvcc`` -> shared library -> ctypes.

Each ``csrc/<name>.cu`` compiles on its own into ``_build/lib<name>-<hash>.so``
(``<hash>`` covers the source, the shared ``csrc/*.cuh`` headers and the
flags, so an edited source rebuilds and an unchanged one is reused).  The
libraries expose a plain ``extern "C"`` interface: every pointer and the
stream travel as ``c_void_p``, sizes as ``c_int64``/``c_int32``, and each
launcher returns ``cudaGetLastError()``.
Nothing here includes PyTorch's headers, which keeps a build to seconds.

Building happens at the first launch (or up front through ``build``), never
at import: the package must import where no ``nvcc`` exists.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
# library -> {C function: argtypes}
SIGNATURES = {
    "bucket_probe": {
        # tk, tv, keys, out, m, num_buckets, w, fib, stream
        "probe_rows_launch": (_P, _P, _P, _P, _I64, _I64, _I32, _I32, _P),
        # plane, num_buckets, w, positive, slot_bits, bucket_bits, stream
        "pack_bits_launch": (_P, _I64, _I32, _I32, _P, _P, _P),
        # tk, tv, slot_bits, bucket_bits, keys, out, m, num_buckets, w,
        # fib, stream
        "probe_filter_rows_launch": (_P, _P, _P, _P, _P, _P, _I64, _I64,
                                     _I32, _I32, _P),
        # tk, tv, slot_bits, bucket_bits, keys, dtk, dtw, delta_bits, raw,
        # out, m, num_buckets, w, fib, delta_buckets, dw, dfib, stream
        "probe_filter_rows_delta_launch": (_P, _P, _P, _P, _P, _P, _P, _P,
                                           _P, _P, _I64, _I64, _I32, _I32,
                                           _I64, _I32, _I32, _P),
        # tk, tv, keys, out, m, num_buckets, w, fib, stream
        "bucket_probe_stream_launch": (_P, _P, _P, _P, _I64, _I64, _I32,
                                       _I32, _P),
    },
    "fused_query": {
        # dim pointer table (host), dim integer table (host), n_dims,
        # stats, stream
        "fused_pack_launch": (_P, _P, _I32, _P, _P),
        # dim pointer table, dim integer table, n_dims, stats, fmeasure, m,
        # groups, num_segments, stream
        "fused_query_launch": (_P, _P, _I32, _P, _P, _I64, _P, _I32, _P),
    },
    "batched_tail": {
        # dim pointer table (host), dim row counts (host), n_dims, fword,
        # ma, mb, mop, n, nb, size, totals, groups, stream
        "batched_tail_launch": (_P, _P, _I32, _P, _P, _P, _I32, _I64, _I32,
                                _I32, _P, _P, _P),
    },
    "coalesce_window": {
        # keys, out, m, window, stream
        "coalesce_window_mask_launch": (_P, _P, _I64, _I32, _P),
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    # the shared headers are part of every source's digest
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=tuple(SIGNATURES)) -> dict[str, tuple[float, str]]:
    """Compile every named library that is not built yet, one ``nvcc`` per
    source, all started together.  Returns ``{name: (seconds, log)}`` for
    the ones it compiled (``log`` holds ``ptxas -v``'s register and
    shared-memory report).  Raises ``RuntimeError`` if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: library_path(n) for n in names if not library_path(n).exists()}
    if not todo:
        return {}
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    done, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n"
                          f"{log}")
            continue
        os.replace(tmp, out)  # atomic: a half-written library is never seen
        done[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def loaded() -> tuple[str, ...]:
    """Names of the libraries loaded into this process."""
    return tuple(sorted(_LIBS))


def check(status: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
