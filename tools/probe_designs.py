#!/usr/bin/env python3
"""Time the designs of the filter probe side by side on one CUDA card.

    python3 tools/probe_designs.py [--probes 60000000] [--reps 10]
                                   [--out summary.json]

Builds ``tools/probe_designs.cu`` (the designs the port did not ship) and
the port's ``csrc/bucket_probe.cu`` with ``nvcc``, then, for dimensions of
SSB SF10's sizes (date 2,556 keys, supplier 20,000, customer 300,000, part
2,000,000) and two more (1,000,000 and 4,000,000 keys, the planes' sizes
between and past part's), builds the port's index over keys ``0..n-1``
(bucket width 8, load 0.5), draws ``--probes`` uniform probe codes and a
per-row predicate of the dimension's SSB selectivity (date 1/7, supplier
and customer 1/5, part and the other two 1/25; seed 0), and times with CUDA
events, in two passes (forward, then reverse order):

- ``probe_rows`` (the port's kernel; it hashes the keys itself);
- ``pr13``, ``mask``, ``screen``, ``screen_hints``, ``pair``, ``multi2``,
  ``multi4``, ``multi8``, ``summary``, ``smem`` (``probe_designs.cu``; the
  bit sets made beforehand, the bucket ids for ``pr13`` too);
- ``probe_filter_rows`` (the port's wrapper: predicate packing included).

On part's table it also times the delta variants with a 65536x8 delta
holding 10,000 upserts, 10,000 deletes and 10,000 new keys (seed 1).
Last, it holds the port's two kernels against their plain versions at
bucket widths 4 to 128 and both hash modes (1M probes, seed 2).
Every design's words must equal the port's kernel's, and those its plain
version's.  Prints one line per table and a JSON summary as the last
line, and writes the summary to ``--out`` when given.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

SIZES = (("date", 2_556, 7), ("supplier", 20_000, 5),
         ("customer", 300_000, 5), ("1M", 1_000_000, 25),
         ("part", 2_000_000, 25), ("4M", 4_000_000, 25))
# design_launch's codes, in order
DESIGNS = ("mask", "screen", "screen_hints", "pair", "multi2", "multi4",
           "multi8", "summary", "smem")
CHUNK = 4 << 20
_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32


def build_designs(nvcc_flags) -> ctypes.CDLL:
    out_dir = ROOT / "tools" / "_build"
    out_dir.mkdir(exist_ok=True)
    lib = out_dir / "libprobe_designs.so"
    src = ROOT / "tools" / "probe_designs.cu"
    nvcc = "/usr/local/cuda/bin/nvcc"
    log = subprocess.run([nvcc, *nvcc_flags, "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    if log.returncode:
        raise RuntimeError(f"nvcc probe_designs.cu:\n{log.stdout}{log.stderr}")
    for line in (log.stdout + log.stderr).splitlines():
        if "Used" in line or "Compiling entry" in line:
            print(f"[ptxas] {line.strip()}")
    so = ctypes.CDLL(str(lib))
    so.pr13_launch.argtypes = (_P,) * 10 + (_I64, _P)
    so.design_launch.argtypes = (_I32,) + (_P,) * 10 + (_I64, _I64, _I32,
                                                        _I64, _I32, _P)
    so.pr13_launch.restype = so.design_launch.restype = ctypes.c_int
    return so


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--probes", type=int, default=60_000_000)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("probe_designs: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.core.delta import delete_batch, empty_delta, upsert_batch
    from repro_torch.core.hash_table import (EMPTY_KEY, HASH_FIBONACCI,
                                             build_table, hash_bucket,
                                             suggest_num_buckets)
    from repro_torch.engine.join import build_dim_index
    from repro_torch.kernels import _build
    from repro_torch.kernels.bucket_probe import (
        pack_bits, probe_filter_rows,
        probe_filter_rows_delta, probe_filter_rows_delta_plain,
        probe_filter_rows_plain, probe_rows)
    from repro_torch.kernels.ops import delta_slot_words, slot_predicate

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    for _, (_, text) in _build.build(("bucket_probe",)).items():
        for line in text.splitlines():
            if "Used" in line or "Compiling entry" in line:
                print(f"[ptxas] {line.strip()}")
    so = build_designs(_build.NVCC_FLAGS)
    print(f"[build] {time.perf_counter() - t0:.2f} s")
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    m = args.probes

    def event_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(args.reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / args.reps

    def check(status, what):
        if status:
            raise RuntimeError(f"{what}: CUDA error {status}")

    def plain_chunked(fn, ops, vector_idx):
        return torch.cat([fn(*(t[s:s + CHUNK] if i in vector_idx else t
                               for i, t in enumerate(ops)))
                          for s in range(0, m, CHUNK)])

    gen = torch.Generator(device=dev)
    summary = {"device": smi, "probes": m, "reps": args.reps, "tables": {}}
    for name, n, sel in SIZES:
        gen.manual_seed(0)
        idx = build_dim_index(torch.arange(n, dtype=torch.int32, device=dev))
        tbl = idx.table
        codes = torch.randint(0, n, (m,), generator=gen, device=dev,
                              dtype=torch.int32)
        dim_mask = torch.rand(n, generator=gen, device=dev) < 1.0 / sel
        pred = slot_predicate(tbl, dim_mask)
        bids = hash_bucket(codes, tbl.num_buckets, tbl.hash_mode)
        bits, bucket_bits = pack_bits(pred, "positive")
        nb = tbl.num_buckets
        fib = int(tbl.hash_mode == HASH_FIBONACCI)
        outs = {}

        def run(design, delta=None, out=None):
            o = out if out is not None else torch.empty_like(codes)
            dk, dw, raw, dbids, docc = ((None,) * 5 if delta is None
                                        else delta)
            dbk = 0 if dk is None else dk.shape[0]
            dp = [None if t is None else t.data_ptr()
                  for t in (dk, dw, raw, dbids, docc)]
            if design == "pr13":
                check(so.pr13_launch(
                    tbl.keys.data_ptr(), tbl.values.data_ptr(),
                    pred.data_ptr(), codes.data_ptr(), bids.data_ptr(),
                    *dp[:4], o.data_ptr(), m, stream), design)
            else:
                check(so.design_launch(
                    DESIGNS.index(design), tbl.keys.data_ptr(),
                    tbl.values.data_ptr(), bits.data_ptr(),
                    bucket_bits.data_ptr(), codes.data_ptr(),
                    *dp[:3], dp[4], o.data_ptr(), m, nb, fib, dbk, 1,
                    stream),
                    design)
            return o

        want = probe_filter_rows(tbl.keys, tbl.values, pred, codes,
                                 tbl.hash_mode)
        plain = plain_chunked(probe_filter_rows_plain,
                              (tbl.keys, tbl.values, pred, codes,
                               tbl.hash_mode), (3,))
        if not torch.equal(want, plain):
            raise AssertionError(f"{name}: probe_filter_rows != plain")
        for design in ("pr13",) + DESIGNS:
            outs[design] = torch.empty_like(codes)
            if not torch.equal(run(design, out=outs[design]), want):
                raise AssertionError(f"{name}: design {design} differs")
        fns = {"probe_rows": lambda: probe_rows(tbl.keys, tbl.values, codes,
                                                tbl.hash_mode),
               **{d: (lambda d=d: run(d, out=outs[d]))
                  for d in ("pr13",) + DESIGNS},
               "probe_filter_rows": lambda: probe_filter_rows(
                   tbl.keys, tbl.values, pred, codes, tbl.hash_mode),
               "pack_bits": lambda: pack_bits(pred, "positive")}
        if name == "part":
            gen.manual_seed(1)
            k = 10_000
            perm = torch.randperm(n, generator=gen, device=dev)
            delta = empty_delta(65536, 8, device=dev)
            delta = upsert_batch(delta, perm[:k].int(),
                                 torch.randint(0, n, (k,), generator=gen,
                                               device=dev, dtype=torch.int32))
            delta = delete_batch(delta, perm[k:2 * k].int())
            delta = upsert_batch(delta, torch.arange(n, n + k, device=dev,
                                                     dtype=torch.int32),
                                 torch.arange(k, device=dev,
                                              dtype=torch.int32))
            dwords = delta_slot_words(delta, torch.ones(n, dtype=torch.bool,
                                                        device=dev))
            dbids = hash_bucket(codes, delta.num_buckets, delta.hash_mode)
            dops = (delta.keys, dwords, codes, dbids,
                    pack_bits(delta.keys, "occupied")[1])
            want_d = probe_filter_rows_delta(
                tbl.keys, tbl.values, pred, codes, tbl.hash_mode, delta.keys,
                dwords, codes, delta.hash_mode)
            plain_d = plain_chunked(
                probe_filter_rows_delta_plain,
                (tbl.keys, tbl.values, pred, codes, tbl.hash_mode,
                 delta.keys, dwords, codes, delta.hash_mode), (3, 7))
            if not torch.equal(want_d, plain_d):
                raise AssertionError("probe_filter_rows_delta != plain")
            for design in ("pr13",) + DESIGNS:
                o = torch.empty_like(codes)
                if not torch.equal(run(design, dops, o), want_d):
                    raise AssertionError(f"delta design {design} differs")
                fns[f"{design}+delta"] = (lambda d=design, o=o:
                                          run(d, dops, o))
            fns["probe_filter_rows_delta"] = lambda: probe_filter_rows_delta(
                tbl.keys, tbl.values, pred, codes, tbl.hash_mode, delta.keys,
                dwords, codes, delta.hash_mode)
        ms = {f: [] for f in fns}
        for order in (list(fns), list(fns)[::-1]):
            for f in order:
                ms[f].append(event_ms(fns[f]))
        mask_nonzero = float(pred.any(dim=1).float().mean())
        row = {"keys": n, "table": list(tbl.keys.shape),
               "plane_bytes": tbl.keys.numel() * 4,
               "selectivity": f"1/{sel}",
               "buckets_with_a_passing_slot": mask_nonzero,
               "hits_passing": int(want.ne(-2).sum()),
               "ms": {f: sum(v) / len(v) for f, v in ms.items()},
               "ms_passes": ms}
        summary["tables"][name] = row
        print(f"[{name}] {n} keys, table {tuple(tbl.keys.shape)} "
              f"({row['plane_bytes']} B per plane), predicate 1/{sel}, "
              f"{mask_nonzero:.4f} of buckets hold a passing slot: "
              + json.dumps({f: round(v, 4) for f, v in row["ms"].items()}),
              flush=True)
        del idx, tbl, codes, pred, bids, bits, bucket_bits, outs, fns, want
        del plain
        torch.cuda.empty_cache()
    # the port's two kernels at the other widths (and with the hash modes
    # swapped) against their plain versions: every template instance,
    # the shared-memory path (W <= 16) and the L1 one (W >= 32)
    gen.manual_seed(2)
    n, mw = 100_000, 1 << 20
    for w, dw, mode in ((4, 4, "identity"), (16, 16, "fibonacci"),
                        (32, 8, "identity"), (64, 4, "fibonacci"),
                        (128, 128, "identity")):
        keys = torch.randperm(4 * n, generator=gen, device=dev)[:n].int()
        tbl = build_table(keys, torch.arange(n, device=dev,
                                             dtype=torch.int32),
                          num_buckets=suggest_num_buckets(n, w),
                          bucket_width=w, hash_mode=mode)
        pred = slot_predicate(tbl, torch.rand(n, generator=gen, device=dev)
                              < 0.2)
        probes = keys[torch.randint(0, n, (mw,), generator=gen,
                                    device=dev)]
        probes[::7] = -probes[::7] - 1
        probes[::11] = EMPTY_KEY
        delta = empty_delta(1024, dw, hash_mode=HASH_FIBONACCI
                            if mode == "identity" else "identity",
                            device=dev)
        delta = upsert_batch(delta, keys[:500], torch.arange(
            500, device=dev, dtype=torch.int32))
        delta = delete_batch(delta, keys[500:700])
        dwords = delta_slot_words(delta, torch.ones(n, dtype=torch.bool,
                                                    device=dev))
        ops = (tbl.keys, tbl.values, pred, probes, mode)
        dops = ops + (delta.keys, dwords, probes, delta.hash_mode)
        if not torch.equal(probe_filter_rows(*ops),
                           probe_filter_rows_plain(*ops)) or \
                not torch.equal(probe_filter_rows_delta(*dops),
                                probe_filter_rows_delta_plain(*dops)):
            raise AssertionError(f"W={w} DW={dw} {mode}: a filter kernel "
                                 "differs from its plain version")
        print(f"[widths] W={w} DW={dw} {mode}: both filter kernels "
              "bit-identical to their plain versions", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
