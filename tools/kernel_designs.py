#!/usr/bin/env python3
"""Time the designs of bucket_probe_stream and fused_query on one CUDA card.

    python3 tools/kernel_designs.py [--sf 10] [--reps 10] [--out summary.json]

Builds ``tools/stream_designs.cu`` and ``tools/fused_designs.cu`` (each
includes the port's own source, so the shipped kernels run as they ship
beside the designs they were measured against) with ``nvcc``, generates
SSB at ``--sf`` (seed 0) and builds the port's engine, then times with CUDA
events (launches queued behind a sleeping kernel, two passes: forward, then
reverse order):

- ``bucket_probe_stream`` on every dimension's 60M fact probe codes (at
  SF10): the first design, ``lanes`` (bucket ids read from a vector),
  ``direct`` (one thread a probe, hashed in the kernel), the ``ring`` of
  2, 3 or 4 stages (copies through L2 only) and of 2 or 3 stages cached
  in L1 too (``ring2ca``, ``ring3ca``; ``ring2ca4`` and ``ring2ca6`` at 4
  or 6 blocks per SM; ``ring2reg`` with the keys in registers), the ring
  with the value used one probe later (``defer``), a double buffer in
  registers (``prefetch``), both planes in shared memory (``table``, where
  they fit),
  the port's wrapper (``port``) and ``probe_rows`` (its bucket ids made
  beforehand);
- ``fused_query`` on Q2.1, Q3.1 and Q4.3, static and with live deltas
  (0.5% of every dimension's keys deleted and 0.5% upserted, seed 1), and
  on Q1.1-Q1.3 static: the first design (``ids``, bucket ids made
  beforehand), ``hash``, ``screen``, ``order``, ``smem`` (the shipped
  kernel), ``nofp`` and ``mfirst`` (the bit sets packed beforehand), and
  the port's wrapper (``port``, its packing included) and the packing
  alone (``pack``).

Every design's output must equal the port's.  Last, it holds the port's
two kernels (and ``pack_query_bits``) against their plain versions at
bucket widths 4 to 128, both hash modes, on planes with duplicate keys in
a bucket, with and without deltas, the stream both through its ring and
(a 500-key table) from shared memory (1M probes, seed 2).  Prints one line
per dimension, query and width, and a JSON summary as the last line, and
writes the summary to ``--out`` when given.
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

STREAM_DESIGNS = ("lanes", "direct", "defer", "ring2", "ring3", "ring4",
                  "table", "ring2ca", "ring3ca", "ring2ca4", "ring2ca6",
                  "ring2reg", "prefetch")
# codes 1..6
FUSED_DESIGNS = ("hash", "screen", "order", "smem", "mfirst", "nofp")
FUSED_QUERIES = ("Q2.1", "Q3.1", "Q4.3")
Q1 = ("Q1.1", "Q1.2", "Q1.3")
MUTATION_FRAC = 0.005
SLEEP_CYCLES = 100_000_000
_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32


def build_designs(nvcc_flags) -> dict[str, ctypes.CDLL]:
    out_dir = ROOT / "tools" / "_build"
    out_dir.mkdir(exist_ok=True)
    nvcc = "/usr/local/cuda/bin/nvcc"
    procs = {}
    for name in ("stream_designs", "fused_designs"):
        lib = out_dir / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *nvcc_flags, "-o", str(lib),
             str(ROOT / "tools" / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}.cu:\n{log}")
        for line in log.splitlines():
            if "Used" in line or "Compiling entry" in line or "spill" in line:
                print(f"[ptxas] {name}: {line.strip()}")
        libs[name] = ctypes.CDLL(str(lib))
    so = libs["stream_designs"]
    so.stream_design_launch.argtypes = (_I32, _P, _P, _P, _P, _P, _I64, _I64,
                                        _I32, _P)
    so.stream_design_launch.restype = ctypes.c_int
    fo = libs["fused_designs"]
    fo.fused_design_launch.argtypes = (_I32, _P, _P, _I32, _P, _P, _I64, _P,
                                       _I32, _P)
    fo.ids_launch.argtypes = (_P, _P, _I32, _P, _I64, _P, _I32, _I32, _P)
    fo.fused_design_launch.restype = fo.ids_launch.restype = ctypes.c_int
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_designs: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.core.hash_table import (EMPTY_KEY, HASH_FIBONACCI,
                                             build_table, hash_bucket,
                                             suggest_num_buckets)
    from repro_torch.engine import SSB_QUERIES, SSBEngine, Table, generate_ssb
    from repro_torch.engine.join import effective_index
    from repro_torch.engine.queries import DIM_PK, FACT_FK, _mega_operands
    from repro_torch.core.dictionary import encode
    from repro_torch.kernels import _build
    from repro_torch.kernels.bucket_probe import (bucket_probe_stream,
                                                  bucket_probe_stream_plain,
                                                  probe_rows)
    from repro_torch.kernels.fused_query import (_tables, fused_query,
                                                 fused_query_plain,
                                                 pack_query_bits,
                                                 pack_query_bits_plain)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    _build.build(("bucket_probe", "fused_query"))
    libs = build_designs(_build.NVCC_FLAGS)
    print(f"[build] {time.perf_counter() - t0:.2f} s")
    so, fo = libs["stream_designs"], libs["fused_designs"]
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def event_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        for _ in range(args.reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / args.reps

    def time_all(fns):
        ms = {f: [] for f in fns}
        for order in (list(fns), list(fns)[::-1]):
            for f in order:
                ms[f].append(event_ms(fns[f]))
        return {f: sum(v) / len(v) for f, v in ms.items()}, ms

    def check(status, what):
        if status:
            raise RuntimeError(f"{what}: CUDA error {status}")

    tables = generate_ssb(args.sf, seed=0)
    engine = SSBEngine(tables)
    fact = tables["lineorder"]
    summary = {"device": smi, "sf": args.sf, "reps": args.reps,
               "stream": {}, "fused": {}}

    # -- bucket_probe_stream ------------------------------------------------
    for dim, index in engine.indexes.items():
        tbl = index.table
        codes = encode(index.dictionary, fact[FACT_FK[dim]])
        bids = hash_bucket(codes, tbl.num_buckets, tbl.hash_mode)
        fib = int(tbl.hash_mode == HASH_FIBONACCI)
        m, nb = codes.shape[0], tbl.num_buckets
        want = bucket_probe_stream(tbl.keys, tbl.values, codes,
                                   tbl.hash_mode)
        if not torch.equal(want, probe_rows(tbl.keys, tbl.values, codes,
                                            bids)):
            raise AssertionError(f"{dim}: stream != probe_rows")
        fits = 2 * 4 * tbl.keys.numel() <= 96 << 10
        designs = [d for d in STREAM_DESIGNS if d != "table" or fits]
        outs = {d: torch.empty_like(codes) for d in designs}

        def run(d, o):
            check(so.stream_design_launch(
                STREAM_DESIGNS.index(d), tbl.keys.data_ptr(),
                tbl.values.data_ptr(), codes.data_ptr(), bids.data_ptr(),
                o.data_ptr(), m, nb, fib, stream), d)

        for d in designs:
            run(d, outs[d])
            if not torch.equal(outs[d], want):
                raise AssertionError(f"{dim}: stream design {d} differs")
        fns = {d: (lambda d=d: run(d, outs[d])) for d in designs}
        fns["port"] = lambda: bucket_probe_stream(tbl.keys, tbl.values,
                                                  codes, tbl.hash_mode)
        fns["probe_rows"] = lambda: probe_rows(tbl.keys, tbl.values, codes,
                                               bids)
        ms, passes = time_all(fns)
        summary["stream"][dim] = {"table": list(tbl.keys.shape), "ms": ms,
                                  "ms_passes": passes}
        print(f"[stream] {dim} table {tuple(tbl.keys.shape)}, {m} probes: "
              + json.dumps({k: round(v, 4) for k, v in ms.items()}),
              flush=True)
        del codes, bids, outs, want, fns
        torch.cuda.empty_cache()

    # -- fused_query --------------------------------------------------------
    fact_cols = dict(fact.columns)

    def mutated():
        eng = SSBEngine({"lineorder": fact, **{
            d: Table({c: v.clone() for c, v in tables[d].columns.items()})
            for d in DIM_PK}})
        rng = np.random.default_rng(1)
        for dim in DIM_PK:
            n = eng.tables[dim].n_rows
            k = max(1, int(n * MUTATION_FRAC))
            eng.ingest(dim, rng.choice(n, k, replace=False).astype(np.int32),
                       op="delete", auto_compact=False)
            eng.ingest(dim, rng.choice(n, k, replace=False).astype(np.int32),
                       rng.integers(0, n, k, dtype=np.int32), op="upsert",
                       auto_compact=False)
        return eng

    def fused_cases(eng, label, queries, designs):
        for q in queries:
            spec = SSB_QUERIES[q]
            idx = {d: effective_index(eng.indexes[d])
                   for d in spec.joined_dims()}
            dim_cols = {d: dict(eng.tables[d].columns)
                        for d in spec.joined_dims()}
            dim_ops, fm, size = _mega_operands(spec, fact_cols, dim_cols, idx)
            m = fm.shape[0]
            want = fused_query(dim_ops, fm, num_segments=size)[1]
            bits, stats = pack_query_bits(dim_ops)
            ptrs, ints = _tables(dim_ops, bits)
            # the first design's operands: bucket ids beside the codes
            old, widths = [], []
            for ops in dim_ops:
                pk, tk, ta, mode = ops[:4]
                old.append((pk, hash_bucket(pk, tk.shape[0], mode), tk, ta))
                widths += [tk.shape[1], 0]
                if len(ops) == 8:
                    dpk, dtk, dta, dmode = ops[4:]
                    old[-1] += (dpk, hash_bucket(dpk, dtk.shape[0], dmode),
                                dtk, dta)
                    widths[-1] = dtk.shape[1]
            old_ptrs = []
            for ops in old:
                old_ptrs += [t.data_ptr() for t in ops] + [0] * (8 - len(ops))
            old_ptrs = (ctypes.c_void_p * len(old_ptrs))(*old_ptrs)
            widths = (ctypes.c_int32 * len(widths))(*widths)
            outs = {d: torch.zeros(size, dtype=torch.int32, device=fm.device)
                    for d in ("ids",) + designs}

            def run(d):
                o = outs[d]
                o.zero_()
                if d == "ids":
                    check(fo.ids_launch(old_ptrs, widths, len(dim_ops),
                                         fm.data_ptr(), m, o.data_ptr(), size,
                                         min(-(-m // 256), sms * 4), stream),
                          d)
                else:
                    check(fo.fused_design_launch(
                        FUSED_DESIGNS.index(d) + 1, ptrs, ints, len(dim_ops),
                        stats.data_ptr(), fm.data_ptr(), m, o.data_ptr(),
                        size, stream), d)

            for d in outs:
                run(d)
                if not torch.equal(outs[d], want):
                    raise AssertionError(f"{q} ({label}): design {d} differs")
            fns = {d: (lambda d=d: run(d)) for d in outs}
            fns["port"] = lambda: fused_query(dim_ops, fm, num_segments=size)
            fns["pack"] = lambda: pack_query_bits(dim_ops)
            ms, passes = time_all(fns)
            summary["fused"][f"{q} {label}"] = {
                "planes": [list(o[1].shape) for o in dim_ops],
                "stats": stats.tolist(), "ms": ms, "ms_passes": passes}
            print(f"[fused] {q} ({label}; sort stats {stats.tolist()}): "
                  + json.dumps({k: round(v, 4) for k, v in ms.items()}),
                  flush=True)
            del dim_ops, fm, outs, fns, bits, stats, old

    every = ("hash", "screen", "order", "nofp", "smem")
    fused_cases(engine, "static", FUSED_QUERIES, every)
    fused_cases(engine, "static", Q1, ("smem", "mfirst"))
    del engine
    torch.cuda.empty_cache()
    fused_cases(mutated(), "live", FUSED_QUERIES, every)
    torch.cuda.empty_cache()

    # -- every width and hash mode, on planes with duplicate keys ------------
    # the two kernels against their plain versions: real tables of 20,000
    # keys where a fifth of the lanes after the first repeat their bucket's
    # first key, attributes in [-3, 4000) (odd, even, negative), 1M probes
    # (hits, misses, negative keys, EMPTY_KEY), deltas of 3,000 upserts and
    # 500 deletes with their own duplicates, the other hash mode
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    n, m = 20_000, 1 << 20

    def dup_table(w, mode, keys):
        tbl = build_table(keys, torch.arange(keys.shape[0], device="cuda",
                                             dtype=torch.int32),
                          num_buckets=suggest_num_buckets(keys.shape[0], w),
                          bucket_width=w, hash_mode=mode)
        tk = tbl.keys.clone()
        dup = (torch.rand(tk.shape, generator=gen, device="cuda") < 0.2) \
            & (tk[:, :1] != EMPTY_KEY)
        dup[:, 0] = False
        tk = torch.where(dup, tk[:, :1].expand_as(tk), tk).contiguous()
        attr = torch.randint(-3, 4000, tk.shape, generator=gen,
                             device="cuda", dtype=torch.int32)
        return tk, attr, tbl.values

    for w, dw, mode in ((4, 4, "identity"), (8, 8, "fibonacci"),
                        (16, 4, "identity"), (32, 8, "fibonacci"),
                        (64, 16, "identity"), (128, 128, "fibonacci")):
        other = "identity" if mode == "fibonacci" else "fibonacci"
        dim_ops = []
        for d in range(3):
            keys = torch.randperm(4 * n, generator=gen,
                                  device="cuda")[:n].int()
            tk, attr, tv = dup_table(w, mode, keys)
            probes = keys[torch.randint(0, n, (m,), generator=gen,
                                        device="cuda")]
            probes[::7] = -probes[::7] - 1
            probes[::11] = EMPTY_KEY
            dtk, dattr, _ = dup_table(dw, other, keys[:3_500])
            dattr[-500:] = -1  # tombstone-like
            ops = (probes, tk, attr, mode)
            dim_ops.append(ops + (probes, dtk, dattr, other) if d != 1
                           else ops)
            if d == 0:
                # the ring, and (500 keys) both planes in shared memory
                stk, _, stv = dup_table(w, mode, keys[:500])
                for t_k, t_v in ((tk, tv), (stk, stv)):
                    want = bucket_probe_stream_plain(t_k, t_v, probes, mode)
                    if not torch.equal(bucket_probe_stream(t_k, t_v, probes,
                                                           mode), want):
                        raise AssertionError(f"W={w} {mode}: stream "
                                             f"differs on {tuple(t_k.shape)}")
        fm = torch.randint(-1000, 100_000, (m,), generator=gen,
                           device="cuda", dtype=torch.int32)
        fm[::5] = 0
        (bits, stats), (pbits, pstats) = (pack_query_bits(dim_ops),
                                          pack_query_bits_plain(dim_ops))
        if not torch.equal(stats, pstats) or any(
                (x is None) != (y is None)
                or (x is not None and not torch.equal(x, y))
                for bx, by in zip(bits, pbits) for x, y in zip(bx, by)):
            raise AssertionError(f"W={w} {mode}: pack_query_bits differs")
        for size in (1, 4000, 1 << 21):
            got = fused_query(dim_ops, fm, num_segments=size)
            want = fused_query_plain(dim_ops, fm, num_segments=size)
            if not all(map(torch.equal, got, want)):
                raise AssertionError(f"W={w} DW={dw} {mode}, {size} "
                                     "segments: fused_query differs")
        print(f"[widths] W={w} DW={dw} {mode}: bucket_probe_stream, "
              "pack_query_bits and fused_query (1, 4000 and 2^21 segments, "
              "deltas on two of three dimensions) bit-identical to their "
              "plain versions", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
