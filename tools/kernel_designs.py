#!/usr/bin/env python3
"""Time the designs of the probe kernels, fused_query and the window mask on
one CUDA card.

    python3 tools/kernel_designs.py [--sf 10] [--reps 10] [--out summary.json]
                                    [--only probe,fused,window,widths]

Builds ``tools/stream_designs.cu``, ``tools/fused_designs.cu`` and
``tools/window_designs.cu`` (each includes the port's own source, so the
shipped kernels run as they ship beside the designs they were measured
against) with ``nvcc``, generates SSB at ``--sf`` (seed 0) and builds the
port's engine, then times with CUDA events (launches queued behind a
sleeping kernel, two passes: forward, then reverse order):

- ``probe_rows`` and ``bucket_probe_stream`` (one function) on every
  dimension's 60M fact probe codes (at SF10): ``ids`` (the first design of
  ``probe_rows``, bucket ids made beforehand), ``lanes`` (the stream's first
  design, bucket ids read from a vector), ``direct`` (one thread a probe,
  hashed in the kernel), ``rows1``-``rows8`` (the port's ``rows_kernel`` at
  1, 2, 4 or 8 probes a thread, every key row loaded before the first
  compare), ``direct2``/``direct4`` (``direct``'s code at 2 or 4 probes a
  thread), ``first1``-``first4`` (the value read as one 4-byte load of
  the first matching lane; ``firstcg`` through L2 only, ``firstL1`` with
  the SM's memory given to L1; ``rows``: the port's, first1 as shipped),
  ``prefetch`` (persistent, the next key row in registers), the
  ``ring`` of 2, 3 or 4 stages (copies through L2 only) and of 2 or 3
  stages cached in L1 too (``ring2ca``, ``ring3ca``; ``ring2ca4`` and
  ``ring2ca6`` at 4 or 6 blocks per SM; ``ring2reg`` with the keys in
  registers), the ring with the value used one probe later (``defer``),
  both planes in shared memory (``table``, ``table2``, ``table4``,
  ``table8``: 1, 2, 4 or 8 probes a thread a step; ``tableS2``,
  ``tableS4``, ``tableS8`` with the value read as ``first`` reads it;
  where they fit), and the port's wrappers
  (``stream``, ``probe_rows``); then, by the host clock ending in
  ``synchronize``, ``ops.probe_table`` on each dimension against the path
  it replaced (``hash_bucket`` in PyTorch, ``ids``, ``unpack_words``);
- ``fused_query`` on Q2.1, Q3.1 and Q4.3, static and with live deltas
  (0.5% of every dimension's keys deleted and 0.5% upserted, seed 1), and
  on Q1.1-Q1.3 static: the first design (``ids``, bucket ids made
  beforehand), ``hash``, ``screen``, ``order``, ``smem`` (the shipped
  kernel), ``nofp`` and ``mfirst`` (the bit sets packed beforehand), and
  the port's wrapper (``port``, its packing included) and the packing
  alone (``pack``);
- ``coalesce_window_mask`` on 60M Zipf(s) keys over 2M keys, s in {0,
  1.5}: ``tile`` (the first design), ``runs`` (16 consecutive keys a
  lane), ``generic`` (the shipped chunks on their generic path) and the
  port's wrapper at window 8, and ``tile`` and
  the wrapper at windows 2, 17 and 32.

Every design's output must equal the port's.  Last, it holds the port's
probe kernels (and ``pack_query_bits``) against their plain versions at
bucket widths 4 to 128, both hash modes, on planes with duplicate keys in
a bucket, with and without deltas, ``probe_rows`` and the stream both
beside the planes and (a 500-key table) from shared memory (1M probes,
seed 2).  Prints one line per dimension, query, stream and width, and a
JSON summary as the last line, and writes the summary to ``--out`` when
given.  ``--only`` runs the named sections alone.
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

# codes 0..31 of stream_design_launch
PROBE_DESIGNS = ("lanes", "direct", "defer", "ring2", "ring3", "ring4",
                 "table", "ring2ca", "ring3ca", "ring2ca4", "ring2ca6",
                 "ring2reg", "prefetch", "ids", "rows1", "rows2", "rows4",
                 "rows8", "table2", "table4", "direct2", "direct4",
                 "first1", "first2", "first4", "firstcg", "firstL1", "rows",
                 "tableS4", "table8", "tableS2", "tableS8")
# designs that read bucket ids, and those that need the planes in shared
# memory
WITH_IDS = ("lanes", "ids")
TABLE_DESIGNS = ("table", "table2", "table4", "table8", "tableS2",
                 "tableS4", "tableS8")
# codes of window_design_launch
WINDOW_DESIGNS = ("tile", "runs", "generic")
WINDOW_KEYS, WINDOW_PROBES = 2_000_000, 60_000_000
HOST_REPS = 5
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
    for name in ("stream_designs", "fused_designs", "window_designs"):
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
    wo = libs["window_designs"]
    wo.window_design_launch.argtypes = (_I32, _P, _P, _I64, _I32, _P)
    wo.window_design_launch.restype = ctypes.c_int
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--only", default="probe,fused,window,widths",
                    help="comma-separated sections to run")
    args = ap.parse_args()
    only = set(args.only.split(","))

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_designs: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.core.hash_table import (EMPTY_KEY, HASH_FIBONACCI,
                                             build_table, hash_bucket,
                                             suggest_num_buckets)
    from repro_torch.core.lookup import unpack_words
    from repro_torch.core.skew import zipf_weights
    from repro_torch.engine import SSB_QUERIES, SSBEngine, Table, generate_ssb
    from repro_torch.engine.join import effective_index
    from repro_torch.engine.queries import DIM_PK, FACT_FK, _mega_operands
    from repro_torch.core.dictionary import encode
    from repro_torch.kernels import _build
    from repro_torch.kernels.bucket_probe import (bucket_probe_stream,
                                                  bucket_probe_stream_plain,
                                                  probe_rows,
                                                  probe_rows_plain)
    from repro_torch.kernels.coalesce_window import coalesce_window_mask
    from repro_torch.kernels.ops import probe_table
    from repro_torch.kernels.fused_query import (_tables, fused_query,
                                                 fused_query_plain,
                                                 pack_query_bits,
                                                 pack_query_bits_plain)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    _build.build(("bucket_probe", "fused_query", "coalesce_window"))
    libs = build_designs(_build.NVCC_FLAGS)
    print(f"[build] {time.perf_counter() - t0:.2f} s")
    so, fo, wo = (libs["stream_designs"], libs["fused_designs"],
                  libs["window_designs"])
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
               "probe": {}, "probe_table_host_ms": {}, "fused": {},
               "window": {}}

    def host_ms(fns):
        """Host ms per call of each of ``fns``, each call ending in
        ``synchronize``: HOST_REPS calls each, in turns forward and back."""
        for f in fns.values():
            f()
        torch.cuda.synchronize()
        ms = {f: [] for f in fns}
        for r in range(HOST_REPS):
            for f in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                t = time.perf_counter()
                fns[f]()
                torch.cuda.synchronize()
                ms[f].append((time.perf_counter() - t) * 1e3)
        return ms

    # -- probe_rows and bucket_probe_stream ---------------------------------
    for dim, index in (engine.indexes.items() if "probe" in only else ()):
        tbl = index.table
        codes = encode(index.dictionary, fact[FACT_FK[dim]])
        bids = hash_bucket(codes, tbl.num_buckets, tbl.hash_mode)
        fib = int(tbl.hash_mode == HASH_FIBONACCI)
        m, nb = codes.shape[0], tbl.num_buckets
        want = probe_rows(tbl.keys, tbl.values, codes, tbl.hash_mode)
        if not torch.equal(want, bucket_probe_stream(tbl.keys, tbl.values,
                                                     codes, tbl.hash_mode)):
            raise AssertionError(f"{dim}: stream != probe_rows")
        fits = 2 * 4 * tbl.keys.numel() <= 96 << 10
        designs = [d for d in PROBE_DESIGNS
                   if d not in TABLE_DESIGNS or fits]
        outs = {d: torch.empty_like(codes) for d in designs}

        def run(d, o, ids=bids):
            check(so.stream_design_launch(
                PROBE_DESIGNS.index(d), tbl.keys.data_ptr(),
                tbl.values.data_ptr(), codes.data_ptr(),
                ids.data_ptr() if d in WITH_IDS else 0, o.data_ptr(), m, nb,
                fib, stream), d)

        for d in designs:
            run(d, outs[d])
            if not torch.equal(outs[d], want):
                raise AssertionError(f"{dim}: design {d} differs")
        fns = {d: (lambda d=d: run(d, outs[d])) for d in designs}
        fns["stream"] = lambda: bucket_probe_stream(tbl.keys, tbl.values,
                                                    codes, tbl.hash_mode)
        fns["probe_rows"] = lambda: probe_rows(tbl.keys, tbl.values, codes,
                                               tbl.hash_mode)
        ms, passes = time_all(fns)
        summary["probe"][dim] = {"table": list(tbl.keys.shape), "ms": ms,
                                 "ms_passes": passes}
        print(f"[probe] {dim} table {tuple(tbl.keys.shape)}, {m} probes: "
              + json.dumps({k: round(v, 4) for k, v in ms.items()}),
              flush=True)
        del bids, outs

        def before():
            """The gathered entry as it was: the bucket ids hashed in
            PyTorch, the ids kernel, the words unpacked."""
            ids = hash_bucket(codes, nb, tbl.hash_mode)
            o = torch.empty_like(codes)
            run("ids", o, ids)
            return unpack_words(o)

        got, ref = probe_table(tbl, codes), before()
        if not all(torch.equal(x, y) for x, y in zip(got, ref)):
            raise AssertionError(f"{dim}: probe_table differs")
        host = host_ms({"probe_table": lambda: probe_table(tbl, codes),
                        "before": before})
        summary["probe_table_host_ms"][dim] = host
        print(f"[ops] probe_table on {dim}, host ms per call (ending in "
              f"synchronize), this tree / the path it replaced: "
              + json.dumps({k: [round(x, 4) for x in v]
                            for k, v in host.items()}), flush=True)
        del codes, want, fns, got, ref
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
    if "fused" in only:
        fused_cases(engine, "static", FUSED_QUERIES, every)
        fused_cases(engine, "static", Q1, ("smem", "mfirst"))
    del engine
    torch.cuda.empty_cache()
    if "fused" in only:
        fused_cases(mutated(), "live", FUSED_QUERIES, every)
        torch.cuda.empty_cache()

    # -- coalesce_window_mask -----------------------------------------------
    def zipf_keys(n_keys, size, zs, seed):
        """Zipf(zs) keys over ``n_keys`` (``zipf_sample``'s draws, its
        inverse-CDF search run on the card)."""
        rng = np.random.default_rng(seed)
        cdf = zipf_weights(n_keys, zs).cumsum()
        cdf /= cdf[-1]
        u = torch.from_numpy(rng.random(size)).cuda()
        idx = torch.searchsorted(torch.from_numpy(cdf).cuda(), u, right=True)
        perm = torch.from_numpy(rng.permutation(n_keys).astype(np.int32))
        return perm.cuda()[idx.clamp_max(n_keys - 1)]

    for zs in ((0.0, 1.5) if "window" in only else ()):
        keys = zipf_keys(WINDOW_KEYS, WINDOW_PROBES, zs, 7)
        m = keys.shape[0]
        for window in (8, 2, 17, 32):
            want = coalesce_window_mask(keys, window=window)
            designs = [d for d in WINDOW_DESIGNS
                       if d == "tile" or window == 8]
            outs = {d: torch.empty_like(want) for d in designs}

            def wrun(d, window=window, outs=outs):
                check(wo.window_design_launch(
                    WINDOW_DESIGNS.index(d), keys.data_ptr(),
                    outs[d].data_ptr(), m, window, stream), d)

            for d in designs:
                wrun(d)
                if not torch.equal(outs[d], want):
                    raise AssertionError(f"window {window} s={zs}: design "
                                         f"{d} differs")
            fns = {d: (lambda d=d: wrun(d)) for d in designs}
            fns["port"] = lambda window=window: coalesce_window_mask(
                keys, window=window)
            ms, passes = time_all(fns)
            summary["window"][f"s={zs} window={window}"] = {
                "ms": ms, "ms_passes": passes,
                "filtered": int(want.sum()) / m}
            print(f"[window] s={zs}, window {window}, {m} keys (filters "
                  f"{int(want.sum()) / m:.6f}): "
                  + json.dumps({k: round(v, 4) for k, v in ms.items()}),
                  flush=True)
            del want, outs, fns
        del keys
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

    widths = ((4, 4, "identity"), (8, 8, "fibonacci"), (16, 4, "identity"),
              (32, 8, "fibonacci"), (64, 16, "identity"),
              (128, 128, "fibonacci"))
    for w, dw, mode in (widths if "widths" in only else ()):
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
                    if not torch.equal(probe_rows(t_k, t_v, probes, mode),
                                       probe_rows_plain(t_k, t_v, probes,
                                                        mode)):
                        raise AssertionError(f"W={w} {mode}: probe_rows "
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
        print(f"[widths] W={w} DW={dw} {mode}: probe_rows, "
              "bucket_probe_stream, pack_query_bits and fused_query (1, 4000 and 2^21 segments, "
              "deltas on two of three dimensions) bit-identical to their "
              "plain versions", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
