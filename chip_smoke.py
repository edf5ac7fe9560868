#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's static SSB read path on one CUDA card.

    python3 chip_smoke.py [--sf 10] [--seed 0]

Phases (each raises on failure; nothing is caught):

1. Device: the card's name and power limit as ``nvidia-smi`` reports them.
2. Build: compile every CUDA source in ``src/repro_torch/kernels/csrc`` with
   ``nvcc`` (one process per source, all at once) and time it.
3. Kernels against their plain versions on the card, bit for bit: every
   registry case, then the real operands of the generated data (every
   dimension's probes, in chunks of at most 4M for the plain version, and
   all 13 queries' ``fused_query`` operands).
4. Main path: ``generate_ssb(sf)`` -> ``SSBEngine(tables)``, then the 13
   queries through (a) ``run_all(fusion="composed")`` on the probe cache,
   (b) cold ``run(q, use_cache=False)``, (c) ``run(q, fusion="mega")`` and
   (d) ``mode="baseline"``.  All four must agree, Q1.1 and Q2.1 must match
   a numpy computation on the host arrays, and every kernel's launch count
   over this run must equal the path's fixed count.
5. Numbers: per-query wall times per path, per-kernel device time per
   launch (CUDA events) beside the plain version's, the bytes each launch
   must move and the bound they set, peak device memory.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when no CUDA device is available or the package is missing.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM data sheet (at its 700 W limit): HBM3 rate, and the float32
# rate outside the tensor cores, used as the peak for the kernels' int32
# ALU operations
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
CHUNK = 4 << 20          # plain-version probes per chunk
KERNEL_REPS = 10
PLAIN_REPS = 3
# launches of each kernel over one main-path run (phase 4)
EXPECTED_LAUNCHES = {"probe_rows": 8, "probe_filter_rows": 32,
                     "fused_query": 13}
# the shapes the kernel table reports: the largest dimension's probes, and
# the query with the most dimensions and the largest group space
TIMED_DIM = "part"
TIMED_QUERY = "Q4.3"
# the dimension predicate each probe_filter_rows check uses
FILTER_QUERY = {"customer": "Q3.1", "supplier": "Q2.1", "part": "Q2.1",
                "date": "Q1.1"}


def log(*parts):
    print(*parts, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.core import ExecutionPolicy, encode, hash_bucket
    from repro_torch.engine import SSB_QUERIES, SSBEngine, generate_ssb
    from repro_torch.engine.queries import FACT_FK, _mega_operands
    from repro_torch.kernels import _build
    from repro_torch.kernels.ops import KERNEL_REGISTRY, slot_predicate

    def sync():
        torch.cuda.synchronize()

    def max_err(a, b) -> int:
        if isinstance(a, tuple):
            return max(max_err(x, y) for x, y in zip(a, b))
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"shape/dtype {a.shape} {a.dtype} vs "
                                 f"{b.shape} {b.dtype}")
        if a.numel() == 0:
            return 0
        return int((a.long() - b.long()).abs().max())

    def event_ms(fn, reps) -> float:
        fn()
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    # -- 1. device ------------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[device] torch: {kind}; count {torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    log(f"[build] {time.perf_counter() - t0:.2f} s wall for "
        f"{sorted(built)} (nvcc per source in parallel)")
    for name, (secs, text) in built.items():
        log(f"[build] {name}: {secs:.2f} s")
        entry = ""
        for line in text.splitlines():
            m = re.search(r"([a-z_]+_kernel)I(\w+?)EEEv", line)
            if "Compiling entry" in line and m:
                entry = f"{m.group(1)}<{m.group(2)}>"
            elif "Used" in line:
                log(f"[ptxas] {name} {entry}: {line.split(':', 1)[1].strip()}")

    # -- 3a. kernels against plain versions: registry cases --------------------
    err = {name: 0 for name in KERNEL_REGISTRY}
    for name, op in KERNEL_REGISTRY.items():
        for case, cargs, kw in op.make_cases("cuda"):
            got = op.fn(*cargs, **kw)
            want = op.plain_fn(*cargs, **kw)
            sync()
            e = max_err(got, want)
            err[name] = max(err[name], e)
            if e:
                raise AssertionError(f"{name}[{case}] differs from its plain "
                                     f"version by {e}")
            log(f"[parity] {name}[{case}]: bit-identical")

    # -- 4. main path (data, engine) -------------------------------------------
    t0 = time.perf_counter()
    tables = generate_ssb(args.sf, seed=args.seed)
    sync()
    t_gen = time.perf_counter() - t0
    n_fact = tables["lineorder"].n_rows
    log(f"[data] sf={args.sf} seed={args.seed}: lineorder {n_fact} rows, "
        + ", ".join(f"{d} {tables[d].n_rows}" for d in
                    ("customer", "supplier", "part", "date"))
        + f"; {sum(t.nbytes() for t in tables.values()) / 1e9:.3f} GB on "
        f"the card; generated in {t_gen:.2f} s")
    t0 = time.perf_counter()
    engine = SSBEngine(tables)
    sync()
    log(f"[engine] indexes built in {time.perf_counter() - t0:.3f} s: "
        + "; ".join(f"{d}: {s.num_buckets}x{s.bucket_width} buckets, "
                    f"{s.n_unique} keys, overflow {s.overflow}"
                    for d, s in engine.build_stats.items()))
    names = sorted(SSB_QUERIES)
    fact_cols = dict(tables["lineorder"].columns)

    # -- 3b. kernels against plain versions (and timed) on real operands ------
    def nbytes(*ts) -> int:
        return sum(t.numel() * t.element_size() for t in ts)

    def bound(bytes_moved, ops):
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = ops / ALU_OPS_PER_S * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    rows = {}
    for dim, index in engine.indexes.items():
        tbl = index.table
        codes = encode(index.dictionary, fact_cols[FACT_FK[dim]])
        bids = hash_bucket(codes, tbl.num_buckets, tbl.hash_mode)
        spec = SSB_QUERIES[FILTER_QUERY[dim]]
        pred = slot_predicate(tbl, spec.dim_filters[dim](tables[dim]))
        for name, ops in (("probe_rows", (tbl.keys, tbl.values, codes, bids)),
                          ("probe_filter_rows",
                           (tbl.keys, tbl.values, pred, codes, bids))):
            op = KERNEL_REGISTRY[name]
            got = op.fn(*ops)

            def plain(ops=ops, op=op):
                return [op.plain_fn(*ops[:-2], ops[-2][s:s + CHUNK],
                                    ops[-1][s:s + CHUNK])
                        for s in range(0, n_fact, CHUNK)]
            e = max_err(got, torch.cat(plain()))
            err[name] = max(err[name], e)
            if e:
                raise AssertionError(f"{name} on {dim} differs from its "
                                     f"plain version by {e}")
            if dim == TIMED_DIM:
                moved = nbytes(*ops) + 4 * n_fact
                b_ms, b_by = bound(moved, n_fact * (2 * tbl.bucket_width + 4))
                rows[name] = {
                    "shape": f"{dim}: {n_fact} probes, table "
                             f"{tuple(tbl.keys.shape)}", "bytes": moved,
                    "ms": event_ms(lambda: op.fn(*ops), KERNEL_REPS),
                    "plain_ms": event_ms(plain, PLAIN_REPS),
                    "bound_ms": b_ms, "bound_by": b_by}
        log(f"[parity] probe_rows, probe_filter_rows on {dim} ({n_fact} "
            f"probes, {FILTER_QUERY[dim]} predicate): bit-identical")
        del codes, bids, pred, got

    def fused_plain_chunked(dim_ops, fmeasure, size):
        groups = torch.zeros(size, dtype=torch.int32, device=fmeasure.device)
        for s in range(0, fmeasure.shape[0], CHUNK):
            part = tuple(tuple(t[s:s + CHUNK] if i % 4 < 2 else t
                               for i, t in enumerate(ops)) for ops in dim_ops)
            groups += KERNEL_REGISTRY["fused_query"].plain_fn(
                part, fmeasure[s:s + CHUNK], num_segments=size)[1]
        return groups.sum().to(torch.int32), groups

    fused = KERNEL_REGISTRY["fused_query"]
    fused_ms = {}
    for q in names:
        spec = SSB_QUERIES[q]
        dim_cols = {d: dict(tables[d].columns) for d in spec.joined_dims()}
        dim_ops, fmeasure, size = _mega_operands(spec, fact_cols, dim_cols,
                                                 engine.indexes)
        got = fused.fn(dim_ops, fmeasure, num_segments=size)
        e = max_err(got, fused_plain_chunked(dim_ops, fmeasure, size))
        err["fused_query"] = max(err["fused_query"], e)
        if e:
            raise AssertionError(f"fused_query {q} differs from its plain "
                                 f"version by {e}")
        fused_ms[q] = event_ms(lambda: fused.fn(dim_ops, fmeasure,
                                                num_segments=size),
                               KERNEL_REPS)
        if q == TIMED_QUERY:
            moved = nbytes(*(t for ops in dim_ops for t in ops), fmeasure) \
                + 4 * size
            w = dim_ops[0][2].shape[1]
            b_ms, b_by = bound(moved, n_fact * len(dim_ops) * (2 * w + 8))
            rows["fused_query"] = {
                "shape": f"{q}: {n_fact} rows, {len(dim_ops)} dims, {size} "
                         "segments", "bytes": moved, "ms": fused_ms[q],
                "plain_ms": event_ms(lambda: fused_plain_chunked(
                    dim_ops, fmeasure, size), PLAIN_REPS),
                "bound_ms": b_ms, "bound_by": b_by}
        del dim_ops, fmeasure, got
    log(f"[parity] fused_query on all {len(names)} queries' operands: "
        "bit-identical")
    log(f"[kernel] fused_query ms per launch by query: "
        f"{json.dumps({q: round(v, 4) for q, v in fused_ms.items()})}")
    torch.cuda.empty_cache()

    # -- 4. main path: the four paths, counted --------------------------------
    baseline = SSBEngine(tables, policy=ExecutionPolicy(mode="baseline"))

    def drive():
        """Run the four paths; returns ({path: {q: result}}, {path: {q: s}})."""
        res, wall = {}, {}

        def timed(path, q, fn):
            t = time.perf_counter()
            out = fn()
            sync()
            wall.setdefault(path, {})[q] = time.perf_counter() - t
            res.setdefault(path, {})[q] = out

        engine.invalidate_probe_cache()
        t = time.perf_counter()
        res["cached"] = engine.run_all(fusion="composed")
        sync()
        wall["cached_suite"] = time.perf_counter() - t
        for q in names:  # warm cache: the per-query tails alone
            timed("cached_warm", q, lambda: engine.run(q))
        for q in names:
            timed("cold", q, lambda: engine.run(q, use_cache=False))
        for q in names:
            timed("mega", q, lambda: engine.run(q, fusion="mega"))
        baseline.invalidate_probe_cache()
        for q in names:
            timed("baseline", q, lambda: baseline.run(q))
        return res, wall

    drive()  # warm-up pass: allocator, first launches
    for op in KERNEL_REGISTRY.values():
        op.fn.launches = 0
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res, wall = drive()
    launches = {name: op.fn.launches for name, op in KERNEL_REGISTRY.items()}
    peak = torch.cuda.max_memory_allocated()
    log(f"[launches] main path: {json.dumps(launches)}")
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"launch counts {launches} != expected "
                             f"{EXPECTED_LAUNCHES}")

    for q in names:
        total, groups = res["cached"][q]
        for path in ("cached_warm", "cold", "mega", "baseline"):
            t2, g2 = res[path][q]
            if int(t2) != int(total) or not torch.equal(g2, groups):
                raise AssertionError(f"{q}: path {path} disagrees with the "
                                     "cached path")
        if groups.shape[0] > 1 and int(groups.sum().to(torch.int32)) != \
                int(total):
            raise AssertionError(f"{q}: total is not the sum of groups")
    log(f"[agree] all {len(names)} queries: cached == cold == mega == "
        "baseline, bit for bit")

    # numpy checks (dimension PKs are row indices: the join is indexing)
    host = {c: tables["lineorder"][c].cpu().numpy().astype(np.int64)
            for c in ("orderdate", "discount", "quantity", "extendedprice",
                      "partkey", "suppkey", "revenue")}
    dim_np = {d: {c: v.cpu().numpy().astype(np.int64)
                  for c, v in tables[d].columns.items()}
              for d in ("date", "part", "supplier")}

    def wrap32(x):
        return ((np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31)

    m = ((dim_np["date"]["year"][host["orderdate"]] == 1993)
         & (host["discount"] >= 1) & (host["discount"] <= 3)
         & (host["quantity"] < 25))
    want = wrap32((host["extendedprice"] * host["discount"])[m].sum())
    if int(want) != int(res["cached"]["Q1.1"][0]):
        raise AssertionError(f"Q1.1 {int(res['cached']['Q1.1'][0])} != "
                             f"numpy {int(want)}")
    pk, sk = host["partkey"], host["suppkey"]
    m = ((dim_np["part"]["category"][pk] == 12)
         & (dim_np["supplier"]["region"][sk] == 1))
    gk = (dim_np["date"]["year"][host["orderdate"]] % 7) * 1000 \
        + dim_np["part"]["brand"][pk] % 1000
    groups = np.zeros(7000, np.int64)
    np.add.at(groups, gk[m], host["revenue"][m])
    if not np.array_equal(wrap32(groups),
                          res["cached"]["Q2.1"][1].cpu().numpy()):
        raise AssertionError("Q2.1 groups differ from numpy")
    log("[numpy] Q1.1 total and Q2.1 groups match numpy on the host arrays")
    del host, dim_np

    # -- 5. numbers ---------------------------------------------------------------
    log(f"[memory] resident before the main path (tables, indexes): "
        f"{resident} bytes; peak allocated over it: {peak} bytes "
        f"({peak / 2**30:.3f} GiB)")
    log(f"[wall] cached run_all suite (4 probes + 13 tails): "
        f"{wall['cached_suite'] * 1e3:.3f} ms")
    for path in ("cached_warm", "cold", "mega", "baseline"):
        per = {q: round(wall[path][q] * 1e3, 3) for q in names}
        log(f"[wall] {path} ms per query: {json.dumps(per)}; total "
            f"{sum(wall[path].values()) * 1e3:.3f} ms")

    for name, r in rows.items():
        log(f"[kernel] {name} at {r['shape']}: {r['ms']:.4f} ms/launch "
            f"(plain {r['plain_ms']:.4f} ms), moves {r['bytes']} bytes, "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
            f"({r['bound_ms'] / r['ms'] * 100:.1f}% of bound)")

    table = {"kernels": [
        {"name": name, "route": "cuda",
         "source": KERNEL_REGISTRY[name].source,
         "replaces": KERNEL_REGISTRY[name].replaces,
         "launches": launches[name], "max_abs_err": err[name],
         "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": None}
        for name, r in rows.items()]}
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
