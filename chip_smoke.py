#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's SSB paths on one CUDA card.

    python3 chip_smoke.py [--sf 10] [--seed 0]

Phases (each raises on failure; nothing is caught):

1. Device: the card's name and power limit as ``nvidia-smi`` reports them.
2. Build: compile every CUDA source in ``src/repro_torch/kernels/csrc`` with
   ``nvcc`` (one process per source, all at once) and time it.
3. Kernels against their plain versions on the card, bit for bit: every
   registry case, then the real operands of the generated data (every
   dimension's predicate plane through ``pack_bits``, its probes
   through ``probe_rows``, ``bucket_probe_stream`` and
   ``probe_filter_rows``, in chunks of at most 4M for the plain version,
   and all 13 queries' ``fused_query`` operands, with their
   ``pack_query_bits`` bit sets).
4. Main path: ``generate_ssb(sf)`` -> ``SSBEngine(tables)``, then the 13
   queries through (a) ``run_all(fusion="composed")`` on the probe cache,
   (b) cold ``run(q, use_cache=False)``, (c) ``run(q, fusion="mega")`` and
   (d) ``mode="baseline"``.  All four must agree, Q1.1 and Q2.1 must match
   a numpy computation on the host arrays, and every kernel's launch count
   over this run must equal the path's fixed count.
5. Stream path: an engine with ``schedule="stream"`` on the same indexes
   runs the cached and cold paths; its 13 answers must equal phase 4's and
   its launches the path's fixed count.  Then the forced skew-aware
   schedules: one engine with ``schedule="deduped"`` and one with
   ``"hot_cold"`` on the same indexes print each dimension's plan, run the
   cached and cold paths, give phase 4's answers and the launch counts
   their plans fix; ``schedule="auto"`` must raise ``NotImplementedError``
   on the card (no cost entry for it yet).
6. Mutation path: a fresh engine (its own dimension tables, the same fact
   table) and a ``kernel="torch"`` twin take a seeded stream per dimension
   with ``auto_compact=False``: delete 0.5% of the keys, upsert 0.5% to
   random rows (a few past the table's end, which the append then
   covers), append 0.5% new rows.  With the deltas live,
   ``probe_filter_rows_delta`` (every dimension) and ``fused_query`` (all
   13 queries' delta operands) are held against their plain versions on
   the real operands; the 13 queries run cached, cold, mega and on the
   twin, all must agree, Q1.1 and Q2.1 must match numpy over host
   key->row maps kept through the stream, and the launches must equal the
   fixed counts.  Then every dimension is compacted and the same checks
   run again, with the same answers.
6b. Fact-append path: a fresh gathered engine on phase 4's tables takes
   ``warm_cache()``, then 2 warm-up and 10 timed ``append_fact_rows`` of
   1% of the fact table each (600,000 rows at SF10, padded to a 2^20-row
   tail bucket; ``generate_fact_batch`` with seed+2).  Gates: each append
   launches ``probe_rows`` 4 times (one tail probe per cached dimension)
   and nothing else; after each append, ``probe_rows`` is held against
   its plain version on every dimension's padded tail window (the
   kernel's own inputs) and each tail lookup against ``impl="torch"``;
   the capacity grows once (the first append, to 76,546,048 rows at
   SF10); ``tail_extensions`` is 4 x 12, every report says "extended" for
   every dimension; the tenth append (+10% logical rows) runs the skew
   re-measure; no cached probe finds a padding row.  Then where an
   append's time goes: each dimension's tail lookup and lookup + splice
   by CUDA events, the four by the host clock, the validation, padding
   and host-to-device copies of the ten columns, ``Table.append_tail`` in
   place and with a capacity growth (three times, the first after
   ``torch.cuda.empty_cache()``), and the skew re-measure.  A twin takes
   the same batches with ``extend_cache=False`` + ``warm_cache()`` (the
   reprobe time).  Then the 13 queries over the padded columns (cached,
   cold, mega: the main path's launch counts) must agree with each
   other, with an engine rebuilt on the trimmed tables, and (Q1.1, Q2.1)
   with numpy on the logical rows; ``probe_filter_rows`` (every
   dimension) and ``fused_query`` (all 13 queries) are held against
   their plain versions on the padded operands.  A ``"stream"`` engine
   (4 ``bucket_probe_stream`` launches per append, then the stream
   path's counts), a forced ``"hot_cold"`` engine (per append and
   dimension one ``probe_rows`` for the hot table and one for the cold
   remainder unless the plan is a full map; its appends timed; then the
   counts of phase 5's hot/cold pass) and an engine holding phase 6's
   live deltas (4 ``probe_rows`` per append, then the live path's
   counts) repeat the appends, with the same per-append kernel checks;
   their answers must equal the gathered engine's and a rebuilt engine's
   with the same dimension ops, and ``probe_filter_rows_delta``
   (EMPTY_KEY raw keys against EMPTY_KEY-padded delta planes) and
   ``fused_query`` are held against their plain versions there.
7. Skew path (the JAX package's ``benchmarks/skew_sweep.py`` at SSB SF10
   sizes): a 2,000,000-key dimension with part's geometry, probed by
   60,000,000 Zipf(s) keys for s in the paper's grid {0, 0.5, 1.5, 2}.
   Per s: ``measure_skew``, the gathered, stream, deduped and hot/cold
   schedules through ``lookup`` (equal packed words, fixed launches,
   device time each), and ``coalesce_window_mask`` (window 8) against its
   plain version in chunks, with the share of probes it filters.  Then
   ``probe_rows`` and ``coalesce_window_mask`` against their plain
   versions where their indexing changes: ``probe_rows`` at W = 4 to 128,
   both hash modes, tables whose planes fit shared memory and larger
   ones, duplicate keys in a bucket, EMPTY_KEY probes, 0, 1, 1,283 and
   2^20 + 7 probes and slices that start off a 16-byte boundary; the
   window at 2, 8, 17 and 32 on every length where its split into a
   scalar head, spans of 512 keys a warp and a scalar tail changes, the
   keys starting 0 to 3 keys past a 16-byte boundary, with EMPTY_KEY and
   NO_CODE among them.
8. Numbers: per-query wall times per path, per-kernel device time per
   launch (CUDA events) beside the plain version's, the bytes each launch
   must move and the bound they set (for ``fused_query``, what the query's
   data needs: a row stops at the first dimension that rejects it, so
   later code vectors and the measure count only in the sectors a
   surviving row reaches), ingest and compact times, each append's
   wall ms with the tail-extend, hot/cold and reprobe medians, the
   growth append and the split above, the cached, cold and mega suites
   before and after the appends, peak device memory.  ``probe_rows``, ``bucket_probe_stream``
   and the two filter kernels are also timed on every dimension's
   operands (tables from date's to part's), and ``fused_query`` on every
   query, static and live, each with its launches per pass there; last,
   ``ops.probe_table`` on part's probes by the host clock (``[ops]``).  Device times come from
   CUDA events around launches queued behind a ``torch.cuda._sleep``, so
   that a wrapper's host time does not hide in them.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when no CUDA device is available or the package is missing.
"""
from __future__ import annotations

import argparse
import json
from fractions import Fraction
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
OPS_REPS = 5
# cycles of the kernel queued before a timed run (~50 ms at 2 GHz)
SLEEP_CYCLES = 100_000_000
# launches of each kernel over one run of each path: cached run_all (4
# probes), 13 cold queries (32 filtered probes, 4 unfiltered) and 13 mega
# queries (phase 4, and phase 6 after compaction); the stream schedule's
# cached and cold paths (phase 5); the live-delta paths (phase 6)
# (``pack_bits``, the filter kernels' packing of the predicate plane, runs
# once before each filter kernel, and once more for the delta's key plane;
# ``pack_query_bits``, the packing of a query's planes, once before each
# ``fused_query``)
_ZERO = {"probe_rows": 0, "bucket_probe_stream": 0, "probe_filter_rows": 0,
         "probe_filter_rows_delta": 0, "fused_query": 0,
         "coalesce_window_mask": 0, "pack_bits": 0, "pack_query_bits": 0}
EXPECTED_LAUNCHES = dict(_ZERO, probe_rows=8, probe_filter_rows=32,
                         pack_bits=32, fused_query=13, pack_query_bits=13)
EXPECTED_STREAM = dict(_ZERO, bucket_probe_stream=8, probe_filter_rows=32,
                       pack_bits=32)
EXPECTED_LIVE = dict(_ZERO, probe_rows=8, probe_filter_rows_delta=32,
                     pack_bits=64, fused_query=13, pack_query_bits=13)
# deduped: one probe_rows per unfiltered probe (of the unique keys), as
# gathered; hot_cold: see hot_cold_launches
EXPECTED_DEDUPED = dict(_ZERO, probe_rows=8, probe_filter_rows=32,
                        pack_bits=32)
# one pass of the skew phase per s: gathered 1, deduped 1 and hot_cold 2
# (hot-table words, cold remainder) probe_rows, stream 1, the window 1
EXPECTED_SKEW = dict(_ZERO, probe_rows=4, bucket_probe_stream=1,
                     coalesce_window_mask=1)
SCHEDULES = ("gathered", "stream", "deduped", "hot_cold")
# the skew phase: part's key count at SF10 and lineorder's row count, the
# paper's Zipf grid, the RLU window, the s whose window launch is timed
SKEW_KEYS = 2_000_000
SKEW_PROBES = 60_000_000
ZIPF_S = (0.0, 0.5, 1.5, 2.0)
WINDOW = 8
TIMED_S = 1.5
SKEW_REPS = 3
# the share of each dimension's keys the mutation stream deletes, upserts
# and appends
MUTATION_FRAC = 0.005
# the fact-append phase: batches of this share of the fact table (600,000
# rows at SF10, a 2^20-row tail bucket), warm-up and timed appends; the
# append whose logical rows first reach FACT_REMEASURE_FRAC (+10%)
# re-measures the skew
APPEND_FRAC = 0.01
APPEND_WARMUP = 2
APPEND_TIMED = 10
REMEASURE_AT = 10
# launches of one append on an engine with every dimension cached: one
# tail probe per dimension (the stream schedule: bucket_probe_stream)
EXPECTED_APPEND = dict(_ZERO, probe_rows=4)
EXPECTED_APPEND_STREAM = dict(_ZERO, bucket_probe_stream=4)
# the shapes the kernel table reports: the largest dimension's probes, and
# the query with the most dimensions and the largest group space
TIMED_DIM = "part"
TIMED_QUERY = "Q4.3"
# the probe kernels timed on every dimension's operands, not only part's
PER_DIM_KERNELS = ("probe_rows", "bucket_probe_stream", "probe_filter_rows",
                   "probe_filter_rows_delta")
# the dimension predicate each filter-kernel check uses
FILTER_QUERY = {"customer": "Q3.1", "supplier": "Q2.1", "part": "Q2.1",
                "date": "Q1.1"}
PATHS = ("cached", "cached_warm", "cold", "mega")


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

    from repro_torch.core.hash_table import (EMPTY_KEY, build_table,
                                             suggest_num_buckets)
    from repro_torch.core import (ExecutionPolicy, build_hot_table, encode,
                                  hash_bucket, hot_hit_count, measure_skew,
                                  pack_words, plan_probe, refine_plan,
                                  top_keys)
    from repro_torch.core.skew import zipf_sample, zipf_weights
    from repro_torch.engine import (SSB_QUERIES, SSBEngine, Table,
                                    build_dim_index, effective_index,
                                    extend_cached_probe,
                                    generate_fact_batch, generate_ssb,
                                    lookup, tail_lookup)
    from repro_torch.engine.queries import _check_batch_col
    from repro_torch.engine.table import pad_batch, tail_bucket
    from repro_torch.engine.queries import DIM_PK, FACT_FK, _mega_operands
    from repro_torch.kernels import _build
    from repro_torch.kernels.bucket_probe import pack_bits, pack_bits_plain
    from repro_torch.kernels.fused_query import (pack_query_bits,
                                                 pack_query_bits_plain)
    from repro_torch.kernels.ops import (KERNEL_REGISTRY, delta_slot_words,
                                         probe_table, slot_predicate)

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
        """Device ms per call of ``fn``: the calls are queued behind a
        sleeping kernel, so the events see the device's time, not the
        host's (unless ``fn`` synchronises, as the plain versions do)."""
        fn()
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def timed_call(fn) -> float:
        t = time.perf_counter()
        fn()
        sync()
        return time.perf_counter() - t

    def counted(fn):
        """``fn()`` with every kernel's launch count set to 0 just before
        it; returns (its result, the counts just after)."""
        for op in KERNEL_REGISTRY.values():
            op.fn.launches = 0
        pack_bits.launches = pack_query_bits.launches = 0
        out = fn()
        return out, dict({n: op.fn.launches
                          for n, op in KERNEL_REGISTRY.items()},
                         pack_bits=pack_bits.launches,
                         pack_query_bits=pack_query_bits.launches)

    def check_counts(got, want, what, quiet=False):
        if not quiet:
            log(f"[launches] {what}: {json.dumps(got)}")
        if got != want:
            raise AssertionError(f"{what}: launch counts {got} != expected "
                                 f"{want}")

    # -- 1. device ------------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[device] torch: {kind}; count {torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)
    t_script = time.perf_counter()

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    log(f"[build] {time.perf_counter() - t0:.2f} s wall for "
        f"{sorted(built)} (nvcc per source in parallel)")
    for name, (secs, text) in built.items():
        log(f"[build] {name}: {secs:.2f} s")
        entry = ""
        for line in text.splitlines():
            m = re.search(r"([a-z_]+_kernel)(?:I(\w+?)EEEv)?", line)
            if "Compiling entry" in line and m:
                entry = m.group(1) + (f"<{m.group(2)}>" if m.group(2)
                                      else "")
            elif "Used" in line:
                log(f"[ptxas] {name} {entry}: {line.split(':', 1)[1].strip()}")
            elif "spill" in line and " 0 bytes spill stores" not in line:
                log(f"[ptxas] {name} {entry}: {line.strip()}")

    # -- 3a. kernels against plain versions: registry cases --------------------
    err = {name: 0 for name in KERNEL_REGISTRY}

    def hold(name, args_, kw, what):
        """Kernel ``name`` against its plain version on one case."""
        op = KERNEL_REGISTRY[name]
        got = op.fn(*args_, **kw)
        want = op.plain_fn(*args_, **kw)
        sync()
        e = max_err(got, want)
        err[name] = max(err[name], e)
        if e:
            raise AssertionError(f"{name} ({what}) differs from its plain "
                                 f"version by {e}")

    for name, op in KERNEL_REGISTRY.items():
        for case, cargs, kw in op.make_cases("cuda"):
            hold(name, cargs, kw, case)
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

    def check_probe_kernel(name, ops, vector_idx, dim, n_ops_per_probe,
                           timed=True):
        """Hold one probe kernel against its plain version (in chunks of
        the probe vectors) on real operands; unless ``timed`` is False,
        time the kernel on every dimension (``PER_DIM_KERNELS``) or on
        ``TIMED_DIM``, and its plain version on ``TIMED_DIM``."""
        op = KERNEL_REGISTRY[name]
        got = op.fn(*ops)
        m = ops[vector_idx[0]].shape[0]

        def plain(ops=ops, op=op):
            return [op.plain_fn(*(t[s:s + CHUNK] if i in vector_idx else t
                                  for i, t in enumerate(ops)))
                    for s in range(0, m, CHUNK)]
        e = max_err(got, torch.cat(plain()))
        err[name] = max(err[name], e)
        if e:
            raise AssertionError(f"{name} on {dim} differs from its plain "
                                 f"version by {e}")
        if not timed or (dim != TIMED_DIM and name not in PER_DIM_KERNELS):
            return
        # the hash mode travels as a string: only tensors move bytes
        moved = nbytes(*(t for t in ops if torch.is_tensor(t))) + 4 * n_fact
        b_ms, b_by = bound(moved, n_fact * n_ops_per_probe)
        ms = event_ms(lambda: op.fn(*ops), KERNEL_REPS)
        if name in PER_DIM_KERNELS:
            per_dim.setdefault(name, {})[dim] = {
                "table": tuple(ops[0].shape), "ms": ms, "bytes": moved,
                "bound_ms": b_ms}
        if dim == TIMED_DIM:
            rows[name] = {
                "shape": f"{dim}: {n_fact} probes, table "
                         f"{tuple(ops[0].shape)}", "bytes": moved, "ms": ms,
                "plain_ms": event_ms(plain, PLAIN_REPS),
                "bound_ms": b_ms, "bound_by": b_by}

    def check_pack(plane, test, dim):
        """``pack_bits`` against its plain version; ms per launch."""
        got, want = pack_bits(plane, test), pack_bits_plain(plane, test)
        if not all(map(torch.equal, got, want)):
            raise AssertionError(f"pack_bits({test}) on {dim} differs from "
                                 "its plain version")
        return event_ms(lambda: pack_bits(plane, test), KERNEL_REPS)

    rows, per_dim, pack_ms = {}, {}, {}
    for dim, index in engine.indexes.items():
        tbl = index.table
        w = tbl.bucket_width
        codes = encode(index.dictionary, fact_cols[FACT_FK[dim]])
        spec = SSB_QUERIES[FILTER_QUERY[dim]]
        pred = slot_predicate(tbl, spec.dim_filters[dim](tables[dim]))
        pack_ms[dim] = check_pack(pred, "positive", dim)
        for name, ops, vectors in (
                ("probe_rows", (tbl.keys, tbl.values, codes, tbl.hash_mode),
                 (2,)),
                ("bucket_probe_stream",
                 (tbl.keys, tbl.values, codes, tbl.hash_mode), (2,)),
                ("probe_filter_rows",
                 (tbl.keys, tbl.values, pred, codes, tbl.hash_mode), (3,))):
            check_probe_kernel(name, ops, vectors, dim, 2 * w + 4)
        log(f"[parity] pack_bits, probe_rows, bucket_probe_stream, "
            f"probe_filter_rows on {dim} ({n_fact} probes, "
            f"{FILTER_QUERY[dim]} predicate): bit-identical")
        del codes, pred

    def fused_plain_chunked(dim_ops, fmeasure, size):
        # the probe vectors (pk, and dpk with a delta) in chunks
        groups = torch.zeros(size, dtype=torch.int32, device=fmeasure.device)
        for s in range(0, fmeasure.shape[0], CHUNK):
            part = tuple(tuple(t[s:s + CHUNK] if i % 4 == 0 else t
                               for i, t in enumerate(ops)) for ops in dim_ops)
            groups += KERNEL_REGISTRY["fused_query"].plain_fn(
                part, fmeasure[s:s + CHUNK], num_segments=size)[1]
        return groups.sum().to(torch.int32), groups

    fused = KERNEL_REGISTRY["fused_query"]

    def dim_passes(ops, lo, hi):
        """Which of rows [lo, hi) pass the dimension of ``ops`` (the plain
        version's rule: a delta hit overrides, the attribute must be >= 0
        and odd)."""
        def side(pk, tk, ta, mode):
            b = hash_bucket(pk, tk.shape[0], mode).long()
            match = tk[b] == pk[:, None]
            hit = match.any(dim=1) & (pk != EMPTY_KEY)
            return hit, torch.where(match, ta[b], 0).sum(dim=1).to(
                torch.int32)
        hit, attr = side(ops[0][lo:hi], *ops[1:4])
        attr = torch.where(hit, attr, -1)
        if len(ops) == 8:
            dhit, dattr = side(ops[4][lo:hi], *ops[5:8])
            attr = torch.where(dhit, dattr, attr)
        return (attr >= 0) & ((attr & 1) == 1)

    def sector_bytes(rows):
        """32-byte sectors of an (m,) int32 vector holding a row of
        ``rows``."""
        pad = torch.nn.functional.pad(rows, (0, -rows.shape[0] % 8))
        return 32 * int(pad.view(-1, 8).any(dim=1).sum())

    def fused_needed_bytes(dim_ops, fmeasure, stats, size):
        """What one query's data needs moved: the planes read once; in the
        kernel's dimension order (passing / occupied slots, ties in the
        given order), each dimension's probe vectors only in the sectors
        holding a row that reached it, and the measure only in those
        holding a row that passed them all; the groups written once."""
        st = stats.tolist()
        order = sorted(range(len(dim_ops)),
                       key=lambda d: Fraction(st[d][0], max(1, st[d][1])))
        moved = 4 * size + nbytes(*(t for ops in dim_ops
                                    for i, t in enumerate(ops)
                                    if torch.is_tensor(t) and i % 4 != 0))
        m = fmeasure.shape[0]
        alive = torch.ones(m, dtype=torch.bool, device=fmeasure.device)
        for d in order:
            moved += sector_bytes(alive) * len(dim_ops[d]) // 4
            alive &= torch.cat([dim_passes(dim_ops[d], lo, lo + CHUNK)
                                for lo in range(0, m, CHUNK)])
        return moved + sector_bytes(alive)

    def check_fused(eng, label):
        """``fused_query`` (and the ``pack_query_bits`` before it) against
        its plain version on all 13 queries' operands of ``eng`` (over its
        own fact table's physical rows); times it on each and prints its
        bytes, bound and launches x gap there."""
        ms, gap, bound_sum, every_sum = {}, 0.0, 0.0, 0.0
        cols = dict(eng.tables["lineorder"].columns)
        for q in names:
            spec = SSB_QUERIES[q]
            dim_cols = {d: dict(eng.tables[d].columns)
                        for d in spec.joined_dims()}
            idx = {d: effective_index(eng.indexes[d])
                   for d in spec.joined_dims()}
            dim_ops, fmeasure, size = _mega_operands(spec, cols,
                                                     dim_cols, idx)
            (bits, stats), (want_bits, want_stats) = (
                pack_query_bits(dim_ops), pack_query_bits_plain(dim_ops))
            if not torch.equal(stats, want_stats) or any(
                    (x is None) != (y is None)
                    or (x is not None and not torch.equal(x, y))
                    for bx, by in zip(bits, want_bits)
                    for x, y in zip(bx, by)):
                raise AssertionError(f"pack_query_bits {q} ({label}) "
                                     "differs from its plain version")
            got = fused.fn(dim_ops, fmeasure, num_segments=size)
            e = max_err(got, fused_plain_chunked(dim_ops, fmeasure, size))
            err["fused_query"] = max(err["fused_query"], e)
            if e:
                raise AssertionError(f"fused_query {q} ({label}) differs "
                                     f"from its plain version by {e}")
            ms[q] = event_ms(lambda: fused.fn(dim_ops, fmeasure,
                                              num_segments=size),
                             KERNEL_REPS)
            # what this query's data needs moved (each input read once:
            # every code vector and the measure whole, beside it); one
            # launch per pass
            every = nbytes(*(t for ops in dim_ops for t in ops
                             if torch.is_tensor(t)), fmeasure) + 4 * size
            moved = fused_needed_bytes(dim_ops, fmeasure, stats, size)
            w = dim_ops[0][1].shape[1]
            b_ms, b_by = bound(moved, fmeasure.shape[0] * len(dim_ops)
                               * (2 * w + 8))
            gap += ms[q] - b_ms
            bound_sum += b_ms
            every_sum += every / HBM_BYTES_PER_S * 1e3
            kinds = "+".join("delta" if len(o) == 8 else "static"
                             for o in dim_ops)
            log(f"[kernel-query] fused_query {q} ({label}; "
                f"{fmeasure.shape[0]} rows, "
                f"{[tuple(o[1].shape) for o in dim_ops]} planes, {kinds}, "
                f"{size} segments, sort stats {stats.tolist()}): "
                f"{ms[q]:.4f} ms/launch, moves {moved} bytes (every input "
                f"whole: {every}), bound {b_ms:.4f} ms by {b_by}; 1 launch "
                f"per pass, launches x gap {ms[q] - b_ms:.4f} ms")
            if q == TIMED_QUERY and "fused_query" not in rows:
                rows["fused_query"] = {
                    "shape": f"{q}: {fmeasure.shape[0]} rows, "
                             f"{len(dim_ops)} dims, "
                             f"{size} segments", "bytes": moved,
                    "ms": ms[q],
                    "plain_ms": event_ms(lambda: fused_plain_chunked(
                        dim_ops, fmeasure, size), PLAIN_REPS),
                    "bound_ms": b_ms, "bound_by": b_by}
            del dim_ops, fmeasure, got, bits, want_bits
        log(f"[parity] pack_query_bits and fused_query on all {len(names)} "
            f"queries' operands ({label}): bit-identical")
        log(f"[kernel] fused_query ms per launch by query ({label}): "
            f"{json.dumps({q: round(v, 4) for q, v in ms.items()})}")
        log(f"[kernel-query] fused_query sum over {len(names)} queries "
            f"({label}): {sum(ms.values()):.4f} ms, bound {bound_sum:.4f} "
            f"ms (every input whole: {every_sum:.4f} ms), launches x gap "
            f"{gap:.4f} ms")
        return ms

    check_fused(engine, "static indexes")
    torch.cuda.empty_cache()

    # -- 4. main path: the four paths, counted --------------------------------
    baseline = SSBEngine(tables, policy=ExecutionPolicy(mode="baseline"))

    def drive_paths(eng, paths):
        """Run ``eng``'s named paths over the 13 queries; returns
        ({path: {q: result}}, {path: {q: seconds}}).  "cached" is
        ``run_all`` from an empty probe cache (its wall under
        "cached_suite"), "cached_warm" the per-query tails on the filled
        cache, "cold" and "mega" the per-query cold and mega runs."""
        res, wall = {}, {}

        def timed(path, q, fn):
            t = time.perf_counter()
            out = fn()
            sync()
            wall.setdefault(path, {})[q] = time.perf_counter() - t
            res.setdefault(path, {})[q] = out

        for path in paths:
            if path == "cached":
                eng.invalidate_probe_cache()
                t = time.perf_counter()
                res["cached"] = eng.run_all(fusion="composed")
                sync()
                wall["cached_suite"] = time.perf_counter() - t
            for q in names:
                if path == "cached_warm":
                    timed(path, q, lambda: eng.run(q))
                elif path == "cold":
                    timed(path, q, lambda: eng.run(q, use_cache=False))
                elif path == "mega":
                    timed(path, q, lambda: eng.run(q, fusion="mega"))
        return res, wall

    def drive():
        """The four paths of phase 4."""
        res, wall = drive_paths(engine, PATHS)
        baseline.invalidate_probe_cache()
        rb, wb = drive_paths(baseline, ("cached_warm",))
        res["baseline"], wall["baseline"] = rb["cached_warm"], wb["cached_warm"]
        return res, wall

    def check_agree(res, ref, paths, label):
        for q in names:
            total, groups = ref[q]
            for path in paths:
                t2, g2 = res[path][q]
                if int(t2) != int(total) or not torch.equal(g2, groups):
                    raise AssertionError(f"{q}: {label} path {path} "
                                         "disagrees")
            if groups.shape[0] > 1 and int(groups.sum().to(torch.int32)) != \
                    int(total):
                raise AssertionError(f"{q}: total is not the sum of groups")

    drive()  # warm-up pass: allocator, first launches
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (res, wall), launches = counted(drive)
    peak = torch.cuda.max_memory_allocated()
    check_counts(launches, EXPECTED_LAUNCHES, "main path")
    check_agree(res, res["cached"], ("cached_warm", "cold", "mega",
                                     "baseline"), "static")
    log(f"[agree] all {len(names)} queries: cached == cold == mega == "
        "baseline, bit for bit")

    # numpy checks: Q1.1's total and Q2.1's groups from the host arrays,
    # joining through a key->row map per dimension (-1: joins nothing)
    host = {c: tables["lineorder"][c].cpu().numpy().astype(np.int64)
            for c in ("orderdate", "discount", "quantity", "extendedprice",
                      "partkey", "suppkey", "revenue")}

    def wrap32(x):
        return ((np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31)

    def check_numpy(answers, eng, key_row, label):
        dim_np = {d: {c: v.cpu().numpy().astype(np.int64)
                      for c, v in eng.tables[d].columns.items()}
                  for d in ("date", "part", "supplier")}

        def rows_of(dim, fk):
            r = key_row[dim][host[fk]] if key_row else host[fk]
            return r >= 0, np.maximum(r, 0)

        ok_d, rd = rows_of("date", "orderdate")
        m = (ok_d & (dim_np["date"]["year"][rd] == 1993)
             & (host["discount"] >= 1) & (host["discount"] <= 3)
             & (host["quantity"] < 25))
        want = wrap32((host["extendedprice"] * host["discount"])[m].sum())
        if int(want) != int(answers["Q1.1"][0]):
            raise AssertionError(f"Q1.1 ({label}) {int(answers['Q1.1'][0])} "
                                 f"!= numpy {int(want)}")
        ok_p, rp = rows_of("part", "partkey")
        ok_s, rs = rows_of("supplier", "suppkey")
        m = (ok_d & ok_p & ok_s & (dim_np["part"]["category"][rp] == 12)
             & (dim_np["supplier"]["region"][rs] == 1))
        gk = (dim_np["date"]["year"][rd] % 7) * 1000 \
            + dim_np["part"]["brand"][rp] % 1000
        groups = np.zeros(7000, np.int64)
        np.add.at(groups, gk[m], host["revenue"][m])
        if not np.array_equal(wrap32(groups),
                              answers["Q2.1"][1].cpu().numpy()):
            raise AssertionError(f"Q2.1 groups ({label}) differ from numpy")
        log(f"[numpy] Q1.1 total and Q2.1 groups ({label}) match numpy on "
            "the host arrays")

    # dimension PKs are row indices: the static join is plain indexing
    check_numpy(res["cached"], engine, None, "static")

    # -- 5. stream path ---------------------------------------------------------
    stream_engine = SSBEngine(tables, indexes=engine.indexes,
                              policy=ExecutionPolicy(schedule="stream"))
    drive_paths(stream_engine, ("cached", "cold"))  # warm-up pass
    (res_s, wall_s), launches_s = counted(
        lambda: drive_paths(stream_engine, ("cached", "cold")))
    check_counts(launches_s, EXPECTED_STREAM, "stream path")
    check_agree(res_s, res["cached"], ("cached", "cold"), "stream")
    log(f"[agree] stream schedule: all {len(names)} queries, cached and "
        "cold, equal the gathered engine's, bit for bit")
    del stream_engine
    torch.cuda.empty_cache()

    # -- 5b. forced skew-aware schedules ------------------------------------------
    try:
        SSBEngine(tables, indexes=engine.indexes,
                  policy=ExecutionPolicy(schedule="auto"))
    except NotImplementedError as e:
        log(f"[auto] schedule='auto' on the card raises "
            f"NotImplementedError: {e}")
    else:
        raise AssertionError("schedule='auto' ran on the card: it must "
                             "raise until the planner slice")
    unfiltered = [d for q in names for d in SSB_QUERIES[q].joined_dims()
                  if d not in SSB_QUERIES[q].dim_filters]

    def hot_cold_launches(plans):
        """probe_rows launches of one cached + cold pass under hot_cold:
        per probe, the hot-table words, plus the cold remainder unless the
        plan is a full map (or its fallback probe: also one launch)."""
        per = {d: 1 + (not p.full_map) for d, p in plans.items()}
        return dict(_ZERO, probe_filter_rows=32, pack_bits=32,
                    probe_rows=sum(per.values())
                    + sum(per[d] for d in unfiltered))

    wall_sched, launches_sched = {}, {}
    for sched in ("deduped", "hot_cold"):
        t0 = time.perf_counter()
        eng_s = SSBEngine(tables, indexes=engine.indexes,
                          policy=ExecutionPolicy(schedule=sched))
        sync()
        log(f"[schedule] {sched}: engine planned in "
            f"{time.perf_counter() - t0:.3f} s; " + "; ".join(
                f"{d}: {p.schedule}, full_map {p.full_map}, hot "
                f"{p.hot_entries} entries / {p.hot_slots} slots, cold "
                f"capacity {p.cold_capacity}"
                for d, p in sorted(eng_s.plans.items())))
        for d, p in eng_s.plans.items():
            full = int(engine.indexes[d].dictionary.n) <= 65536
            if p.schedule != sched or (sched == "hot_cold"
                                       and p.full_map != full):
                raise AssertionError(f"{sched} plan of {d}: {p}")
        want = (EXPECTED_DEDUPED if sched == "deduped"
                else hot_cold_launches(eng_s.plans))
        drive_paths(eng_s, ("cached", "cold"))  # warm-up pass
        (res_x, wall_sched[sched]), launches_sched[sched] = counted(
            lambda: drive_paths(eng_s, ("cached", "cold")))
        check_counts(launches_sched[sched], want, f"{sched} path")
        check_agree(res_x, res["cached"], ("cached", "cold"), sched)
        log(f"[agree] {sched} schedule: all {len(names)} queries, cached "
            "and cold, equal the gathered engine's, bit for bit")
        del eng_s, res_x
        torch.cuda.empty_cache()

    # -- 6. mutation path ---------------------------------------------------------
    def own_dims():
        return {"lineorder": tables["lineorder"],
                **{d: Table({c: v.clone() for c, v in tables[d].columns.items()})
                   for d in DIM_PK}}

    t0 = time.perf_counter()
    mut = SSBEngine(own_dims())
    twin = SSBEngine(own_dims(), policy=ExecutionPolicy(kernel="torch"))
    sync()
    log(f"[mutation] two engines (cuda, torch) built in "
        f"{time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(args.seed + 1)
    key_row = {}      # dim -> host key->row map, -1 where a key joins nothing
    ingest_ms = {}
    mut_ops = []      # (dim, deletes, upserts, payloads, new rows), replayed

    for dim in DIM_PK:
        n = mut.tables[dim].n_rows
        k = max(1, int(n * MUTATION_FRAC))
        dels = rng.choice(n, k, replace=False).astype(np.int32)
        ups = rng.choice(n, k, replace=False).astype(np.int32)
        pays = rng.integers(0, n + k, k, dtype=np.int32)  # some past the end
        src = rng.integers(0, n, k)
        rows_new = {c: v.cpu().numpy()[src]
                    for c, v in mut.tables[dim].columns.items()}
        rows_new[DIM_PK[dim]] = np.arange(n, n + k, dtype=np.int32)
        kr = np.arange(n + k, dtype=np.int64)
        kr[dels] = -1
        kr[ups] = pays
        key_row[dim] = kr
        mut_ops.append((dim, dels, ups, pays, rows_new))
        for eng in (mut, twin):
            calls = (("delete", lambda: eng.ingest(dim, dels, op="delete",
                                                   auto_compact=False)),
                     ("upsert", lambda: eng.ingest(dim, ups, pays,
                                                   op="upsert",
                                                   auto_compact=False)),
                     ("append_rows", lambda: eng.append_rows(
                         dim, rows_new, auto_compact=False)))
            for label, call in calls:
                secs = timed_call(call)
                if eng is mut:
                    ingest_ms[f"{dim}.{label}({k})"] = round(secs * 1e3, 3)
        if mut.tables[dim].n_rows != n + k or int(kr.max()) >= n + k:
            raise AssertionError(f"{dim}: the append did not cover every "
                                 "re-pointed row")
    occupancy = {d: {f: s[f] for f in ("n_entries", "n_tombstones",
                                       "num_slots", "max_bucket_fill")}
                 for d, s in mut.ingest_info()["deltas"].items()}
    log(f"[mutation] live deltas: {json.dumps(occupancy)}")
    if sorted(occupancy) != sorted(DIM_PK):
        raise AssertionError("every dimension should hold a live delta")

    # kernels against their plain versions on the live-delta operands
    for dim in DIM_PK:
        idx = effective_index(mut.indexes[dim])
        tbl, dl = idx.table, idx.delta
        fk = fact_cols[FACT_FK[dim]]
        codes = encode(idx.dictionary, fk)
        dmask = SSB_QUERIES[FILTER_QUERY[dim]].dim_filters[dim](
            mut.tables[dim])
        check_pack(dl.keys, "occupied", dim)
        ops = (tbl.keys, tbl.values, slot_predicate(tbl, dmask), codes,
               tbl.hash_mode, dl.keys, delta_slot_words(dl, dmask), fk,
               dl.hash_mode)
        check_probe_kernel("probe_filter_rows_delta", ops, (3, 7), dim,
                           2 * tbl.bucket_width + 2 * dl.bucket_width + 8)
        log(f"[parity] pack_bits of the delta keys, probe_filter_rows_delta "
            f"on {dim} ({n_fact} probes, "
            f"delta {tuple(dl.keys.shape)}, {FILTER_QUERY[dim]} predicate): "
            "bit-identical")
        del codes, ops
    check_fused(mut, "live deltas")
    torch.cuda.empty_cache()

    def drive_mut():
        """The mutated engine's four paths plus the twin's cached path."""
        r, w = drive_paths(mut, PATHS)
        rt, wt = drive_paths(twin, ("cached",))
        r["torch"], w["torch_suite"] = rt["cached"], wt["cached_suite"]
        return r, w

    drive_mut()  # warm-up pass
    (res_live, wall_live), launches_live = counted(drive_mut)
    check_counts(launches_live, EXPECTED_LIVE, "mutation path, live deltas")
    check_agree(res_live, res_live["cached"],
                ("cached_warm", "cold", "mega", "torch"), "live-delta")
    log(f"[agree] live deltas: all {len(names)} queries: cached == cold == "
        "mega == torch, bit for bit")
    check_numpy(res_live["cached"], mut, key_row, "live deltas")

    compact_ms = {}
    for dim in DIM_PK:
        compact_ms[dim] = round(timed_call(lambda: mut.compact(dim)) * 1e3, 3)
        twin.compact(dim)
        if mut.indexes[dim].delta is not None or \
                twin.indexes[dim].delta is not None:
            raise AssertionError(f"{dim}: delta left after compact")
    log("[mutation] compacted: " + "; ".join(
        f"{d}: {s.num_buckets}x{s.bucket_width} buckets, {s.n_unique} keys, "
        f"{s.n_build} rows, grow retries {s.grow_retries}"
        for d, s in mut.build_stats.items()))
    drive_mut()  # warm-up pass
    (res_c, wall_c), launches_c = counted(drive_mut)
    peak_mut = torch.cuda.max_memory_allocated()
    check_counts(launches_c, EXPECTED_LAUNCHES, "mutation path, compacted")
    check_agree(res_c, res_live["cached"],
                ("cached", "cached_warm", "cold", "mega", "torch"),
                "compacted")
    log(f"[agree] compacted: all {len(names)} queries: cached == cold == "
        "mega == torch == the live-delta answers, bit for bit")
    check_numpy(res_c["cached"], mut, key_row, "compacted")
    del host

    del mut, twin, res_live, res_c
    torch.cuda.empty_cache()

    # -- 6b. fact-append path -----------------------------------------------------
    def replay_mutations(eng):
        """Phase 6's dimension stream on ``eng`` (deltas stay live)."""
        for dim, dels, ups, pays, rows_new in mut_ops:
            eng.ingest(dim, dels, op="delete", auto_compact=False)
            eng.ingest(dim, ups, pays, op="upsert", auto_compact=False)
            eng.append_rows(dim, rows_new, auto_compact=False)

    def replay_dim_ops(eng):
        """Phase 6's deletes and upserts on an engine whose dimension
        tables already hold the appended rows."""
        for dim, dels, ups, pays, _ in mut_ops:
            eng.ingest(dim, dels, op="delete", auto_compact=False)
            eng.ingest(dim, ups, pays, op="upsert", auto_compact=False)

    def check_padding(eng, label):
        """Every cached probe misses on the capacity padding rows."""
        n = eng.tables["lineorder"].n_rows
        for d in DIM_PK:
            if bool(eng.probe_dim(d)[0][n:].any()):
                raise AssertionError(f"{label}: a padding row of {d} was "
                                     "found")

    def check_tail(eng, name, label):
        """The kernel the append's tail probe launches (``name``) against
        its plain version on the padded FK window the last append wrote,
        per dimension; and the whole tail lookup under the engine's plan
        (hot table, cold stream, delta overlay) against ``impl="torch"``."""
        fact = eng.tables["lineorder"]
        n0 = fact.n_rows - n_batch
        for dim in DIM_PK:
            idx = effective_index(eng.indexes[dim])
            tbl = idx.table
            fk_tail = fact[FACT_FK[dim]].narrow(0, n0, bp)
            check_probe_kernel(name, (tbl.keys, tbl.values,
                                      encode(idx.dictionary, fk_tail),
                                      tbl.hash_mode), (2,), dim,
                               2 * tbl.bucket_width + 4, timed=False)
            plan, hot = eng.plans.get(dim), eng._hot_codes.get(dim)
            got = tail_lookup(idx, fk_tail, hot, impl="cuda", plan=plan)
            want = tail_lookup(idx, fk_tail, hot, impl="torch", plan=plan)
            if max_err(got, want):
                raise AssertionError(f"{label}: the tail lookup of {dim} "
                                     "differs from its plain version")

    def append_all(eng, batches, want, label):
        """Every batch through ``eng.append_fact_rows``: each append's
        launches must be ``want``; after each, ``check_tail``.  Returns
        the reports and each append's wall ms (host clock ending in a
        synchronize)."""
        reps_, ms = [], []
        name = next(k for k in ("probe_rows", "bucket_probe_stream")
                    if want[k])
        i = -1
        for i, b in enumerate(batches):
            secs, got = counted(lambda: timed_call(
                lambda: reps_.append(eng.append_fact_rows(b))))
            ms.append(secs * 1e3)
            check_counts(got, want, f"{label} append {i}", quiet=True)
            check_tail(eng, name, f"{label} append {i}")
        log(f"[launches] each of the {label} engine's {i + 1} "
            f"appends: {json.dumps(want)}; {name} bit-identical to its "
            "plain version on every append's padded tail of every "
            "dimension, and each tail lookup to impl='torch'")
        return reps_, ms

    def rebuilt_answers(eng, ops):
        """The 13 answers of an engine rebuilt on ``eng``'s trimmed fact
        table and its dimension tables, ``ops`` replayed on it."""
        trimmed = eng.tables["lineorder"].trimmed()
        rebuilt = SSBEngine({"lineorder": trimmed,
                             **{d: eng.tables[d] for d in DIM_PK}})
        ops(rebuilt)
        out = rebuilt.run_all(fusion="composed")
        sync()
        return out

    torch.cuda.reset_peak_memory_stats()
    n_batch = int(n_fact * APPEND_FRAC)
    bp = tail_bucket(n_batch)
    n_appends = APPEND_WARMUP + APPEND_TIMED
    t0 = time.perf_counter()
    fa = SSBEngine(tables)
    fa.warm_cache()
    sync()
    log(f"[append] gathered engine built and warmed in "
        f"{time.perf_counter() - t0:.3f} s; {n_appends} appends of "
        f"{n_batch} rows ({APPEND_WARMUP} warm-up)")
    rng = np.random.default_rng(args.seed + 2)
    batches = []

    def fresh_batches():
        """Each batch drawn from the gathered engine's tables as they
        stand (kept for the other engines)."""
        for _ in range(n_appends):
            batches.append(generate_fact_batch(fa.tables, n_batch, rng))
            yield batches[-1]

    reports, append_ms = append_all(fa, fresh_batches(), EXPECTED_APPEND,
                                    "gathered")
    info = fa.fact_append_info()
    grew = [i for i, r in enumerate(reports) if r["capacity_grew"]]
    log(f"[append] reports: grew at {grew}; skew re-planned "
        f"{[r['skew_replanned'] for r in reports]}; "
        f"{json.dumps(info)}")
    if len(grew) != 1:
        raise AssertionError(f"capacity grew at appends {grew}, not once")
    if info["tail_extensions"] != len(DIM_PK) * n_appends or \
            info["tail_reprobes"] != 0:
        raise AssertionError(f"tail extensions {info}")
    if any(r["dims"] != {d: "extended" for d in DIM_PK} for r in reports):
        raise AssertionError("an append did not extend every dimension")
    if fa._skew_measured_rows != n_fact + REMEASURE_AT * n_batch:
        raise AssertionError(f"the skew re-measure did not run at append "
                             f"{REMEASURE_AT}")
    check_padding(fa, "gathered engine")

    # where an append's time goes (on the gathered engine after its
    # appends, the last batch's window): the tail lookup and the lookup
    # plus splice per dimension on the card (device time), the four
    # extensions by the host clock; the validation of ten columns, their
    # padding and host-to-device copies, the table's append_tail in place
    # and with a capacity growth (the first after emptying the
    # allocator's cache); one skew re-measure of the four FK columns
    fact = fa.tables["lineorder"]
    n0 = fact.n_rows - n_batch
    split = {"lookup": {}, "extend": {}}
    extend = []
    for dim in DIM_PK:
        idx = effective_index(fa.indexes[dim])
        fk_tail = fact[FACT_FK[dim]].narrow(0, n0, bp)
        plan, hot = fa.plans.get(dim), fa._hot_codes.get(dim)
        cached = tuple(t.clone() for t in fa.probe_dim(dim))
        split["lookup"][dim] = event_ms(
            lambda: tail_lookup(idx, fk_tail, hot, impl="cuda", plan=plan),
            KERNEL_REPS)
        extend.append(lambda idx=idx, c=cached, fk=fk_tail, h=hot, p=plan:
                      extend_cached_probe(idx, *c, fk, n0, h, impl="cuda",
                                          plan=p, owned=True))
        split["extend"][dim] = event_ms(extend[-1], KERNEL_REPS)
    split["extend_wall"] = [timed_call(lambda: [f() for f in extend]) * 1e3
                            for _ in range(5)]
    del extend, cached
    cols = batches[-1]
    pad = {FACT_FK[d]: EMPTY_KEY for d in DIM_PK}
    split["validate"] = [timed_call(lambda: [
        _check_batch_col(k, v) for k, v in cols.items()]) * 1e3
        for _ in range(5)]
    split["pad_copy"] = [timed_call(lambda: [
        pad_batch(v, bp, pad.get(k, 0), fact.device)
        for k, v in cols.items()]) * 1e3 for _ in range(5)]
    trim = fact.trimmed()
    torch.cuda.empty_cache()
    split["grow"] = [timed_call(lambda: trim.append_tail(cols, pad,
                                                         bucket=bp)) * 1e3
                     for _ in range(3)]
    grown_t = trim.append_tail(cols, pad, bucket=bp)
    split["in_place"] = []
    for _ in range(5):
        t = time.perf_counter()
        grown_t = grown_t.append_tail(cols, pad, bucket=bp)
        sync()
        split["in_place"].append((time.perf_counter() - t) * 1e3)
    del trim, grown_t
    split["measure_skew"] = [timed_call(lambda: [
        measure_skew(fact[FACT_FK[d]][:fact.n_rows]) for d in DIM_PK]) * 1e3
        for _ in range(3)]
    torch.cuda.empty_cache()

    # the same appends with the cache invalidated and re-probed
    twin_r = SSBEngine(tables)
    twin_r.warm_cache()
    reprobe_ms = []
    for b in batches:
        reprobe_ms.append(timed_call(lambda: (
            twin_r.append_fact_rows(b, extend_cache=False),
            twin_r.warm_cache())) * 1e3)
    if twin_r.fact_append_info()["tail_reprobes"] != \
            len(DIM_PK) * n_appends:
        raise AssertionError("the reprobe twin did not invalidate")
    del twin_r
    torch.cuda.empty_cache()

    # the queries over the grown, capacity-padded columns
    drive_paths(fa, PATHS)  # warm-up pass
    (res_a, wall_a), launches_a = counted(lambda: drive_paths(fa, PATHS))
    check_counts(launches_a, EXPECTED_LAUNCHES, "fact-append path, queries")
    check_agree(res_a, res_a["cached"], ("cached_warm", "cold", "mega"),
                "fact-append")
    check_agree(res_a, rebuilt_answers(fa, lambda e: None),
                ("cached",), "fact-append against the rebuilt engine")
    host = {c: fa.tables["lineorder"][c][:fa.tables["lineorder"].n_rows]
            .cpu().numpy().astype(np.int64)
            for c in ("orderdate", "discount", "quantity", "extendedprice",
                      "partkey", "suppkey", "revenue")}
    check_numpy(res_a["cached"], fa, None, "after the appends")
    log(f"[agree] after {n_appends} appends: all {len(names)} queries: "
        "cached == cold == mega == an engine rebuilt on the trimmed "
        "tables, bit for bit")
    n_phys = fa.tables["lineorder"].n_physical
    for dim, index in fa.indexes.items():
        tbl = index.table
        fk = fa.tables["lineorder"][FACT_FK[dim]]
        pred = slot_predicate(tbl, SSB_QUERIES[FILTER_QUERY[dim]]
                              .dim_filters[dim](fa.tables[dim]))
        check_probe_kernel("probe_filter_rows",
                           (tbl.keys, tbl.values, pred,
                            encode(index.dictionary, fk), tbl.hash_mode),
                           (3,), dim, 2 * tbl.bucket_width + 4, timed=False)
    log(f"[parity] probe_filter_rows on every dimension's {n_phys} padded "
        "probes: bit-identical")
    check_fused(fa, "padded")

    # the same appends on a stream engine and on one with live deltas
    st = SSBEngine(tables, policy=ExecutionPolicy(schedule="stream"))
    st.warm_cache()
    append_all(st, batches, EXPECTED_APPEND_STREAM, "stream")
    check_padding(st, "stream engine")
    (res_st, _), launches_st = counted(
        lambda: drive_paths(st, ("cached", "cold")))
    check_counts(launches_st, EXPECTED_STREAM, "stream, after appends")
    check_agree(res_st, res_a["cached"], ("cached", "cold"),
                "stream after appends")
    del st, res_st
    torch.cuda.empty_cache()
    # a forced hot/cold engine: the tail's cold stream is clamped to the
    # tail (tail_lookup), so an append is O(tail) here too; per append
    # and dimension, the hot table's probe and the cold remainder's
    hc = SSBEngine(tables, policy=ExecutionPolicy(schedule="hot_cold"))
    hc.warm_cache()
    want_hc = dict(_ZERO, probe_rows=sum(1 + (not p.full_map)
                                         for p in hc.plans.values()))
    _, hc_ms = append_all(hc, batches, want_hc, "hot_cold")
    check_padding(hc, "hot_cold engine")
    (res_hc, _), launches_hc = counted(
        lambda: drive_paths(hc, ("cached", "cold")))
    check_counts(launches_hc, hot_cold_launches(hc.plans),
                 "hot_cold, after appends")
    check_agree(res_hc, res_a["cached"], ("cached", "cold"),
                "hot_cold after appends")
    del hc, res_hc
    torch.cuda.empty_cache()
    lv = SSBEngine(own_dims())
    replay_mutations(lv)
    lv.warm_cache()
    append_all(lv, batches, EXPECTED_APPEND, "live-delta")
    check_padding(lv, "live-delta engine")
    drive_paths(lv, PATHS)  # warm-up pass
    (res_lv, wall_lv), launches_lv = counted(lambda: drive_paths(lv, PATHS))
    check_counts(launches_lv, EXPECTED_LIVE, "live deltas, after appends")
    check_agree(res_lv, res_lv["cached"], ("cached_warm", "cold", "mega"),
                "live deltas after appends")
    check_agree(res_lv, rebuilt_answers(lv, replay_dim_ops),
                ("cached",), "live deltas against the rebuilt engine")
    check_numpy(res_lv["cached"], lv, key_row, "live deltas, appends")
    log(f"[agree] stream, hot_cold and live-delta engines after the "
        f"appends: all {len(names)} queries equal the gathered engine's "
        "(stream, hot_cold) and a rebuilt engine's with the same dimension "
        "ops (live), bit for bit")
    for dim in DIM_PK:
        idx = effective_index(lv.indexes[dim])
        tbl, dl = idx.table, idx.delta
        fk = lv.tables["lineorder"][FACT_FK[dim]]
        dmask = SSB_QUERIES[FILTER_QUERY[dim]].dim_filters[dim](
            lv.tables[dim])
        check_probe_kernel("probe_filter_rows_delta",
                           (tbl.keys, tbl.values, slot_predicate(tbl, dmask),
                            encode(idx.dictionary, fk), tbl.hash_mode,
                            dl.keys, delta_slot_words(dl, dmask), fk,
                            dl.hash_mode), (3, 7), dim,
                           2 * tbl.bucket_width + 2 * dl.bucket_width + 8,
                           timed=False)
    log(f"[parity] probe_filter_rows_delta on every dimension's {n_phys} "
        "padded probes (EMPTY_KEY raw keys): bit-identical")
    check_fused(lv, "padded, live deltas")
    peak_append = torch.cuda.max_memory_allocated()
    append_summary = {
        "append_ms": append_ms, "reprobe_ms": reprobe_ms, "grew": grew[0],
        "hot_cold_ms": hc_ms, "split": split,
        "wall": wall_a, "wall_live": wall_lv, "peak": peak_append,
        "n_rows": fa.tables["lineorder"].n_rows, "n_physical": n_phys}
    del fa, lv, res_a, res_lv, batches, host
    torch.cuda.empty_cache()

    # -- 7. skew path ---------------------------------------------------------------
    dev = engine.device
    t0 = time.perf_counter()
    sidx = build_dim_index(torch.arange(SKEW_KEYS, dtype=torch.int32,
                                        device=dev))
    sync()
    log(f"[skew] dimension: {SKEW_KEYS} keys, {sidx.table.num_buckets}x"
        f"{sidx.table.bucket_width} buckets, built in "
        f"{time.perf_counter() - t0:.3f} s; {SKEW_PROBES} Zipf probes per s")
    cwm = KERNEL_REGISTRY["coalesce_window_mask"]

    def window_plain(keys):
        """The plain window mask in chunks, each with the WINDOW-1 keys
        before it, so that chunk edges see what the stream saw."""
        out = []
        for lo in range(0, keys.shape[0], CHUNK):
            pre = min(lo, WINDOW - 1)
            part = cwm.plain_fn(keys[lo - pre:lo + CHUNK], window=WINDOW)
            out.append(part[pre:])
        return torch.cat(out)

    def zipf_on_card(n_keys, size, zs, seed):
        """``zipf_sample``'s keys with its inverse-CDF search run on the
        card: the same generator calls in the same order (uniform draws,
        then the rank permutation), so the same keys.  The host's search
        of 60M draws in a 2M-entry CDF takes tens of seconds at s <= 0.5."""
        rng = np.random.default_rng(seed)
        cdf = zipf_weights(n_keys, zs).cumsum()
        cdf /= cdf[-1]
        u = torch.from_numpy(rng.random(size)).to(dev)
        idx = torch.searchsorted(torch.from_numpy(cdf).to(dev), u,
                                 right=True).to(torch.int32)
        perm = torch.from_numpy(rng.permutation(n_keys).astype(np.int32))
        return perm.to(dev)[idx.long()]

    skew_launches = dict(_ZERO)
    for zs in ZIPF_S:
        small = 1 << 20
        if not torch.equal(zipf_on_card(SKEW_KEYS, small, zs, 7).cpu(),
                           torch.from_numpy(zipf_sample(SKEW_KEYS, small, zs,
                                                        seed=7))):
            raise AssertionError(f"card-side Zipf draws differ from "
                                 f"zipf_sample at s={zs}")
        t0 = time.perf_counter()
        keys = zipf_on_card(SKEW_KEYS, SKEW_PROBES, zs, 7)
        sync()
        t_sample = time.perf_counter() - t0
        t0 = time.perf_counter()
        stats = measure_skew(keys)
        t_measure = time.perf_counter() - t0
        plan = plan_probe(stats, bucket_width=sidx.table.bucket_width,
                          backend="cuda", code_space=SKEW_KEYS,
                          hash_mode=sidx.table.hash_mode, force="hot_cold")
        hot = encode(sidx.dictionary, torch.as_tensor(
            top_keys(keys, plan.hot_entries), device=dev))
        ht = build_hot_table(sidx.table, hot, plan.hot_slots,
                             probe_fn=probe_table)
        cold = SKEW_PROBES - int(hot_hit_count(
            sidx.table, ht, encode(sidx.dictionary, keys)))
        plan = refine_plan(plan, cold, SKEW_PROBES)
        del ht

        def probe_with(sched, keys=keys, plan=plan, hot=hot):
            return lookup(sidx, keys, impl="cuda", schedule=sched,
                          plan=plan, hot_codes=hot)

        def skew_pass():
            return ({sc: pack_words(probe_with(sc)) for sc in SCHEDULES},
                    cwm.fn(keys, window=WINDOW))

        (words, mask), got = counted(skew_pass)
        check_counts(got, EXPECTED_SKEW, f"skew path s={zs}")
        for k, v in got.items():
            skew_launches[k] += v
        for sc in SCHEDULES[1:]:
            if not torch.equal(words[sc], words["gathered"]):
                raise AssertionError(f"skew s={zs}: {sc} words differ from "
                                     "gathered")
        e = max_err(mask, window_plain(keys))
        err["coalesce_window_mask"] = max(err["coalesce_window_mask"], e)
        if e:
            raise AssertionError(f"coalesce_window_mask at s={zs} differs "
                                 f"from its plain version by {e}")
        hits = int(words["gathered"].ne(-2).sum())
        del words
        ms = {sc: event_ms(lambda sc=sc: probe_with(sc), SKEW_REPS)
              for sc in SCHEDULES}
        ms["coalesce_window_mask"] = event_ms(
            lambda: cwm.fn(keys, window=WINDOW), KERNEL_REPS)
        share = int(mask.sum()) / SKEW_PROBES
        log(f"[skew] s={zs}: sampled in {t_sample:.2f} s (the card-side "
            f"draws equal zipf_sample's at {small} keys), measure_skew "
            f"{t_measure:.3f} s: distinct {stats.distinct}, dup factor "
            f"{stats.dup_factor:.3f}, max share {stats.max_share:.6f}; "
            f"hot_cold plan {plan.hot_entries} entries / {plan.hot_slots} "
            f"slots, cold {cold} of capacity {plan.cold_capacity}; "
            f"{hits} hits; four schedules bit-identical; window {WINDOW} "
            f"filters {share:.6f} of the probes (bit-identical to its plain "
            f"version); device ms: {json.dumps({k: round(v, 4) for k, v in ms.items()})}")
        if zs == TIMED_S:
            moved = nbytes(keys) + SKEW_PROBES  # keys in, one byte out
            b_ms, b_by = bound(moved, SKEW_PROBES * (WINDOW - 1))
            rows["coalesce_window_mask"] = {
                "shape": f"Zipf({zs}) stream of {SKEW_PROBES} keys, window "
                         f"{WINDOW}", "bytes": moved,
                "ms": ms["coalesce_window_mask"],
                "plain_ms": event_ms(lambda: window_plain(keys), PLAIN_REPS),
                "bound_ms": b_ms, "bound_by": b_by}
        del keys, mask, hot
        torch.cuda.empty_cache()
    if skew_launches["coalesce_window_mask"] != len(ZIPF_S):
        raise AssertionError("the skew path did not run the window kernel")

    # -- 7b. probe_rows and coalesce_window_mask at their edge cases ----------
    # last of the checks, so that every phase before allocates as it would
    # without it (a table's timings depend on where its planes land)
    def edge_cases():
        """``probe_rows`` and ``coalesce_window_mask`` against their plain
        versions where their indexing changes."""
        gen = torch.Generator(device="cuda")
        gen.manual_seed(args.seed + 2)

        def dup_planes(n, w, mode):
            """A table of ``n`` random keys where a fifth of the lanes after
            the first repeat their bucket's first key (a probe sums them)."""
            keys = torch.randperm(4 * n, generator=gen,
                                  device="cuda")[:n].int()
            tbl = build_table(keys, torch.randint(0, 1 << 20, (n,),
                                                  generator=gen,
                                                  device="cuda",
                                                  dtype=torch.int32),
                              num_buckets=suggest_num_buckets(n, w),
                              bucket_width=w, hash_mode=mode)
            tk = tbl.keys
            dup = (torch.rand(tk.shape, generator=gen, device="cuda") < 0.2) \
                & (tk[:, :1] != EMPTY_KEY)
            dup[:, 0] = False
            return (torch.where(dup, tk[:, :1].expand_as(tk), tk).contiguous(),
                    tbl.values, keys)

        in_smem = set()
        for w in (4, 8, 16, 32, 64, 128):
            for mode in ("identity", "fibonacci"):
                for n in (500, 20_000):
                    tk, tv, keys = dup_planes(n, w, mode)
                    in_smem.add(2 * tk.numel() * 4 <= 96 << 10)
                    probes = keys[torch.randint(0, n, ((1 << 20) + 7,),
                                                generator=gen, device="cuda")]
                    probes[::7] = -probes[::7] - 1
                    probes[::11] = EMPTY_KEY
                    for sl in (slice(0, 0), slice(0, 1), slice(0, 1283),
                               slice(None), slice(1, None), slice(3, 1286)):
                        hold("probe_rows", (tk, tv, probes[sl], mode), {},
                             f"W={w} {mode}, {n} keys, probes[{sl.start}:"
                             f"{sl.stop}]")
        if in_smem != {True, False}:
            raise AssertionError("the edge cases missed a probe_rows path")
        log("[parity] probe_rows at W = 4..128, both hash modes, planes in "
            "shared memory and not, duplicate keys in a bucket, EMPTY_KEY "
            "probes, 0 / 1 / 1283 / 2^20+7 probes and unaligned slices: "
            "bit-identical")
        for window in (2, 8, 17, 32):
            alphabet = torch.tensor([EMPTY_KEY, -1, *range(window)],
                                    dtype=torch.int32, device="cuda")
            for m in (0, 1, window - 2, 15, 16, 17, 511, 512, 513, 514, 515,
                      3 * 512 + 7, (1 << 20) + 5):
                base = alphabet[torch.randint(0, alphabet.numel(), (m + 3,),
                                              generator=gen, device="cuda")]
                for off in range(4):
                    hold("coalesce_window_mask", (base[off:off + m],),
                         {"window": window}, f"window {window}, {m} keys "
                         f"from offset {off}")
        log("[parity] coalesce_window_mask at windows 2, 8, 17, 32, every "
            "length where its split changes, keys 0-3 past a 16-byte "
            "boundary, EMPTY_KEY and NO_CODE among them: bit-identical")

    edge_cases()

    # the gathered schedule's entry on part's probes, hash and unpacking
    # included, by the host clock
    tbl = engine.indexes[TIMED_DIM].table
    codes = encode(engine.indexes[TIMED_DIM].dictionary,
                   fact_cols[FACT_FK[TIMED_DIM]])
    probe_table(tbl, codes)
    secs = [timed_call(lambda: probe_table(tbl, codes))
            for _ in range(OPS_REPS)]
    log(f"[ops] probe_table on {TIMED_DIM} ({n_fact} probes, table "
        f"{tuple(tbl.keys.shape)}; host clock ending in synchronize): ms "
        f"per call {json.dumps([round(x * 1e3, 4) for x in secs])}, min "
        f"{min(secs) * 1e3:.4f}")
    del tbl, codes

    # -- 8. numbers ---------------------------------------------------------------
    log(f"[memory] resident before the main path (tables, indexes): "
        f"{resident} bytes; peak allocated over it: {peak} bytes "
        f"({peak / 2**30:.3f} GiB); peak over the mutation phase: "
        f"{peak_mut} bytes ({peak_mut / 2**30:.3f} GiB)")

    def log_walls(label, wall, paths):
        if "cached_suite" in wall:
            log(f"[wall] {label} cached run_all suite (4 probes + 13 tails): "
                f"{wall['cached_suite'] * 1e3:.3f} ms")
        if "torch_suite" in wall:
            log(f"[wall] {label} torch twin cached run_all suite: "
                f"{wall['torch_suite'] * 1e3:.3f} ms")
        for path in paths:
            per = {q: round(wall[path][q] * 1e3, 3) for q in names}
            log(f"[wall] {label} {path} ms per query: {json.dumps(per)}; "
                f"total {sum(wall[path].values()) * 1e3:.3f} ms")

    log_walls("static", wall, ("cached_warm", "cold", "mega", "baseline"))
    log_walls("stream", wall_s, ("cold",))
    for sched, w in wall_sched.items():
        log_walls(sched, w, ("cold",))
    log_walls("live-delta", wall_live, ("cached_warm", "cold", "mega"))
    log_walls("compacted", wall_c, ("cached_warm", "cold", "mega"))
    a = append_summary
    med = {k: float(np.median(a[k][APPEND_WARMUP:]))
           for k in ("append_ms", "reprobe_ms")}
    log(f"[append] {smi}: ms per append_fact_rows of {n_batch} rows "
        f"(host clock ending in synchronize): "
        f"{json.dumps([round(x, 3) for x in a['append_ms']])}; the "
        f"capacity growth (append {a['grew']}): "
        f"{a['append_ms'][a['grew']]:.3f} ms")
    log(f"[append] {smi}: ms per append_fact_rows(extend_cache=False) + "
        f"warm_cache() on a twin engine: "
        f"{json.dumps([round(x, 3) for x in a['reprobe_ms']])}")
    log(f"[append] {smi}: median of the {APPEND_TIMED} timed appends: tail "
        f"extend {med['append_ms']:.3f} ms, reprobe {med['reprobe_ms']:.3f} "
        f"ms ({med['reprobe_ms'] / med['append_ms']:.2f}x); after the "
        f"appends {a['n_rows']} logical rows in {a['n_physical']} physical")
    log(f"[append] {smi}: ms per append_fact_rows on a forced hot_cold "
        f"engine: {json.dumps([round(x, 3) for x in a['hot_cold_ms']])}; "
        f"median of the timed {np.median(a['hot_cold_ms'][APPEND_WARMUP:]):.3f}"
        " ms")
    sp = a["split"]
    log(f"[append-split] {smi}: device ms per dimension (CUDA events, "
        f"{KERNEL_REPS} reps), tail_lookup of the {bp}-row tail: "
        f"{json.dumps({d: round(v, 4) for d, v in sp['lookup'].items()})}; "
        f"extend_cached_probe (lookup + splice): "
        f"{json.dumps({d: round(v, 4) for d, v in sp['extend'].items()})}, "
        f"sum {sum(sp['extend'].values()):.4f}")
    log(f"[append-split] {smi}: host clock ms ending in synchronize: the "
        f"four extensions {json.dumps([round(x, 3) for x in sp['extend_wall']])}; "
        f"validating ten columns {json.dumps([round(x, 3) for x in sp['validate']])}; "
        f"padding them and copying to the card "
        f"{json.dumps([round(x, 3) for x in sp['pad_copy']])}; "
        f"Table.append_tail in place "
        f"{json.dumps([round(x, 3) for x in sp['in_place']])}; with a "
        f"capacity growth (the first after torch.cuda.empty_cache()) "
        f"{json.dumps([round(x, 3) for x in sp['grow']])}; measure_skew of "
        f"the four FK columns over {a['n_rows']} rows "
        f"{json.dumps([round(x, 3) for x in sp['measure_skew']])}")
    for label, w in (("before the appends (60M unpadded rows)", wall),
                     ("after the appends (padded)", a["wall"]),
                     ("after the appends, live deltas", a["wall_live"])):
        log(f"[append-wall] {label}: cached run_all suite "
            f"{w['cached_suite'] * 1e3:.3f} ms, cached_warm "
            f"{sum(w['cached_warm'].values()) * 1e3:.3f} ms, cold "
            f"{sum(w['cold'].values()) * 1e3:.3f} ms, mega "
            f"{sum(w['mega'].values()) * 1e3:.3f} ms (13 queries)")
    log(f"[memory] peak allocated over the fact-append phase: {a['peak']} "
        f"bytes ({a['peak'] / 2**30:.3f} GiB)")
    log(f"[ingest] ms per call (ops per batch): {json.dumps(ingest_ms)}")
    log(f"[compact] ms per call: {json.dumps(compact_ms)}")

    # launches per pass by dimension: a filter kernel per filtered probe of
    # the 13 cold queries; probe_rows once per dimension on the cached path
    # and per unfiltered cold probe
    filtered = {d: sum(d in SSB_QUERIES[q].dim_filters for q in names)
                for d in DIM_PK}
    if sum(filtered.values()) != EXPECTED_LAUNCHES["probe_filter_rows"]:
        raise AssertionError(f"filtered probes by dimension {filtered}")
    # the stream schedule makes the probes the gathered one makes with
    # probe_rows
    unfiltered_probes = {d: 1 + unfiltered.count(d) for d in DIM_PK}
    if sum(unfiltered_probes.values()) != \
            EXPECTED_STREAM["bucket_probe_stream"]:
        raise AssertionError(f"stream probes by dimension "
                             f"{unfiltered_probes}")
    by_dim = {"probe_rows": unfiltered_probes,
              "bucket_probe_stream": unfiltered_probes,
              "probe_filter_rows": filtered,
              "probe_filter_rows_delta": filtered}
    for name, dims in per_dim.items():
        for dim, r in dims.items():
            n = by_dim[name][dim]
            log(f"[kernel-dim] {name} on {dim} (table {r['table']}, "
                f"{n_fact} probes): {r['ms']:.4f} ms/launch, moves "
                f"{r['bytes']} bytes, bound {r['bound_ms']:.4f} ms; "
                f"{n} launches per pass, launches x gap "
                f"{n * (r['ms'] - r['bound_ms']):.4f} ms")
    log(f"[kernel] pack_bits ms per launch on each predicate plane: "
        f"{json.dumps({d: round(v, 4) for d, v in pack_ms.items()})}")
    for name, r in rows.items():
        log(f"[kernel] {name} at {r['shape']}: {r['ms']:.4f} ms/launch "
            f"(plain {r['plain_ms']:.4f} ms), moves {r['bytes']} bytes, "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
            f"({r['bound_ms'] / r['ms'] * 100:.1f}% of bound)")
    # each kernel's launches on the path that drives it
    path_launches = dict(launches,
                         bucket_probe_stream=launches_s["bucket_probe_stream"],
                         probe_filter_rows_delta=launches_live[
                             "probe_filter_rows_delta"],
                         coalesce_window_mask=skew_launches[
                             "coalesce_window_mask"])
    log(f"[script] {time.perf_counter() - t_script:.1f} s after the device "
        "query")

    table = {"kernels": [
        {"name": name, "route": "cuda",
         "source": KERNEL_REGISTRY[name].source,
         "replaces": KERNEL_REGISTRY[name].replaces,
         "launches": path_launches[name], "max_abs_err": err[name],
         "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"],
         "bound_ms": rows[name]["bound_ms"],
         "bound_by": rows[name]["bound_by"], "library_ms": None}
        for name in KERNEL_REGISTRY]}
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
