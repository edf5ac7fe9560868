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
3c. Calibration (``[calib]`` lines, beside the constants of the cost
   model's ``"cuda"`` entry, ``core/costmodel.py``): 60M random 4-byte
   reads of a 512 MiB and of a 16 MiB table (ns per byte of the 32-byte
   sectors they move), the L2 size, ``probe_rows`` on part's probes per
   probe per lane, a stable ``torch.sort`` of 60M int32 keys per element
   per log2, an int32 elementwise pass over 60M rows, and the host-clock
   cost of one small launch.
4. Main path: ``generate_ssb(sf)`` -> ``SSBEngine(tables)`` (the default
   policy, ``schedule="auto"`` and ``fusion="auto"``: its plans printed,
   gathered on every dimension), then the 13 queries through (a) ``run_all(fusion="composed")`` on the probe cache,
   (b) cold ``run(q, use_cache=False)``, (c) ``run(q, fusion="mega")`` and
   (d) ``mode="baseline"``.  All four must agree, Q1.1 and Q2.1 must match
   a numpy computation on the host arrays, and every kernel's launch count
   over this run must equal the path's fixed count.  ``[plan]``: on a
   warm cache ``run_all(fusion="mega")`` and ``"composed"`` are timed;
   ``plan_query``'s pick must be within 10% of the faster.
5. Stream path: an engine with ``schedule="stream"`` on the same indexes
   runs the cached and cold paths; its 13 answers must equal phase 4's and
   its launches the path's fixed count.  Then the forced skew-aware
   schedules: an engine with ``schedule="auto"`` (priced on the card's
   entry: gathered on every dimension) and engines with
   ``schedule="deduped"`` and ``"hot_cold"`` on the same indexes print
   each dimension's plan, run the cached and cold paths, give phase 4's
   answers and the launch counts their plans fix.
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
   fixed counts.  An engine taking the same ops with ``auto_compact=True``
   (its ``CompactionPlan`` printed per ingest) must answer as the
   ``auto_compact=False`` one.  Then every dimension is compacted and the
   same checks run again, with the same answers; ``[plan]``: each
   dimension's overlay and merge estimates beside the plain overlay's
   device time and the ``compact`` wall.
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
   ``torch.cuda.empty_cache()``), and the skew re-measure; ``[plan]``:
   each dimension's ``plan_fact_append`` estimates beside its tail
   extension and a reprobe of the padded column (the plan must extend,
   and the extension be the faster).  A twin takes
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
6c. Snapshots and serving: a fresh gathered engine on phase 4's tables
   takes ``warm_cache()`` and a snapshot S0, then on the head two
   ``append_fact_rows`` of 1% of the fact table (seed+3; the first grows
   the capacity, the second writes in place: S0 pins an older
   generation), deletes and upserts of 0.5% of part's and customer's keys
   and ``compact("part")`` (the swap flavor: S0 pins part's planes,
   ``pin_copies`` +1, S0's planes unchanged).  S0's 13 answers, cached,
   cold and mega, equal phase 4's; the head's and a snapshot S1's equal
   an engine rebuilt on the trimmed tables with the same dimension ops.
   An append with S1 live copies (``pin_copies`` +1, a new fact
   generation) and S1 still answers as before; after both are released
   an append writes in place (same buffers, same generation, no copy),
   and another part batch is compacted in place (same planes), again
   equal to a rebuilt engine.  ``prepare_compact``/``publish_compact``
   publishes customer's delta, and refuses supplier's after a
   conflicting ingest.  Every read's launches equal the fixed counts.
   Then a ``QueryScheduler`` serves 13 queries x 8 parameter vectors
   sampled with seed+3 through ``pump()``, once on the engine (the
   "batch" flavor: one lazy ``probe_rows`` per dimension on its pinned
   snapshot) and once on an engine with ``fusion="mega"`` (one
   ``probe_rows`` per joined dimension per dispatch), each dispatch one
   ``batched_tail`` launch on both flavors; every answer equals
   the "composed" flavor's, and Q1.1's and Q2.1's equal ``LogicalModel``
   on the host arrays.  A last pass serves the same requests while
   ``compact_in_background("customer")`` folds a fresh delta: every
   response is ok and equals the snapshot at its epoch.  Printed:
   ``[mvcc]`` (ms per ``snapshot()``, the four appends, the swap and
   in-place compactions, peak memory beside the static path's) and
   ``[serve]`` (requests per second per flavor, wall ms per dispatch at
   widths 1, 4, 8, and ``[plan]`` the dispatch estimate at widths 1 and
   8), and the phase's seconds.
6d. Maintained views: a fresh engine (its own dimension tables) at SF10
   takes ``MaintainedSuite.attach`` (its 13 answers must equal
   ``run_all``), then two 1% fact appends (a snapshot between them
   freezes the answers: they must not move and must equal the
   snapshot's ``run_all``), 0.5% deletes and upserts on part and
   customer, an ``append_rows`` of 0.5% of supplier and
   ``compact("part")`` (seed+4); after each, the suite is fresh at the
   engine's epoch and equals ``run_all(fusion="composed")``.  A
   ``table_update`` must invalidate it and ``rebuild()`` recover it.
   Then a ``QueryScheduler`` serves the 13 canonical requests and 13 x 7
   sampled ones: ``maintained_served`` must equal the canonical count,
   and every answer the composed flavor's.  ``[ivm]``: attach and rebuild
   seconds, ms per event, rows touched, and the recompute ms after it.
6e. Durability (seed+5): a fresh engine (its own dimension tables) calls
   ``persist(root, keep=2)`` (the genesis checkpoint) under a temporary
   directory (the roomier of the temporary directory and this script's
   directory; fewer free bytes than 3x the state raises), and it and a
   volatile twin take the same stream: 6 fact appends of 1%, deletes and
   upserts of 0.5% of part's and customer's keys, an ``append_rows`` of
   0.5% of supplier, ``compact("part")`` (``auto_compact=False``, so
   customer's and supplier's deltas stay live), a checkpoint forced by
   the manager, 2 more fact appends; each durable mutation is timed
   beside the twin's.  Three recoveries with ``SSBEngine.open(root,
   device="cuda")``: (a) after a clean ``close()``; on a second root whose
   log goes through a ``FailpointFS``, (c) after a kill at the middle leaf
   write of the forced checkpoint (``checkpoint_crash_sites``: the steps
   before it stay, the replay covers every record since), and then, on the
   recovered engine, (b) after a kill in mode "after" at the fsync of the
   last fact append's record (durable, never published: it replays).  Each
   time the epoch equals the surviving record count; the cached, cold and
   mega paths and a ``kernel="torch"`` engine on the recovered state
   answer the 13 queries as the volatile twin over the surviving prefix,
   bit for bit, with the fixed launches (phase 6's live counts on a
   dimension with a delta, phase 4's on one without), and
   ``probe_filter_rows_delta`` and ``fused_query`` are held against their
   plain versions on the recovered operands.  Engine (a) then takes one
   more append (logged; 4 ``probe_rows``) and answers as the twin.
   ``[durable]``: durable and volatile ms per mutation kind, WAL bytes per
   record, each checkpoint's bytes and seconds (device to host, CRC,
   writes with fsync, rename, the disk rate beside the cost model's
   constant, the engine lock's hold), each recovery's load, build and
   replay per record, the phase's seconds; ``[plan]``: the modeled
   checkpoint write and record replay beside the measured ones, and
   ``plan_checkpoint``'s decision after each publish.  The roots are
   removed at the phase's end.
6f. The sharded fact engine (seed+6): ``ShardedSSBEngine.from_streamed``
   opens SF ``--sf`` into 4 shard regions of one card
   (``make_data_mesh(4)``, chunks of 2^20 rows); the oracle is a default
   engine (CUDA kernels) on ``generate_ssb_dims`` and the host
   concatenation of the same ``stream_ssb_fact`` chunks, and an
   unsharded ``kernel="torch"`` engine takes every mutation too, for the
   timings.  The sharded engine's cached ``run_all``, cold and mega
   answers equal the oracle's bit for bit (the cached and cold paths
   launch no kernel, mega one ``fused_query`` a query, as on the
   unsharded torch engine and the snapshot);
   ``sharded_lookup`` of part's index over the 60M FKs equals
   ``lookup(impl="cuda")`` (``probe_rows``) on found and on payload
   where found.  An append of 1% + 1 rows (4 does not divide it) with
   every dimension cached extends every cached probe per shard, leaves
   dead rows, none of them found; 0.5% deletes and upserts of part's and
   customer's keys (live deltas), then ``compact("part")``; a snapshot
   held across one more append answers at its epoch with uniform
   stamps, a torn publish (stamps off by one) is refused and
   ``_wal_publish()`` heals it; reshard 4 -> 1 -> 2, each equal to the
   oracle, answers and ``logical_fact_columns()`` against its trimmed
   columns.  ``[shard]``: the open's seconds and rows per second, the
   suites' ms per path at 4 and 1 shards beside the unsharded torch and
   default engines, the appends' ms, the lookups' ms, the reshards'
   seconds, the phase's peak memory and seconds.
6g. LM serving (seed+7), after 7b and the ``[ops]`` timing, with
   every engine of the earlier phases freed: ``init_params`` on the card
   from the seed, Zipf(1.0) prompts over the vocabulary
   (``core.skew.zipf_sample``), ``Server(batch=8, max_seq=512,
   page_size=256).generate`` for qwen3-4b at its published config (64
   steps), mamba2-780m (128 steps) and jamba-v0.1-52b at published widths
   and one pattern repeat (8 of 32 layers; 128 steps), bf16, prompts of
   256.  Gates: the first token is a separate ``prefill``'s argmax;
   ``prefill`` with ``dedup_embed`` on and off is bit-identical, logits
   and caches; every allocated page resolves through ``PageTable.lookup``
   to its physical page and a freed sequence misses; the last decode
   step's logits lie no farther from a float32 prefill of prompt and
   generated tokens (the same weights cast up) than twice the bf16
   fresh prefill's distance plus 2^-8, and give its argmax wherever the
   top-2 margin clears twice the error; on those float32 weights, a
   decode of the same tokens from a float32 prefill of the prompt meets
   the fresh float32 prefill within atol 2e-2, rtol 1e-3.  (An MoE decode
   step of 8 tokens drops no assignment; these prefills run at the
   capacity factor that drops none either.)  Then the ten ``smoke()`` configs
   in float32: a 4-step ``generate`` and the decode replay of 16 prompt
   tokens against ``prefill`` (atol 2e-2, rtol 1e-3).  No JSPIM kernel
   may launch.  ``[lm]``: init s, prefill ms, median and p90 ms a decode
   step (CUDA events around each step), tokens/s, page lookup ms, peak.
6h. LM training (seed+8), after 6g, with no JSPIM kernel launched
   (checked 0): qwen3-4b at its published config (bf16, float32 moments,
   ``OptConfig`` defaults with the launcher's warmup) through
   ``make_train_step``: 8 steps of 8x512 ``ZipfTokenStream(zipf_s=1.1)``
   tokens in 2 microbatches, block remat; gates: every loss finite, the
   mean of the last two below the first, the peak within the card.
   Then, on the trained weights at all 36 layers, the bf16 gradient of
   one microbatch against the float32 gradient on the cast-up weights
   (cosine >= 0.99), and for qwen3-4b and mamba2-780m at published widths
   and 2 layers, one float32 sequence of 256 tokens, the card's gradient
   against the host CPU's (max |diff| / max |g| <= 1e-4 per leaf).  Last,
   mamba2-780m at its published config through the ``Trainer`` (int8
   moments, ``grad_quant_bits=8``, lr 1e-6, 12 steps of 8x512 in 2
   microbatches, checkpoints every 4, keep 2, under a directory removed
   at the end), under ``torch.use_deterministic_algorithms``: a run
   crashed by ``fail_at_step=9``, a fresh ``Trainer`` resuming from step
   8 (the restored tree equal to the saved one bit for bit, its
   parameters finite), an uninterrupted twin with one step slowed by
   ``time.sleep`` (the watchdog fires); the resumed losses, weights and
   optimizer state equal the twin's bit for bit.  ``[train]``: init s,
   ms a step by CUDA events (forward and backward per microbatch, the
   update), tokens/s, the model-FLOPs share, peak memory against the
   reckoning, the mamba2 run's host ms a step, save and restore s and
   GB/s.
6i. The mesh path of LM training (seed+9), after 6h, with no JSPIM kernel
   launched (checked 0): jamba-v0.1-52b at published widths cut to its
   first two layers (``("mamba","dense"),("mamba","moe")``, 3,734,388,992
   parameters by ``param_count``), ``moe_groups`` 4, bf16, float32
   moments, through ``Trainer(mesh=ShardMesh((2, 2, 2), ("pod", "data",
   "model")))`` under ``launch.sharding.activate``: 6 steps of 8x512
   Zipf(1.1) tokens in 2 microbatches (the Trainer's final save of the
   37 GB state is skipped; 6h checks saves).  Gates: (1) every loss
   finite, the mean of the last two below the first, ``_grouped_manual``
   reached (its calls counted); (4) ``reshard_params`` and
   ``reshard_opt_state`` onto ``(2, 2)`` ``("data", "model")`` and back:
   every placement equals the sanitized rules, the moments their
   parameters', storage and bits unchanged; (3) ``psum_compressed`` over
   "pod" of the two microbatches' gradients as the two pod regions: both
   regions equal, each 256-element block within one int8 step per
   summand of the exact sum (2 x block max / 127); (2) on one float32
   microbatch of the cast-up weights, the manual dispatch's loss and
   gradients against the grouped path (no mesh): loss within 2e-4,
   gradient max |diff| within 5e-3 and within 1e-4 of each leaf's max
   |g|.  ``[mesh]``: ms a step by CUDA events (each microbatch's forward
   and backward, the update), tokens/s, the manual and grouped MoE
   layer's forward and backward ms, the psum's ms, peaks per stage
   against the reckoning, the phase's seconds.
6j. The batched query tail (seed+10), after 6i: ``generate_ssb(30)`` on
   the card, whatever ``--sf`` is (the served cells' scale), with a warm
   probe cache.  Each query's ``batched_tail`` over 3 sampled requests
   against its plain version and the composed flavor, bit for bit; a tail
   (operands and kernel) may allocate no more above the resident memory
   than one int64 vector of the fact rows would take.  ``[tail]``: per
   query the kernel's ms, the whole tail's, the plain version's, the bytes
   (every operand once, and only the sectors the kernel must read) and
   their bound at 3.35 TB/s, the memory above the resident; then a
   ``QueryScheduler`` round of 3 requests per query: one dispatch and one
   ``batched_tail`` launch per query id, every answer the composed
   flavor's.  To try it alone: ``python -c 'import sys,torch;
   sys.path.insert(0,"src"); import chip_smoke as c;
   c.query_tails(10, c.nvidia_smi_line(), torch.device("cuda",0))'``.
   Then ``skewed_tails`` (alone: the same with ``c.skewed_tails``): the
   benchmark's two SF30 deployments drawn by its generator from one seed
   (``bench/configs/ssb_sf30.json``, uniform keys, and
   ``ssb_sf30_zipf1.json``: bounded Zipf(1.0) custkey, partkey, suppkey),
   each query's ``batched_tail`` at 1, 3 and 8 requests with the same
   constants on both, bit-identical to its plain version;
   ``[tail-zipf]``: kernel ms uniform / Zipf and their ratio, and the
   queries past 1.5x.  Then gathered, deduped and hot/cold forced in turn
   (``ExecutionPolicy(schedule=)``) on the skewed tables: ``[plan]`` per
   dimension the re-probe a snapshot makes (``lookup`` under the plan),
   its device ms, its words equal to gathered's, the plan's estimates,
   and whether gathered is within 10% of the fastest (logged, not
   raised: the CUDA planner's fixed pick is recorded here, not enforced).
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
   NO_CODE among them.  ``[plan]`` per s: the four schedules' estimates
   beside their device times; the CUDA kernels' auto pick (gathered) must
   be within 10% of the fastest measured schedule.
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
import contextlib
import dataclasses
import gc
import json
import os
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
         "coalesce_window_mask": 0, "batched_tail": 0, "pack_bits": 0,
         "pack_query_bits": 0}
EXPECTED_LAUNCHES = dict(_ZERO, probe_rows=8, probe_filter_rows=32,
                         pack_bits=32, fused_query=13, pack_query_bits=13)
EXPECTED_STREAM = dict(_ZERO, bucket_probe_stream=8, probe_filter_rows=32,
                       pack_bits=32)
EXPECTED_LIVE = dict(_ZERO, probe_rows=8, probe_filter_rows_delta=32,
                     pack_bits=64, fused_query=13, pack_query_bits=13)
# the cached and cold paths of a gathered engine; deduped makes the same
# launches (one probe_rows per unfiltered probe, of the unique keys);
# hot_cold: see hot_cold_launches
EXPECTED_CACHED_COLD = dict(_ZERO, probe_rows=8, probe_filter_rows=32,
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
# the calibration phase: random 4-byte gathers from a table past 4x the L2
# and from one inside it, a sort and an elementwise pass, each over
# lineorder's SF10 row count; a gather's time is priced per byte of the
# 32-byte sectors it moves; small launches timed by the host clock
CALIB_N = 60_000_000
CALIB_BIG_ELEMS = 128 << 20      # 512 MiB of int32
CALIB_SMALL_ELEMS = 4 << 20      # 16 MiB of int32
SECTOR_BYTES = 32
CALIB_OPS = 2000
# a [plan] decision stands if the pick's measured time is within this
# factor of the fastest measured alternative
PICK_SLACK = 1.10
# phase 6d: sampled parameter vectors per query beside the canonical one
IVM_SAMPLED = 7


# phase 6g (LM serving): the full configs served on the card, and how each
# is cut: (arch, repeats of its pattern kept or None for all, batch, prompt
# length, decode steps).  A model with Mamba layers decodes 128 steps: its
# fresh prefill of prompt + generated tokens must be a whole number of SSD
# chunks (128), as the reference's ``ssd_scan`` requires.
LM_MODELS = (("qwen3-4b", None, 8, 256, 64),
             ("mamba2-780m", None, 8, 256, 128),
             ("jamba-v0.1-52b", 1, 8, 256, 128))
LM_MAX_SEQ = 512
LM_PAGE = 256
LM_ZIPF_S = 1.0      # token frequencies of natural text: Zipf, s ~ 1
# decode against prefill in float32 (the smoke configs, and the full ones
# cast up): the reference test's tolerance (tests/test_models_smoke.py)
LM_F32_TOL = dict(atol=2e-2, rtol=1e-3)


def lm_serving(seed: int, smi: str, dev) -> dict:
    """Phase 6g: the LM serving path of the port on the card ``dev`` (see
    the module docstring).  Raises on a failed gate; returns the numbers."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, list_archs, smoke
    from repro_torch.core.skew import zipf_sample
    from repro_torch.models import decode_step, init_caches, init_params
    from repro_torch.models import prefill
    from repro_torch.models.moe import _capacity as moe_capacity
    from repro_torch.serve import Server

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("float32 products must not run in TF32")

    def sync():
        torch.cuda.synchronize()

    def host_s(fn):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t

    def same(a, b) -> bool:
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        return all(same(x, y) for x, y in zip(a, b))

    out = {}
    for arch, repeats, batch, plen, steps in LM_MODELS:
        cfg = get_config(arch)
        if repeats is not None:
            cfg = dataclasses.replace(
                cfg, n_layers=repeats * len(cfg.pattern))
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        params, init_s = host_s(lambda: init_params(cfg, seed=seed,
                                                    device=dev))
        n_params = sum(p.numel() for p in params.parameters())
        toks = zipf_sample(cfg.vocab_size, batch * plen, LM_ZIPF_S,
                           seed=seed)
        dup = toks.size / np.unique(toks).size
        prompts = torch.from_numpy(toks.reshape(batch, plen)).to(dev)
        # a short warm-up generation and page lookup (the first use of a
        # kernel loads its module), then the measured ones
        warm = Server(cfg, params, LM_MAX_SEQ, batch, LM_PAGE, device=dev)
        warm.generate(prompts, 2)
        warm.pages.lookup(torch.arange(batch), torch.zeros(batch))
        del warm
        srv = Server(cfg, params, LM_MAX_SEQ, batch, LM_PAGE, device=dev)
        step_fn, events, last = srv.serve_step, [], {}

        def timed_step(p, caches, tok, pos, step_fn=step_fn, events=events,
                       last=last):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            logits, caches = step_fn(p, caches, tok, pos)
            ev[1].record()
            events.append(ev)
            last["logits"] = logits
            return logits, caches
        srv.serve_step = timed_step
        res, gen_s = host_s(lambda: srv.generate(prompts, steps))
        step_ms = np.array([a.elapsed_time(b) for a, b in events])
        # gate: the first token is prefill's argmax
        (logits_p, caches_p), prefill_s = host_s(
            lambda: prefill(cfg, params, prompts, max_seq=LM_MAX_SEQ))
        if not torch.equal(res.tokens[:, 0], logits_p.argmax(-1)):
            raise AssertionError(f"{arch}: the first token is not prefill's "
                                 "argmax")
        peak = torch.cuda.max_memory_allocated() - resident
        # gate: the dedup embedding is an exact rewrite
        logits_nd, caches_nd = prefill(
            dataclasses.replace(cfg, dedup_embed=False), params, prompts,
            max_seq=LM_MAX_SEQ)
        if not (torch.equal(logits_nd, logits_p) and
                same(caches_nd, caches_p)):
            raise AssertionError(f"{arch}: dedup_embed on and off differ")
        del caches_p, caches_nd, logits_nd
        # gate: every allocated page resolves, a freed sequence misses
        keys = sorted(srv.pages._map)
        mp = srv.pages.max_pages_per_seq
        seqs = torch.tensor([k // mp for k in keys])
        pages = torch.tensor([k % mp for k in keys])
        (found, phys), look_dirty_s = host_s(
            lambda: srv.pages.lookup(seqs, pages))
        _, look_s = host_s(lambda: srv.pages.lookup(seqs, pages))
        if not (bool(found.all()) and phys.tolist() ==
                [srv.pages._map[k] for k in keys]):
            raise AssertionError(f"{arch}: a page does not resolve")
        n_pages = len(keys)
        srv.pages.free_seq(0)
        found, _ = srv.pages.lookup(seqs, pages)
        if found.tolist() != [bool(s) for s in seqs.tolist()]:
            raise AssertionError(f"{arch}: a freed page resolves")
        # gate: decode through the cache against a fresh prefill of the
        # prompt and the generated tokens, both held against the float32
        # result on the same weights.  A decode step of B tokens never
        # drops an MoE assignment (an expert takes at most one per token,
        # capacity >= B); the prefills run at the capacity factor that
        # drops none either (E / top_k), so all three compute one function
        same_fn = cfg
        if cfg.moe is not None:
            if moe_capacity(batch, cfg.moe) < batch:
                raise AssertionError(f"{arch}: a decode step could drop")
            same_fn = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe,
                capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
        seq = torch.cat([prompts, res.tokens], dim=1)
        fresh = prefill(same_fn, params, seq)[0]
        dec = last["logits"]
        del srv
        torch.cuda.empty_cache()
        params.float()      # in place, a leaf at a time
        cfg32 = dataclasses.replace(same_fn, dtype="float32")
        truth = prefill(cfg32, params, seq)[0]
        # gate: in float32 too, decode through the cache replays the
        # generated tokens to the fresh prefill's logits
        caches = prefill(cfg32, params, prompts, max_seq=LM_MAX_SEQ)[1]
        for i in range(steps):
            lg32, caches = decode_step(cfg32, params, caches,
                                       res.tokens[:, i:i + 1], plen + i)
        del caches, params
        torch.cuda.empty_cache()
        torch.testing.assert_close(lg32, truth, **LM_F32_TOL)
        e32 = float((lg32 - truth).abs().max())
        peak_checks = torch.cuda.max_memory_allocated() - resident
        e_pre = float((fresh - truth).abs().max())
        e_dec = float((dec - truth).abs().max())
        d_dp = float((dec - fresh).abs().max())
        bound = 2 * e_pre + 2 ** -8
        top2 = truth.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * max(e_pre, e_dec)
        agree = bool((dec.argmax(-1) == truth.argmax(-1))[clear].all())
        if e_dec > bound or not agree:
            raise AssertionError(
                f"{arch}: decode {e_dec} from the float32 logits, prefill "
                f"{e_pre} (bound {bound}); argmax where clear: {agree}")
        out[arch] = dict(
            layers=cfg.n_layers, params=n_params, init_s=init_s,
            prefill_ms=prefill_s * 1e3, step_ms=step_ms, gen_s=gen_s,
            batch=batch, plen=plen, steps=steps, dup=dup,
            look_dirty_ms=look_dirty_s * 1e3, look_ms=look_s * 1e3,
            n_pages=n_pages, peak=peak, e_pre=e_pre, e_dec=e_dec, d_dp=d_dp,
            e32=e32, peak_checks=peak_checks,
            bound=bound, scale=float(truth.abs().max()),
            clear=int(clear.sum()))
        r = out[arch]
        log(f"[lm] {smi}: {arch} ({cfg.n_layers} layers, {n_params} "
            f"parameters, param_count {cfg.param_count()}, {cfg.dtype}): init {init_s:.3f} s; Zipf({LM_ZIPF_S}) "
            f"prompts {batch}x{plen} (dup factor {dup:.3f}); prefill "
            f"{r['prefill_ms']:.3f} ms; decode {steps} steps: median "
            f"{np.median(step_ms):.3f} ms, p90 "
            f"{np.percentile(step_ms, 90):.3f} ms a step (CUDA events), "
            f"{batch / np.median(step_ms) * 1e3:.1f} tokens/s; generate "
            f"{gen_s:.3f} s, {batch * steps / gen_s:.1f} tokens/s with its "
            f"prefill; page table: {n_pages} pages, lookup "
            f"{r['look_dirty_ms']:.3f} ms with its rebuild, "
            f"{r['look_ms']:.3f} ms after; peak allocated above the "
            f"{resident} bytes resident: serving {peak} bytes "
            f"({peak / 2**30:.3f} GiB), with the checks below "
            f"{peak_checks} bytes ({peak_checks / 2**30:.3f} GiB)")
        log(f"[lm] {arch}: first token = prefill's argmax; dedup_embed on "
            f"= off bit for bit; every page resolves, a freed sequence "
            f"misses; last decode step against the float32 prefill: max "
            f"|diff| {e_dec:.5f}, bf16 prefill {e_pre:.5f} (bound 2x + 2^-8 "
            f"= {bound:.5f}), decode against bf16 prefill {d_dp:.5f}, logits "
            f"up to {r['scale']:.3f}; argmax equal on the {r['clear']} of "
            f"{batch} rows whose top-2 margin clears twice the error; in "
            f"float32, {steps} decode steps against the fresh prefill: max "
            f"|diff| {e32:.7f} (atol {LM_F32_TOL['atol']}, rtol "
            f"{LM_F32_TOL['rtol']})")
        del truth, fresh, dec, res, prompts, last, lg32
        torch.cuda.empty_cache()

    # the ten smoke configs, float32: a short generation and the decode
    # replay of the prompt against prefill (xattn, the other MoEs, GeGLU)
    t0 = time.perf_counter()
    worst = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for arch in list_archs():
        cfg = smoke(arch)
        params = init_params(cfg, seed=seed, device=dev)
        tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen,
                               device=dev)
        img = (torch.randn((2, cfg.n_image_tokens, cfg.d_model),
                           generator=gen, device=dev)
               if cfg.n_image_tokens else None)
        res = Server(cfg, params, 32, 2, 8, device=dev).generate(
            tokens, 4, image_embeds=img)
        logits_p, pc = prefill(cfg, params, tokens, max_seq=24,
                               image_embeds=img)
        if not torch.equal(res.tokens[:, 0], logits_p.argmax(-1)):
            raise AssertionError(f"smoke {arch}: first token")
        caches = init_caches(cfg, 2, 24, cfg.n_image_tokens, device=dev)
        caches = [p if m == "xattn" else c
                  for (m, _), p, c in zip(cfg.pattern, pc, caches)]
        for i in range(16):
            lg, caches = decode_step(cfg, params, caches,
                                     tokens[:, i:i + 1], i)
        torch.testing.assert_close(lg, logits_p, **LM_F32_TOL)
        worst[arch] = float((lg - logits_p).abs().max())
    log(f"[lm] the ten smoke configs (float32): Server.generate of 4 steps, "
        f"first token = prefill's argmax, decode replay of 16 prompt tokens "
        f"against prefill within atol {LM_F32_TOL['atol']} / rtol "
        f"{LM_F32_TOL['rtol']}: max |diff| "
        f"{json.dumps({k: round(v, 7) for k, v in worst.items()})}; "
        f"{time.perf_counter() - t0:.1f} s")
    out["smoke"] = worst
    return out


# phase 6h (LM training): qwen3-4b's train step at its published config
# (steps, global batch, sequence, microbatches), the gradient checks, and
# mamba2-780m through the Trainer: a run crashed at TRAIN_FAIL_AT, a fresh
# Trainer resuming it, an uninterrupted twin
TRAIN_QWEN = ("qwen3-4b", 8, 8, 512, 2)
TRAIN_MAMBA = ("mamba2-780m", 12, 8, 512, 2)
TRAIN_CKPT_EVERY = 4
TRAIN_FAIL_AT = 9
TRAIN_ZIPF_S = 1.1
# int8 moments diverge in both packages: a v block's small entries round
# to 0 and Adam divides by eps, a step of ~1e4-1e6 x lr (ROADMAP Queue 3).
# At this rate those steps stay small and the state finite, so that the
# resume gate compares finite values
TRAIN_MAMBA_LR = 1e-6
# the gradient checks: the card's float32 gradient against the host CPU's
# at published widths and 2 layers, one sequence of 256 tokens (max |diff|
# over the leaf's max |g|); the bf16 gradient's cosine with the float32
# gradient on the cast-up weights
TRAIN_CPU_LAYERS = 2
TRAIN_CPU_TOKENS = 256
TRAIN_CPU_TOL = 1e-4
TRAIN_COS_MIN = 0.99
# H100 SXM data sheet: dense bf16 tensor-core rate (for the model-FLOPs
# share, information only)
BF16_FLOPS_PER_S = 989e12


def _event():
    import torch
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def _grads_of(params) -> dict:
    import torch
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            for n, p in params.named_parameters()}


def _backward(cfg, params, tok, lab) -> float:
    from repro_torch.models import loss_fn
    for p in params.parameters():
        p.grad = None
    loss = loss_fn(cfg, params, tok, lab)
    loss.backward()
    return float(loss.detach())


def _bits(t):
    import torch
    return t.detach().reshape(-1).view(torch.uint8)


@contextlib.contextmanager
def _marking(marks: list):
    """CUDA events at each microbatch's start and around the update,
    recorded by the train step's own calls."""
    import repro_torch.train.step as step_mod
    orig_loss, orig_apply = step_mod.loss_fn, step_mod.apply_updates

    def loss_marked(*a, **k):
        marks.append(_event())
        return orig_loss(*a, **k)

    def apply_marked(*a, **k):
        marks.append(_event())
        res = orig_apply(*a, **k)
        marks.append(_event())
        return res
    step_mod.loss_fn, step_mod.apply_updates = loss_marked, apply_marked
    try:
        yield
    finally:
        step_mod.loss_fn, step_mod.apply_updates = orig_loss, orig_apply


def _split(marks: list, mb: int) -> list[dict]:
    """Per step: ms of each microbatch's forward and backward, of the
    update, and their sum."""
    out = []
    for i in range(0, len(marks), mb + 2):
        m = marks[i:i + mb + 2]
        ms = [a.elapsed_time(z) for a, z in zip(m, m[1:])]
        out.append({"micro_ms": ms[:mb], "update_ms": ms[mb],
                    "ms": sum(ms)})
    return out


def lm_training(seed: int, smi: str, dev) -> dict:
    """Phase 6h: the LM training path of the port on the card ``dev`` (see
    the module docstring).  Raises on a failed gate; returns the numbers."""
    import shutil
    import statistics
    import tempfile
    import warnings

    import numpy as np
    import torch

    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.configs import get_config
    from repro_torch.data import ZipfTokenStream, shard_batch
    from repro_torch.models import ParamTree, init_params
    from repro_torch.optim import OptConfig
    from repro_torch.optim.adamw import tree_map
    from repro_torch.train import (Trainer, TrainerConfig, init_train_state,
                                   make_train_step)

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("float32 products must not run in TF32")

    def sync():
        torch.cuda.synchronize()

    def host_s(fn):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t

    event, grads_of, backward, bits, marking, split = (
        _event, _grads_of, _backward, _bits, _marking, _split)

    out = {}
    t_phase = time.perf_counter()
    total_mem = torch.cuda.get_device_properties(dev).total_memory

    # -- qwen3-4b: the train step at its published config ---------------------
    arch, steps, batch, seq, mb = TRAIN_QWEN
    cfg = get_config(arch)
    opt = OptConfig(warmup_steps=max(2, steps // 20), total_steps=steps)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    (params, state), init_s = host_s(
        lambda: init_train_state(cfg, opt, seed, dev))
    n = sum(p.numel() for p in params.parameters())
    held = torch.cuda.memory_allocated() - resident
    reckon = {"weights": 2 * n, "accumulator": 4 * n, "moments": 8 * n}
    n_embed = cfg.vocab_size * cfg.d_model
    stream = ZipfTokenStream(cfg.vocab_size, seq, zipf_s=TRAIN_ZIPF_S,
                             seed=seed)
    step_fn = make_train_step(cfg, opt)
    marks: list = []
    losses, rows = [], []
    with marking(marks):
        for step in range(steps):
            b = shard_batch(stream.batch(step, batch), None, mb, device=dev)
            marks.clear()
            t = time.perf_counter()
            params, state, met = step_fn(params, state, b)
            loss = float(met["loss"])
            wall = time.perf_counter() - t
            rows.append(dict(split(marks, mb)[0], loss=loss,
                             wall_ms=wall * 1e3,
                             grad_norm=float(met["grad_norm"]),
                             lr=float(met["lr"])))
            losses.append(loss)
    peak = torch.cuda.max_memory_allocated() - resident
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{arch}: a loss is not finite: {losses}")
    if not np.mean(losses[-2:]) < losses[0]:
        raise AssertionError(f"{arch}: the loss did not fall: {losses}")
    if peak > total_mem:
        raise AssertionError(f"{arch}: peak {peak} past the card's "
                             f"{total_mem}")
    tokens = batch * seq
    flops = (6 * (n - n_embed) * tokens + 6 * cfg.n_layers * seq
             * cfg.n_heads * cfg.resolved_head_dim * tokens)
    med = float(np.median([r["ms"] for r in rows[1:]]))
    out[arch] = dict(params=n, init_s=init_s, rows=rows, peak=peak,
                     held=held, reckon=reckon, flops=flops, median_ms=med)
    log(f"[train] {smi}: {arch} ({cfg.n_layers} layers, {n} parameters, "
        f"{cfg.dtype}, remat {cfg.remat}): init_train_state {init_s:.3f} s, "
        f"{held} bytes held after it (reckoned: weights "
        f"{reckon['weights']}, moments {reckon['moments']}); {steps} steps "
        f"of {batch}x{seq} Zipf({TRAIN_ZIPF_S}) tokens in {mb} "
        f"microbatches, float32 moments, warmup {opt.warmup_steps}")
    for i, r in enumerate(rows):
        log(f"[train] {smi}: {arch} step {i}: loss {r['loss']:.5f}, "
            f"grad_norm {r['grad_norm']:.5f}, lr {r['lr']:.3e}; "
            f"{r['ms']:.3f} ms by CUDA events (fwd+bwd per microbatch "
            f"{json.dumps([round(x, 3) for x in r['micro_ms']])}, update "
            f"{r['update_ms']:.3f}), host {r['wall_ms']:.3f} ms")
    log(f"[train] {smi}: {arch}: median of steps 1-{steps - 1} {med:.3f} ms "
        f"a step, {tokens / med * 1e3:.1f} tokens/s; model FLOPs a step "
        f"{flops:.4e} (6 x {n - n_embed} non-embedding parameters x "
        f"{tokens} tokens + causal attention), "
        f"{flops / (med * 1e-3) / 1e12:.1f} TFLOP/s, "
        f"{flops / (med * 1e-3) / BF16_FLOPS_PER_S * 100:.2f}% of "
        f"{BF16_FLOPS_PER_S / 1e12:.0f} (information only); peak allocated "
        f"above the {resident} bytes resident {peak} bytes "
        f"({peak / 2**30:.3f} GiB; reckoned {sum(reckon.values())} "
        f"persistent + activations + the block gradients before their "
        f"stack), card {total_mem}; mean of the last two losses "
        f"{np.mean(losses[-2:]):.5f} < first {losses[0]:.5f}")

    # -- bf16 against float32 at full depth, on the trained weights ---------
    del state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    tok = shard_batch(stream.batch(0, batch), None, mb, device=dev)
    tk, lb = tok["tokens"][0], tok["labels"][0]
    torch.cuda.reset_peak_memory_stats()
    l16 = backward(cfg, params, tk, lb)
    g16 = grads_of(params)
    for p in params.parameters():
        p.grad = None
    p32 = ParamTree(tree_map(lambda p: p.detach().float(), params.tree()))
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    l32 = backward(cfg32, p32, tk, lb)
    g32 = grads_of(p32)
    dot = n16 = n32 = 0.0
    leaf_cos = {}
    for name, a in g16.items():
        a = a.float()
        b = g32[name]
        d, x, y = (float((a * b).sum(dtype=torch.float64)),
                   float((a * a).sum(dtype=torch.float64)),
                   float((b * b).sum(dtype=torch.float64)))
        dot, n16, n32 = dot + d, n16 + x, n32 + y
        if x > 0 and y > 0:
            leaf_cos[name] = d / (x * y) ** 0.5
    cos = dot / (n16 * n32) ** 0.5
    peak_cos = torch.cuda.max_memory_allocated() - resident
    worst_leaf = min(leaf_cos, key=leaf_cos.get)
    del g16, g32, p32, params
    gc.collect()
    torch.cuda.empty_cache()
    if not cos >= TRAIN_COS_MIN:
        raise AssertionError(f"{arch}: bf16 gradient cosine {cos} with the "
                             f"float32 gradient, under {TRAIN_COS_MIN}")
    out["cos"] = dict(cos=cos, l16=l16, l32=l32, worst=worst_leaf,
                      worst_cos=leaf_cos[worst_leaf], peak=peak_cos)
    log(f"[train] {smi}: {arch} at all {cfg.n_layers} layers, the trained "
        f"weights, one microbatch ({tk.shape[0]}x{tk.shape[1]}): bf16 "
        f"gradient against float32 on the cast-up weights: cosine "
        f"{cos:.6f} over every leaf (gate >= {TRAIN_COS_MIN}); loss bf16 "
        f"{l16:.5f}, float32 {l32:.5f}; lowest leaf cosine "
        f"{leaf_cos[worst_leaf]:.6f} ({worst_leaf}); peak allocated "
        f"{peak_cos} bytes ({peak_cos / 2**30:.3f} GiB)")

    # -- the card's float32 gradient against the host CPU's ----------------
    out["cpu"] = {}
    for name in (TRAIN_QWEN[0], TRAIN_MAMBA[0]):
        c = dataclasses.replace(get_config(name), dtype="float32",
                                n_layers=TRAIN_CPU_LAYERS
                                * len(get_config(name).pattern))
        pc = init_params(c, seed + 1, dev)
        ph = ParamTree(tree_map(lambda p: p.detach().cpu(), pc.tree()))
        bt = ZipfTokenStream(c.vocab_size, TRAIN_CPU_TOKENS,
                             zipf_s=TRAIN_ZIPF_S, seed=seed).batch(0, 1)
        tk_h = torch.from_numpy(bt["tokens"])
        lb_h = torch.from_numpy(bt["labels"])
        (l_card, t_card) = host_s(lambda: backward(c, pc, tk_h.to(dev),
                                                   lb_h.to(dev)))
        t = time.perf_counter()
        l_host = backward(c, ph, tk_h, lb_h)
        t_host = time.perf_counter() - t
        g_card, g_host = grads_of(pc), grads_of(ph)
        worst, where = 0.0, None
        for leaf, gh in g_host.items():
            if not (torch.isfinite(gh).all() and
                    torch.isfinite(g_card[leaf]).all()):
                raise AssertionError(f"{name}: a gradient of {leaf} is "
                                     "not finite")
            scale = float(gh.abs().max())
            diff = float((g_card[leaf].cpu() - gh).abs().max())
            err = diff / scale if scale > 0 else diff
            if err >= worst:
                worst, where = err, leaf
        del pc, ph, g_card, g_host
        gc.collect()
        torch.cuda.empty_cache()
        if not worst <= TRAIN_CPU_TOL:
            raise AssertionError(f"{name}: the card's float32 gradient is "
                                 f"{worst} from the CPU's at {where}")
        out["cpu"][name] = dict(worst=worst, where=where, loss=l_card,
                                loss_host=l_host, card_s=t_card,
                                host_s=t_host)
        log(f"[train] {smi}: {name} at published widths, "
            f"{c.n_layers} layers, float32, one sequence of "
            f"{TRAIN_CPU_TOKENS} tokens: the card's gradient against the "
            f"host CPU's: largest per-leaf max |diff| / max |g| {worst:.3e} "
            f"({where}; gate {TRAIN_CPU_TOL}); loss card {l_card:.7f}, host "
            f"{l_host:.7f}; backward {t_card:.3f} s card, {t_host:.3f} s "
            f"host ({torch.get_num_threads()} threads)")

    # -- mamba2-780m through the Trainer: crash, resume, twin --------------
    arch, steps, batch, seq, mb = TRAIN_MAMBA
    cfg = get_config(arch)
    opt = OptConfig(lr=TRAIN_MAMBA_LR, warmup_steps=max(2, steps // 20),
                    total_steps=steps, moment_dtype="int8",
                    grad_quant_bits=8)
    spots = [tempfile.gettempdir(), str(Path(__file__).resolve().parent)]
    spot = max(spots, key=lambda p: shutil.disk_usage(p).free)
    root = tempfile.mkdtemp(prefix=".durable_train_", dir=spot)
    tc = TrainerConfig(steps=steps, global_batch=batch, microbatches=mb,
                       seq_len=seq, ckpt_every=TRAIN_CKPT_EVERY,
                       log_every=TRAIN_CKPT_EVERY,
                       ckpt_dir=os.path.join(root, "run"), keep_ckpts=2,
                       zipf_s=TRAIN_ZIPF_S, seed=seed)
    say = lambda s: log(f"[train] {smi}: {arch}: {s}")  # noqa: E731
    saves, restores, kept = [], [], {}
    prev_env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    # the NaN fill of every new tensor adds a launch to each eager op; a
    # read of memory nothing wrote would differ between the resumed run
    # and its twin all the same
    prev_fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            crashed = Trainer(cfg, opt, tc, log_fn=say, device=dev)
            free = shutil.disk_usage(root).free
            orig_save = crashed.ckpt.save

            def save(step, tree, extra=None):
                parts = {}
                _, s = host_s(lambda: orig_save(step, tree, extra,
                                                timings=parts))
                saves.append(dict(parts, step=step, s=s))
                if step == 2 * TRAIN_CKPT_EVERY:
                    kept.update((p, x.detach().clone())
                                for p, x in _flatten(tree))
            crashed.ckpt.save = save
            try:
                crashed.run(fail_at_step=TRAIN_FAIL_AT)
            except RuntimeError as e:
                if "injected failure" not in str(e):
                    raise
            else:
                raise AssertionError("the crashed run did not stop")
            crash_times = list(crashed.step_times)
            del crashed
            resumed = Trainer(cfg, opt, tc, log_fn=say, device=dev)
            restored = {}
            orig_restore = resumed.ckpt.restore_latest

            def restore(template, device=None):
                (s, tree), secs = host_s(lambda: orig_restore(template,
                                                              device))
                restores.append(dict(step=s, s=secs))
                # before the resumed steps write these leaves in place
                got = dict(_flatten(tree))
                if list(got) != list(kept):
                    raise AssertionError(f"{arch}: the restored tree's "
                                         "leaves differ from the saved's")
                bad = [p for p in kept if not torch.equal(bits(kept[p]),
                                                          bits(got[p]))]
                if bad:
                    raise AssertionError(f"{arch}: restored leaves differ "
                                         f"from the saved ones: {bad[:5]}")
                finite = all(bool(torch.isfinite(x).all())
                             for p, x in got.items()
                             if p.startswith("0.") and x.is_floating_point())
                if not finite:
                    raise AssertionError(f"{arch}: the saved parameters "
                                         "are not finite")
                return s, tree
            resumed.ckpt.restore_latest = restore
            resumed.ckpt.save = save
            res = resumed.run()
            n_bytes = sum(x.numel() * x.element_size()
                          for x in kept.values())
            del kept
            shutil.rmtree(tc.ckpt_dir)
            peak_resume = torch.cuda.max_memory_allocated() - resident
            # the uninterrupted twin; one step is slowed on the host
            twin = Trainer(cfg, opt, dataclasses.replace(
                tc, ckpt_dir=os.path.join(root, "twin"), ckpt_every=steps),
                log_fn=say, device=dev)
            orig_step, calls, slept = twin.train_step, [0], []

            def slow_step(*a, **k):
                calls[0] += 1
                if calls[0] == 8:   # 2.5x the median against a factor 2
                    pause = 1.5 * statistics.median(twin.step_times)
                    slept.append(pause)
                    time.sleep(pause)
                return orig_step(*a, **k)
            twin.train_step = slow_step
            twin_marks: list = []
            with marking(twin_marks):
                ref = twin.run()
            twin_split = split(twin_marks, mb)
        nondet = sorted({str(w.message).splitlines()[0] for w in caught
                         if "determinis" in str(w.message)})
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = prev_fill
        if prev_env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prev_env
        shutil.rmtree(root, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() - resident
    tail = ref["losses"][TRAIN_FAIL_AT - 1:]
    same_loss = np.array_equal(np.array(res["losses"]), np.array(tail),
                               equal_nan=True)
    ours = _flatten((res["params"].tree(), res["opt_state"]))
    theirs = _flatten((ref["params"].tree(), ref["opt_state"]))
    same_state = [p for (p, a), (_, b) in zip(ours, theirs)
                  if not torch.equal(bits(a), bits(b))]
    if not np.isfinite(res["losses"]).all():
        raise AssertionError(f"{arch}: a loss is not finite: {res['losses']}")
    if nondet or not same_loss or same_state:
        raise AssertionError(
            f"{arch}: the resumed run differs from the twin (losses "
            f"{res['losses']} against {tail}; leaves {same_state[:5]}); "
            f"ops without a deterministic CUDA version: {nondet}")
    if twin.straggler_events < 1:
        raise AssertionError(f"{arch}: the watchdog missed the slowed step")
    n_m = sum(p.numel() for p in ref["params"].parameters())
    twin_ms = [t * 1e3 for t in twin.step_times]
    med = float(np.median([x for i, x in enumerate(twin_ms)
                           if i not in (0, 7)]))
    out[arch] = dict(params=n_m, losses=ref["losses"], resumed=res["losses"],
                     twin_ms=twin_ms, crash_ms=[t * 1e3 for t in
                                                crash_times],
                     saves=saves, restores=restores, ckpt_bytes=n_bytes,
                     free=free, peak=peak, peak_resume=peak_resume,
                     slept=slept, stragglers=twin.straggler_events)
    del res, ref, twin, resumed
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train] {smi}: {arch} ({cfg.n_layers} layers, {n_m} parameters, "
        f"{cfg.dtype}) through the Trainer: {steps} steps of {batch}x{seq} "
        f"tokens in {mb} microbatches, int8 moments, grad_quant_bits 8, "
        f"checkpoints every {TRAIN_CKPT_EVERY} (keep 2) under {root} "
        f"({free} bytes free); losses of the twin "
        f"{json.dumps([round(x, 5) for x in out[arch]['losses']])}")
    log(f"[train] {smi}: {arch}: host ms a step (batch to float(loss)), "
        f"twin {json.dumps([round(x, 3) for x in twin_ms])}; median of "
        f"steps 1-{steps - 1} but the slowed one {med:.3f} ms, "
        f"{batch * seq / med * 1e3:.1f} "
        f"tokens/s; crashed run "
        f"{json.dumps([round(x, 3) for x in out[arch]['crash_ms']])}")
    out[arch]["split"] = twin_split
    log(f"[train] {smi}: {arch}: twin, device ms a step by CUDA events: "
        f"{json.dumps([round(r['ms'], 3) for r in twin_split])}; fwd+bwd "
        f"per microbatch, median "
        f"{np.median([x for r in twin_split for x in r['micro_ms']]):.3f}; "
        f"update (int8 moments, error feedback), median "
        f"{np.median([r['update_ms'] for r in twin_split]):.3f}")
    for s in saves:
        log(f"[train] {smi}: {arch}: save of step {s['step']}: {s['s']:.3f} "
            f"s, {s['bytes']} bytes, {s['bytes'] / s['s'] / 1e9:.3f} GB/s "
            f"(device to host {s['d2h_s']:.3f} s, CRC {s['crc_s']:.3f} s, "
            f"writes with fsync {s['write_s']:.3f} s, rename "
            f"{s['rename_s']:.3f} s)")
    for r in restores:
        log(f"[train] {smi}: {arch}: restore of step {r['step']}: "
            f"{r['s']:.3f} s, {n_bytes / r['s'] / 1e9:.3f} GB/s onto the "
            f"card")
    log(f"[train] {smi}: {arch}: the crash at step {TRAIN_FAIL_AT} resumed "
        f"from step {restores[0]['step']}; the restored tree equals the "
        f"saved one bit for bit ({n_bytes} bytes); the resumed run's "
        f"losses and final weights and optimizer state equal the twin's "
        f"bit for bit under torch.use_deterministic_algorithms (no op "
        f"without a deterministic CUDA version warned); the watchdog fired "
        f"{out[arch]['stragglers']} time(s) on the step slowed by "
        f"{json.dumps([round(x, 3) for x in slept])} s; peak allocated "
        f"above the {resident} bytes resident {peak} bytes "
        f"({peak / 2**30:.3f} GiB)")
    out["seconds"] = time.perf_counter() - t_phase
    return out


# phase 6i (the mesh path of LM training): jamba-v0.1-52b at published
# widths cut to its first two layers (the one reduction), through
# ``Trainer(mesh=)`` on a (2, 2, 2) region mesh of the card with the
# manual MoE dispatch, then the manual dispatch against the grouped path,
# the compressed psum and the reshard
MESH_ARCH = "jamba-v0.1-52b"
MESH_PATTERN = (("mamba", "dense"), ("mamba", "moe"))
MESH_PARAMS = 3_734_388_992
MESH_SHAPE = ((2, 2, 2), ("pod", "data", "model"))
MESH_SMALL = ((2, 2), ("data", "model"))
MESH_RUN = (6, 8, 512, 2)      # steps, global batch, sequence, microbatches
MESH_GROUPS = 4
# the manual dispatch against the grouped path in float32: the
# reference's gates (tests/test_distributed.py: loss 2e-4, gradient max
# |diff| 5e-3), and per leaf 1e-4 of the leaf's max |g|
MESH_LOSS_TOL, MESH_GRAD_TOL, MESH_GRAD_REL = 2e-4, 5e-3, 1e-4
# the compressed psum: each region's result within one int8 step per
# summand of the exact sum, 2 x (the block's largest |g| over the regions)
# / 127 per 256-element block; the float32 products and sums of the
# dequantize add rounding of ~2^-23 of a value, ~3e-5 of the step
MESH_PSUM_SLACK = 1e-4
MESH_LAYER_WARM, MESH_LAYER_REPS = 2, 5


def lm_mesh(seed: int, smi: str, dev) -> dict:
    """Phase 6i: the mesh path of LM training on the card ``dev`` (see the
    module docstring).  Raises on a failed gate; returns the numbers."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    import repro_torch.models.moe as moe_mod
    from repro_torch.configs import get_config
    from repro_torch.data import ZipfTokenStream, shard_batch
    from repro_torch.launch import Placement, make_host_mesh
    from repro_torch.launch.elastic import (_sanitize, reshard_opt_state,
                                           reshard_params)
    from repro_torch.launch.sharding import activate, map_tree, param_specs
    from repro_torch.models import ParamTree, init_params, loss_fn
    from repro_torch.optim import OptConfig, psum_compressed
    from repro_torch.optim.adamw import QBLOCK, tree_map
    from repro_torch.train import Trainer, TrainerConfig

    def sync():
        torch.cuda.synchronize()

    def flat(tree) -> dict:
        got = {}
        map_tree(lambda path, leaf: got.__setitem__(path, leaf), tree)
        return got

    def block_max(x: torch.Tensor) -> torch.Tensor:
        """max |x| per 256-element block of the last dim."""
        pad = (-x.shape[-1]) % QBLOCK
        x = torch.nn.functional.pad(x.abs(), (0, pad))
        return x.reshape(*x.shape[:-1], -1, QBLOCK).amax(dim=-1)

    cfg = dataclasses.replace(get_config(MESH_ARCH),
                              n_layers=len(MESH_PATTERN),
                              pattern=MESH_PATTERN, moe_groups=MESH_GROUPS)
    if cfg.param_count() != MESH_PARAMS:
        raise AssertionError(f"{cfg.param_count()} parameters, not "
                             f"{MESH_PARAMS}")
    steps, batch, seq, mb = MESH_RUN
    mesh = make_host_mesh(*MESH_SHAPE, device=dev)
    # the tree also holds the norm gains and SSD vectors param_count omits
    n = sum(p.numel() for p in init_params(cfg, device="meta").parameters())
    reckon = {"weights": 2 * n, "moments": 8 * n, "accumulator": 4 * n}
    out = {"reckon": reckon}
    t_phase = time.perf_counter()
    total_mem = torch.cuda.get_device_properties(dev).total_memory
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    say = lambda s: log(f"[mesh] {smi}: {s}")  # noqa: E731
    calls = [0]
    orig_manual = moe_mod._grouped_manual

    def manual(*a, **k):
        calls[0] += 1
        return orig_manual(*a, **k)

    # -- gate 1: meshed training through the Trainer ---------------------
    root = tempfile.mkdtemp(prefix="mesh_train_")
    opt = OptConfig(warmup_steps=max(2, steps // 20), total_steps=steps)
    tc = TrainerConfig(steps=steps, global_batch=batch, microbatches=mb,
                       seq_len=seq, ckpt_every=steps, log_every=steps,
                       ckpt_dir=os.path.join(root, "run"),
                       zipf_s=TRAIN_ZIPF_S, seed=seed)
    marks: list = []
    skipped: list = []
    moe_mod._grouped_manual = manual
    try:
        trainer = Trainer(cfg, opt, tc, mesh=mesh, log_fn=say)
        # a save writes the 37 GB state to disk; 6h checks the saves
        trainer.ckpt.save = lambda step, tree, extra=None: skipped.append(
            step)
        with activate(mesh), _marking(marks):
            res = trainer.run()
    finally:
        moe_mod._grouped_manual = orig_manual
        shutil.rmtree(root, ignore_errors=True)
    rows = _split(marks, mb)
    losses = res["losses"]
    params, state = res["params"], res["opt_state"]
    peak_train = torch.cuda.max_memory_allocated() - resident
    if not all(np.isfinite(losses)):
        raise AssertionError(f"a meshed loss is not finite: {losses}")
    if not np.mean(losses[-2:]) < losses[0]:
        raise AssertionError(f"the meshed loss did not fall: {losses}")
    if calls[0] < 1:
        raise AssertionError("training never reached _grouped_manual")
    med = float(np.median([r["ms"] for r in rows[1:]]))
    out["train"] = dict(losses=losses, rows=rows, median_ms=med,
                        manual_calls=calls[0], host_ms=[
                            t * 1e3 for t in trainer.step_times],
                        peak=peak_train, skipped_saves=skipped)
    say(f"{MESH_ARCH} at published widths, layers {list(MESH_PATTERN)} "
        f"({MESH_PARAMS} parameters by param_count, {n} in the tree, bf16, "
        f"moe_groups {MESH_GROUPS}), "
        f"Trainer(mesh=ShardMesh({MESH_SHAPE[0]}, {MESH_SHAPE[1]})) under "
        f"activate: {steps} steps of {batch}x{seq} Zipf({TRAIN_ZIPF_S}) "
        f"tokens in {mb} microbatches, float32 moments; _grouped_manual "
        f"called {calls[0]} times (forward and remat recompute); the "
        f"Trainer's saves at steps {skipped} skipped (the state is "
        f"{reckon['weights'] + reckon['moments']} bytes; 6h checks saves)")
    for i, (r, loss) in enumerate(zip(rows, losses)):
        say(f"step {i}: loss {loss:.5f}; {r['ms']:.3f} ms by CUDA events "
            f"(fwd+bwd per microbatch "
            f"{json.dumps([round(x, 3) for x in r['micro_ms']])}, update "
            f"{r['update_ms']:.3f}), host "
            f"{trainer.step_times[i] * 1e3:.3f} ms")
    say(f"median of steps 1-{steps - 1} {med:.3f} ms a step, "
        f"{batch * seq / med * 1e3:.1f} tokens/s; mean of the last two "
        f"losses {np.mean(losses[-2:]):.5f} < first {losses[0]:.5f}; peak "
        f"allocated above the {resident} bytes resident {peak_train} bytes "
        f"({peak_train / 2**30:.3f} GiB; reckoned {sum(reckon.values())} "
        f"persistent: weights {reckon['weights']}, moments "
        f"{reckon['moments']}, accumulator {reckon['accumulator']}), card "
        f"{total_mem}")
    if peak_train > total_mem:
        raise AssertionError(f"peak {peak_train} past the card's {total_mem}")
    del trainer, res

    # -- gate 4: reshard onto (2, 2) and back ----------------------------
    small = make_host_mesh(*MESH_SMALL, device=dev)
    orig, orig_m = flat(params), {k: flat(state[k]) for k in ("m", "v")}
    t = time.perf_counter()
    re = reshard_params(params, small)
    rs = reshard_opt_state(state, re)
    back = reshard_params(re, mesh)
    bs = reshard_opt_state(rs, back)
    sync()
    reshard_s = time.perf_counter() - t
    checked, dropped = 0, 0
    for m, tree, st in ((small, re, rs), (mesh, back, bs)):
        with activate(m):
            rules = flat(param_specs(params))
        got, mom = flat(tree), {k: flat(st[k]) for k in ("m", "v")}
        for path, leaf in got.items():
            want = Placement(m, _sanitize(rules[path], leaf.shape, m))
            if leaf.placement != want:
                raise AssertionError(f"{path}: placed {leaf.placement}, "
                                     f"the rules say {want}")
            if leaf.data_ptr() != orig[path].data_ptr() or not torch.equal(
                    _bits(leaf), _bits(orig[path])):
                raise AssertionError(f"{path}: values moved in the reshard")
            for k in ("m", "v"):
                if mom[k][path].placement != want or \
                        mom[k][path].data_ptr() != orig_m[k][path].data_ptr():
                    raise AssertionError(f"{k}/{path}: the moment is not "
                                         "on its parameter's placement")
            checked += 1
            if m is small:
                dropped += sum(a is not None and b is None for a, b in zip(
                    rules[path], leaf.placement.spec))
    out["reshard"] = dict(seconds=reshard_s, leaves=checked)
    say(f"reshard_params + reshard_opt_state onto ShardMesh"
        f"({MESH_SMALL[0]}, {MESH_SMALL[1]}) and back: {checked} leaf "
        f"placements equal the sanitized rules, the moments on their "
        f"parameters' placements, every leaf's storage and bits unchanged "
        f"(no copy on one card); {dropped} dimensions replicated on "
        f"(2, 2) where the rule's axes do not divide them; "
        f"{reshard_s * 1e3:.3f} ms")
    del re, rs, back, bs, state, orig, orig_m
    gc.collect()
    torch.cuda.empty_cache()

    # -- the MoE layer: manual against grouped, forward and backward -------
    stream = ZipfTokenStream(cfg.vocab_size, seq, zipf_s=TRAIN_ZIPF_S,
                             seed=seed)
    b = shard_batch(stream.batch(steps, batch), mesh, mb)
    tk, lb = b["tokens"], b["labels"]
    ffn = moe_mod.MoEParams(*(getattr(params.blocks[1].ffn, f)[0]
                              for f in moe_mod.MoEParams._fields))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn((batch // mb, seq, cfg.d_model), generator=gen,
                    device=dev, dtype=torch.bfloat16).requires_grad_()
    ct = torch.randn(x.shape, generator=gen, device=dev, dtype=x.dtype)
    layer = {}
    for label, ctx in (("manual", lambda: activate(mesh)),
                       ("grouped", contextlib.nullcontext)):
        fwd, bwd = [], []
        before = calls[0]
        moe_mod._grouped_manual = manual
        try:
            with ctx():
                for r in range(MESH_LAYER_WARM + MESH_LAYER_REPS):
                    x.grad = None
                    for p in params.parameters():
                        p.grad = None
                    a = _event()
                    y = moe_mod.moe_ffn(ffn, cfg, x, cfg.act)
                    mid = _event()
                    y.backward(ct)
                    z = _event()
                    sync()
                    if r >= MESH_LAYER_WARM:
                        fwd.append(a.elapsed_time(mid))
                        bwd.append(mid.elapsed_time(z))
        finally:
            moe_mod._grouped_manual = orig_manual
        took = calls[0] - before
        if (label == "manual") != (took > 0):
            raise AssertionError(f"the {label} layer ran _grouped_manual "
                                 f"{took} times")
        layer[label] = dict(fwd=fwd, bwd=bwd, y=y.detach(),
                            dx=x.grad.detach().clone())
    diff_y = float((layer["manual"]["y"].float()
                    - layer["grouped"]["y"].float()).abs().max())
    diff_dx = float((layer["manual"]["dx"].float()
                     - layer["grouped"]["dx"].float()).abs().max())
    out["layer"] = {k: dict(fwd=v["fwd"], bwd=v["bwd"])
                    for k, v in layer.items()}
    for label, v in layer.items():
        say(f"MoE layer ({label}, {x.shape[0]}x{seq} tokens of "
            f"{cfg.d_model}, {cfg.moe.num_experts} experts top-"
            f"{cfg.moe.top_k}, {MESH_GROUPS} groups, bf16) by CUDA events, "
            f"{MESH_LAYER_REPS} reps after {MESH_LAYER_WARM}: forward ms "
            f"{json.dumps([round(t, 3) for t in v['fwd']])}, median "
            f"{np.median(v['fwd']):.3f}; backward ms "
            f"{json.dumps([round(t, 3) for t in v['bwd']])}, median "
            f"{np.median(v['bwd']):.3f}")
    say(f"MoE layer manual against grouped, bf16 (information): output max "
        f"|diff| {diff_y:.3e}, input gradient max |diff| {diff_dx:.3e}")
    del layer, x, ct, y
    for p in params.parameters():
        p.grad = None

    # -- gate 3: compressed psum of the two microbatches' gradients ------
    peaks = {"train": peak_train,
             "layer": torch.cuda.max_memory_allocated() - resident}
    torch.cuda.reset_peak_memory_stats()
    gr = []
    moe_mod._grouped_manual = manual
    try:
        with activate(mesh):
            for i in range(mb):
                _backward(cfg, params, tk[i], lb[i])
                gr.append(_grads_of(params))
    finally:
        moe_mod._grouped_manual = orig_manual
    for p in params.parameters():
        p.grad = None
    psum_ms, worst, where, n_blocks, n_elems = 0.0, 0.0, None, 0, 0
    for name in gr[0]:
        g = torch.stack([gr[0][name], gr[1][name]])
        a = _event()
        red = psum_compressed([g], "pod", mesh)[0]
        z = _event()
        sync()
        psum_ms += a.elapsed_time(z)
        # checked a slice of rows at a time: a whole experts leaf in
        # float32 is 3.8 GB a region
        gv, rv = g.view(2, -1, g.shape[-1]), red.view(2, -1, g.shape[-1])
        rows = max(1, (1 << 24) // (2 * g.shape[-1]))
        for i in range(0, gv.shape[1], rows):
            gs, rs_ = gv[:, i:i + rows].float(), rv[:, i:i + rows]
            if not torch.equal(rs_[0], rs_[1]):
                raise AssertionError(f"{name}: the pod regions differ")
            bound = 2 * block_max(gs).amax(dim=0) / 127
            err = block_max(rs_[0] - (gs[0] + gs[1]))
            ratio = float((err / torch.clamp_min(bound, 1e-30)).max())
            if not bool((err <= bound * (1 + MESH_PSUM_SLACK)).all()):
                raise AssertionError(
                    f"{name}: compressed psum error {float(err.max())} "
                    f"past one int8 step per summand ({ratio:.4f} of the "
                    f"bound)")
            if ratio >= worst:
                worst, where = ratio, name
            n_blocks += bound.numel()
        n_elems += g[0].numel()
        del g, red, gv, rv, gs, rs_, bound, err
    out["psum"] = dict(ms=psum_ms, worst=worst, where=where,
                       blocks=n_blocks, elements=n_elems)
    say(f"psum_compressed over 'pod' of the two microbatches' bf16 "
        f"gradients ({len(gr[0])} leaves, {n_elems} elements a region, "
        f"{n_blocks} blocks of {QBLOCK}): both regions equal; each block's "
        f"max |error| at most {worst:.4f} of 2 x block max / 127 (gate 1, "
        f"slack {MESH_PSUM_SLACK}; largest at {where}); {psum_ms:.3f} ms by "
        f"CUDA events over the leaves")
    del gr
    gc.collect()
    torch.cuda.empty_cache()

    # -- gate 2: manual against grouped, float32, the whole model --------
    peaks["psum"] = torch.cuda.max_memory_allocated() - resident
    torch.cuda.reset_peak_memory_stats()
    p32 = ParamTree(tree_map(lambda p: p.detach().float(), params.tree()))
    del params, ffn
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")

    def host_grads(c, ps, tok, lab):
        """Loss and gradients, each gradient moved to the host as it lands
        (two float32 gradient sets and a float32 backward do not fit on
        the card beside each other)."""
        got, hooks = {}, []
        for name, p in ps.named_parameters():
            p.grad = None

            def hook(p, name=name):
                got[name] = p.grad.cpu()
                p.grad = None
            hooks.append(p.register_post_accumulate_grad_hook(hook))
        try:
            loss = loss_fn(c, ps, tok, lab)
            loss.backward()
        finally:
            for h in hooks:
                h.remove()
        return float(loss.detach()), got

    before = calls[0]
    moe_mod._grouped_manual = manual
    try:
        l_g, g_g = host_grads(cfg32, p32, tk[0], lb[0])
        if calls[0] != before:
            raise AssertionError("the grouped pass reached _grouped_manual")
        with activate(mesh):
            l_m, g_m = host_grads(cfg32, p32, tk[0], lb[0])
        if calls[0] == before:
            raise AssertionError("the meshed pass missed _grouped_manual")
    finally:
        moe_mod._grouped_manual = orig_manual
    if set(g_g) != set(g_m) or len(g_g) != len(list(p32.parameters())):
        raise AssertionError("a leaf has no gradient")
    worst_abs, worst_rel, at = 0.0, 0.0, None
    for name, gg in g_g.items():
        gg = gg.to(dev)
        d = float((g_m[name].to(dev) - gg).abs().max())
        scale = float(gg.abs().max())
        rel = d / scale if scale > 0 else (0.0 if d == 0 else float("inf"))
        if not (d <= MESH_GRAD_TOL and rel <= MESH_GRAD_REL):
            raise AssertionError(f"{name}: manual gradient max |diff| {d} "
                                 f"({rel} of the leaf's max |g| {scale})")
        if rel >= worst_rel:
            worst_rel, at = rel, name
        worst_abs = max(worst_abs, d)
    if not abs(l_m - l_g) <= MESH_LOSS_TOL:
        raise AssertionError(f"manual loss {l_m} against grouped {l_g}")
    out["f32"] = dict(loss_manual=l_m, loss_grouped=l_g, worst_abs=worst_abs,
                      worst_rel=worst_rel, where=at)
    say(f"float32, one microbatch ({tk.shape[1]}x{seq}), the trained "
        f"weights cast up: manual dispatch (mesh active) against the "
        f"grouped path (none): loss {l_m:.7f} / {l_g:.7f} (|diff| "
        f"{abs(l_m - l_g):.3e}, gate {MESH_LOSS_TOL}); gradient max |diff| "
        f"{worst_abs:.3e} (gate {MESH_GRAD_TOL}), largest share of a leaf's "
        f"max |g| {worst_rel:.3e} at {at} (gate {MESH_GRAD_REL})")
    del p32, g_g, g_m, tk, lb, b
    gc.collect()
    torch.cuda.empty_cache()
    peaks["float32"] = torch.cuda.max_memory_allocated() - resident
    out["peaks"] = peaks
    out["seconds"] = time.perf_counter() - t_phase
    say(f"peak allocated above the {resident} bytes resident, bytes (GiB): "
        + ", ".join(f"{k} {v} ({v / 2**30:.3f})" for k, v in peaks.items())
        + f"; {out['seconds']:.1f} s")
    return out


# phase 6j: the batched query tail at the served cells' scale
# (bench/configs/ssb_sf30.json), dispatches of 3 requests (the read cell
# serves 2.37 a dispatch), a served round of 3 requests per query
TAIL_SF = 30
TAIL_WIDTH = 3
TAIL_SERVED = 3
TAIL_REPS = 5


def tail_bytes(dim_ops, fact_word, measure, n_requests: int):
    """Bytes one ``batched_tail`` launch moves: ``(whole, needed)``.

    ``whole`` reads every operand once: each joined dimension's found
    byte and dim_row, the fact word and the measure's columns over all
    fact rows, the planes once, the outputs written once.  ``needed``
    counts the fact word and the measure only in the 32-byte sectors (8
    rows) where some row still passes for some request when the kernel
    would read them: the kernel reads the word after the dimensions and
    the measure after the word."""
    import torch

    op, ma, mb = measure
    n = ma.shape[0]
    keep = torch.full((n,), -1, dtype=torch.int32, device=ma.device)
    all_bits = (1 << n_requests) - 1 if n_requests < 32 else -1
    planes = 0
    for found, row, pred, group in dim_ops:
        keep = torch.where(found, keep, 0)
        n_dim = (pred if pred is not None else group).shape[0]
        if pred is not None:
            keep &= pred[row.clamp(0, n_dim - 1).long()]
        planes += 4 * n_dim * ((pred is not None) + (group is not None))
    if n_requests < 32:
        keep &= all_bits

    def sectors(mask):
        pad = -n % 8
        m = torch.nn.functional.pad(mask, (0, pad)).view(-1, 8).any(dim=1)
        return int(m.sum()) * 32

    fixed = 5 * n * len(dim_ops) + planes + 4 * n_requests
    cols = 1 + (mb is not None)
    whole = fixed + 4 * n * cols + (0 if fact_word is None else 4 * n)
    needed = fixed
    if fact_word is not None:
        needed += sectors(keep != 0)
        keep &= fact_word
    needed += cols * sectors(keep != 0)
    return whole, needed


def device_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn`` by CUDA events, the calls queued behind
    a sleeping kernel (a call that synchronises adds its host time)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def query_tails(seed: int, smi: str, dev) -> tuple[dict, int]:
    """Phase 6j: the batched query tail at SF30.

    On ``generate_ssb(TAIL_SF)`` with a warm probe cache, every query's
    ``batched_tail`` over ``TAIL_WIDTH`` sampled requests against its
    plain version and against the composed flavor (``_filter_aggregate``
    per request), bit for bit; each query's kernel ms (CUDA events behind
    a sleeping kernel), the whole tail's (``_batched_tail``: operands and
    kernel), the plain version's, the bytes and the bound they set, and
    the device memory a tail allocates above what was resident (under the
    8 bytes a row that one int64 vector of the fact rows would take).
    Then a ``QueryScheduler`` serves ``TAIL_SERVED`` requests of each
    query: one dispatch per query id, each exactly one ``batched_tail``
    launch, every answer the composed flavor's.  Returns the kernel
    table's row (means per launch over the queries) and the served
    round's launches."""
    import importlib

    import numpy as np
    import torch

    from repro_torch.engine import SSB_QUERIES, SSBEngine, generate_ssb
    from repro_torch.serving import (PARAM_QUERIES, BatchRunner,
                                     QueryScheduler, ServeConfig)
    from repro_torch.serving import batch as pbatch
    bt = importlib.import_module("repro_torch.kernels.batched_tail")

    t0 = time.perf_counter()
    tables = generate_ssb(TAIL_SF, seed=seed, device=dev)
    eng = SSBEngine(tables, device=dev)
    eng.warm_cache()
    torch.cuda.synchronize()
    n = eng.tables["lineorder"].n_physical
    log(f"[tail] SF{TAIL_SF:g}: {n} fact rows, engine and probe cache in "
        f"{time.perf_counter() - t0:.1f} s")
    names = sorted(SSB_QUERIES)
    rng = np.random.default_rng(seed)
    fact_cols = dict(eng.tables["lineorder"].columns)
    per = {}
    for name in names:
        spec = SSB_QUERIES[name]
        pq = PARAM_QUERIES[name]
        dim_cols = {d: dict(eng.tables[d].columns)
                    for d in spec.joined_dims()}
        probes = {d: eng.probe_dim(d) for d in spec.joined_dims()}
        ps = [pq.sample(rng) for _ in range(TAIL_WIDTH)]
        params = torch.as_tensor(np.asarray(ps, np.int32), device=dev)
        bound_q = pq.bind([params[:, j:j + 1] for j in range(len(ps[0]))])
        ops = bt.tail_operands(bound_q, fact_cols, dim_cols, probes, len(ps))
        kw = {"n_requests": len(ps), "num_segments": ops[3]}
        got = bt.batched_tail(*ops[:3], **kw)
        want = bt.batched_tail_plain(*ops[:3], **kw)
        composed = BatchRunner().run_batch(eng, name, ps, flavor="composed")
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"batched_tail on {name} differs from its "
                                 "plain version")
        for i, (t, g) in enumerate(composed):
            if int(got[0][i]) != t or not np.array_equal(
                    got[1][i].cpu().numpy(), g):
                raise AssertionError(f"batched_tail on {name}{ps[i]} differs "
                                     "from the composed flavor")
        whole, needed = tail_bytes(*ops[:3], len(ps))
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        pbatch._batched_tail(pq, fact_cols, dim_cols, probes, params)
        torch.cuda.synchronize()
        above = torch.cuda.max_memory_allocated() - resident
        if above >= 8 * n:
            raise AssertionError(f"the tail of {name} allocated {above} "
                                 f"bytes above the resident, past one int64 "
                                 f"vector of the {n} fact rows")
        r = per[name] = {
            "ms": device_ms(lambda: bt.batched_tail(*ops[:3], **kw),
                            TAIL_REPS),
            "tail_ms": device_ms(lambda: pbatch._batched_tail(
                pq, fact_cols, dim_cols, probes, params), TAIL_REPS),
            "plain_ms": device_ms(
                lambda: bt.batched_tail_plain(*ops[:3], **kw), 1),
            "bytes": whole, "needed": needed, "above": above,
            "bound_ms": needed / HBM_BYTES_PER_S * 1e3,
            "whole_ms": whole / HBM_BYTES_PER_S * 1e3}
        log(f"[tail] {smi}: {name} x{len(ps)}: kernel {r['ms']:.4f} ms, "
            f"operands and kernel {r['tail_ms']:.4f} ms, plain "
            f"{r['plain_ms']:.2f} ms; bytes whole {whole} "
            f"({r['whole_ms']:.4f} ms at {HBM_BYTES_PER_S / 1e12:g} TB/s), "
            f"needed {needed} ({r['bound_ms']:.4f} ms, "
            f"{r['bound_ms'] / r['ms'] * 100:.1f}% of it); allocated "
            f"{above} bytes above the resident; bit-identical")
        del ops, got, want
    mean = {k: sum(r[k] for r in per.values()) / len(per)
            for k in ("ms", "tail_ms", "plain_ms", "bytes", "needed",
                      "bound_ms", "whole_ms")}
    log(f"[tail] {smi}: mean over the {len(per)} queries x{TAIL_WIDTH}: "
        f"kernel {mean['ms']:.4f} ms, operands and kernel "
        f"{mean['tail_ms']:.4f} ms, plain {mean['plain_ms']:.2f} ms, bound "
        f"{mean['bound_ms']:.4f} ms (needed bytes), {mean['whole_ms']:.4f} "
        f"ms (whole bytes)")
    # a served round: one dispatch, one launch per query id
    reqs = [(q, PARAM_QUERIES[q].sample(rng)) for q in names
            for _ in range(TAIL_SERVED)]
    want = {i: BatchRunner().run_batch(eng, q, [p], flavor="composed")[0]
            for i, (q, p) in enumerate(reqs)}
    sched = QueryScheduler(eng, ServeConfig(max_queue=len(reqs)))
    tickets = [sched.submit(q, p) for q, p in reqs]
    before = bt.batched_tail.launches
    sched.pump()
    torch.cuda.synchronize()
    launches = bt.batched_tail.launches - before
    info = sched.info()
    sched.close()
    if info["batches"] != len(names) or launches != info["batches"] or \
            info["composed_batches"] or info["completed"] != len(reqs):
        raise AssertionError(f"served round: {launches} batched_tail "
                             f"launches, {json.dumps(info)}")
    for i, tk in enumerate(tickets):
        r = tk.response
        if not r.ok or r.total != want[i][0] or \
                not np.array_equal(r.groups, want[i][1]):
            raise AssertionError(f"served round: {reqs[i]} differs from the "
                                 "composed flavor")
    log(f"[tail] served round: {len(reqs)} requests in {info['batches']} "
        f"dispatches, {launches} batched_tail launches, every answer the "
        "composed flavor's, bit for bit")
    row = {"shape": f"SF{TAIL_SF:g}, {n} fact rows, {len(names)} queries x "
                    f"{TAIL_WIDTH} requests, mean per launch",
           "bytes": round(mean["needed"]), "ms": mean["ms"],
           "plain_ms": mean["plain_ms"], "bound_ms": mean["bound_ms"],
           "bound_by": "bytes"}
    return row, launches


# phase 6j on skewed keys: the benchmark's two SF30 deployments, drawn by
# its generator (bench/datagen.py) from one seed: bench/configs/ssb_sf30.json
# (uniform keys) and ssb_sf30_zipf1.json (bounded Zipf(1.0) custkey, partkey
# and suppkey, Rabl et al., ICPE 2013), equal but for those keys; a query
# this much slower on skewed keys is named; then each probe schedule the
# planner prices, forced in turn, on one re-probe of every dimension
TAIL_DEPLOYMENTS = (("uniform", "ssb_sf30"), ("zipf", "ssb_sf30_zipf1"))
TAIL_WIDTHS = (1, 3, 8)
TAIL_SLOWER = 1.5
FORCED_SCHEDULES = ("gathered", "deduped", "hot_cold")
REPROBE_REPS = 3


def tail_kernel_ms(eng, params: dict, dev) -> dict:
    """``{(query, width): kernel ms}`` of ``batched_tail`` over the engine's
    cached probes, each launch's output bit-identical to the plain
    version's; ``params`` gives each query's requests at each width."""
    import importlib

    import numpy as np
    import torch

    from repro_torch.engine import SSB_QUERIES
    from repro_torch.serving import PARAM_QUERIES
    bt = importlib.import_module("repro_torch.kernels.batched_tail")

    fact_cols = dict(eng.tables["lineorder"].columns)
    out = {}
    for (name, w), ps in params.items():
        dims = SSB_QUERIES[name].joined_dims()
        dim_cols = {d: dict(eng.tables[d].columns) for d in dims}
        probes = {d: eng.probe_dim(d) for d in dims}
        p = torch.as_tensor(np.asarray(ps, np.int32), device=dev)
        bound_q = PARAM_QUERIES[name].bind(
            [p[:, j:j + 1] for j in range(p.shape[1])])
        ops = bt.tail_operands(bound_q, fact_cols, dim_cols, probes, w)
        kw = {"n_requests": w, "num_segments": ops[3]}
        got = bt.batched_tail(*ops[:3], **kw)
        want = bt.batched_tail_plain(*ops[:3], **kw)
        if not all(torch.equal(g, x) for g, x in zip(got, want)):
            raise AssertionError(f"batched_tail on {name} x{w} differs from "
                                 "its plain version")
        out[name, w] = device_ms(lambda: bt.batched_tail(*ops[:3], **kw),
                                 TAIL_REPS)
        del ops, got, want
    return out


def forced_schedules(tables, smi: str, dev) -> dict:
    """Each of ``FORCED_SCHEDULES`` forced through
    ``ExecutionPolicy(schedule=)``: every dimension's re-probe as a
    snapshot makes it (``_join``: ``lookup`` under the plan), its device ms,
    its packed words equal to the gathered schedule's, and the plan's
    estimates.  Returns ``{dim: {schedule: ms}}``."""
    import torch

    from repro_torch.core import ExecutionPolicy, pack_words
    from repro_torch.engine import SSBEngine, lookup
    from repro_torch.engine.queries import DIM_PK, FACT_FK

    words, ms = {}, {d: {} for d in DIM_PK}
    for sc in FORCED_SCHEDULES:
        t0 = time.perf_counter()
        eng = SSBEngine(tables, policy=ExecutionPolicy(schedule=sc),
                        device=dev)
        build_s = time.perf_counter() - t0
        for d in DIM_PK:
            plan = eng.plans[d]
            w = pack_words(lookup(eng.indexes[d],
                                  eng.tables["lineorder"][FACT_FK[d]],
                                  impl="cuda", plan=plan,
                                  hot_codes=eng._hot_codes.get(d)))
            if d not in words:
                words[d] = w
            elif not torch.equal(w, words[d]):
                raise AssertionError(f"{d}: the {sc} re-probe's words differ "
                                     f"from the {FORCED_SCHEDULES[0]} one's")
            del w
            ms[d][sc] = device_ms(lambda: eng._join(d), REPROBE_REPS)
            est = {k: round(v * 1e3, 4) for k, v in plan.est_seconds}
            log(f"[plan] {smi}: skewed tables, {d} forced {sc!r} "
                f"(hot {plan.hot_entries} / {plan.hot_slots} slots, cold "
                f"capacity {plan.cold_capacity}, full map {plan.full_map}): "
                f"re-probe {ms[d][sc]:.4f} ms, words equal; estimated ms "
                f"{json.dumps(est)}; engine built in {build_s:.2f} s")
        del eng
        torch.cuda.empty_cache()
    for d in DIM_PK:
        fastest = min(ms[d], key=ms[d].get)
        x = ms[d]["gathered"] / ms[d][fastest]
        log(f"[plan] {smi}: skewed tables, {d}: measured ms "
            f"{json.dumps({k: round(v, 4) for k, v in ms[d].items()})}; "
            f"fastest {fastest!r}, gathered at {x:.3f}x of it "
            f"({'within' if x <= PICK_SLACK else 'NOT within'} "
            f"{PICK_SLACK})")
    return ms


def skewed_tails(seed: int, smi: str, dev, rows: dict | None = None) -> dict:
    """Phase 6j on skewed keys.

    The tables of ``TAIL_DEPLOYMENTS`` (``rows`` replaces their row counts
    for a rehearsal), one after the other: each query's ``batched_tail``
    at ``TAIL_WIDTHS`` requests (the same constants on both) over a warm
    probe cache, bit-identical to the plain version, its kernel ms on each
    and their ratio (``[tail-zipf]``; past ``TAIL_SLOWER`` the query is
    named), and one default re-probe of each dimension on each; then
    ``forced_schedules`` on the skewed tables.  Returns the times."""
    import numpy as np
    import torch

    from bench.datagen import DataGen
    from repro_torch.engine import SSB_QUERIES, SSBEngine, Table
    from repro_torch.engine.queries import DIM_PK
    from repro_torch.serving import PARAM_QUERIES

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    params = {(q, w): [PARAM_QUERIES[q].sample(rng) for _ in range(w)]
              for q in sorted(SSB_QUERIES) for w in TAIL_WIDTHS}
    times, gathered = {}, {}
    for dist, name in TAIL_DEPLOYMENTS:
        config = json.loads((Path(__file__).resolve().parent / "bench"
                             / "configs" / f"{name}.json").read_text())
        if rows is not None:
            config["rows"] = rows
        fact, dims = DataGen(config, seed, dev).tables()
        tables = {"lineorder": Table(fact),
                  **{d: Table(c) for d, c in dims.items()}}
        del fact, dims
        eng = SSBEngine(dict(tables), device=dev)
        eng.warm_cache()
        torch.cuda.synchronize()
        shares = {d: (round(eng.indexes[d].stats.fact_skew.max_share, 6),
                      eng.indexes[d].stats.fact_skew.distinct)
                  for d in DIM_PK}
        log(f"[tail-zipf] {name} ({dist} keys): "
            f"{eng.tables['lineorder'].n_rows} fact rows, dimension rows "
            f"{json.dumps({d: eng.tables[d].n_rows for d in DIM_PK})}; "
            f"hottest key's share and distinct keys by dimension "
            f"{json.dumps(shares)}; engine and probe cache at "
            f"{time.perf_counter() - t0:.1f} s")
        times[dist] = tail_kernel_ms(eng, params, dev)
        gathered[dist] = {d: device_ms(lambda: eng._join(d), REPROBE_REPS)
                          for d in DIM_PK}
        log(f"[tail-zipf] {smi}: {name}: one re-probe a dimension "
            f"(default plan, gathered), device ms "
            f"{json.dumps({d: round(v, 4) for d, v in gathered[dist].items()})}")
        del eng
        torch.cuda.empty_cache()
    slower = []
    for q in sorted(SSB_QUERIES):
        cells = []
        for w in TAIL_WIDTHS:
            u, z = times["uniform"][q, w], times["zipf"][q, w]
            cells.append(f"x{w} {u:.4f} / {z:.4f} ({z / u:.2f}x)")
            if z > TAIL_SLOWER * u:
                slower.append((q, w))
        log(f"[tail-zipf] {smi}: {q} kernel ms uniform / Zipf: "
            f"{'; '.join(cells)}; bit-identical")
    for w in TAIL_WIDTHS:
        su = sum(times["uniform"][q, w] for q in SSB_QUERIES)
        sz = sum(times["zipf"][q, w] for q in SSB_QUERIES)
        log(f"[tail-zipf] {smi}: x{w} summed over the 13 queries: uniform "
            f"{su:.4f} ms, Zipf {sz:.4f} ms ({sz / su:.2f}x)")
    log(f"[tail-zipf] past {TAIL_SLOWER}x its uniform time: "
        f"{slower if slower else 'none'}")
    reprobe = forced_schedules(tables, smi, dev)
    return {"tails": times, "slower": slower, "reprobe": reprobe,
            "gathered": gathered}


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
    from repro_torch.core import (ExecutionPolicy, build_hot_table, costmodel,
                                  encode, hash_bucket, hot_hit_count,
                                  measure_skew, overlay_delta, pack_words,
                                  plan_probe, plan_query, refine_plan,
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

    def log_plans(eng, label):
        """Each dimension's schedule plan with the card's estimates."""
        for d, p in sorted(eng.plans.items()):
            est = {k: round(v * 1e3, 4) for k, v in p.est_seconds}
            log(f"[plan] {label} {d}: {p.schedule} (hot {p.hot_entries} / "
                f"{p.hot_slots} slots, cold capacity {p.cold_capacity}, "
                f"full_map {p.full_map}); estimated ms {json.dumps(est)}")

    log(f"[plan] phase 4 engine: {engine.policy}; run_all on the cache "
        f"takes {engine._plan_fusion(len(names))!r}")
    log_plans(engine, "phase 4")
    if any(p.schedule != "gathered" for p in engine.plans.values()):
        raise AssertionError("the CUDA kernels' auto plans must keep "
                             "gathered")
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

    def check_fused(eng, label, timed=True):
        """``fused_query`` (and the ``pack_query_bits`` before it) against
        its plain version on all 13 queries' operands of ``eng`` (over its
        own fact table's physical rows); unless ``timed`` is False, times
        it on each and prints its bytes, bound and launches x gap there."""
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
            if not timed:
                del dim_ops, fmeasure, got, bits, want_bits
                continue
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
        if not timed:
            return ms
        log(f"[kernel] fused_query ms per launch by query ({label}): "
            f"{json.dumps({q: round(v, 4) for q, v in ms.items()})}")
        log(f"[kernel-query] fused_query sum over {len(names)} queries "
            f"({label}): {sum(ms.values()):.4f} ms, bound {bound_sum:.4f} "
            f"ms (every input whole: {every_sum:.4f} ms), launches x gap "
            f"{gap:.4f} ms")
        return ms

    check_fused(engine, "static indexes")
    torch.cuda.empty_cache()

    # -- 3c. calibration: the building blocks of the card's cost entry ------
    cost = costmodel.HOST_COSTS["cuda"]
    calib = {"cache_bytes": torch.cuda.get_device_properties(0).L2_cache_size}
    cgen = torch.Generator(device="cuda")
    cgen.manual_seed(args.seed + 5)

    def gather_rate(elems):
        """ms of ``CALIB_N`` random 4-byte reads of an ``elems``-entry
        table, and ns per byte of the sectors they move."""
        table = torch.zeros(elems, dtype=torch.int32, device="cuda")
        idx = torch.randint(0, elems, (CALIB_N,), generator=cgen,
                            device="cuda", dtype=torch.int32)
        ms = event_ms(lambda: torch.index_select(table, 0, idx),
                      KERNEL_REPS)
        return ms, ms * 1e6 / (CALIB_N * SECTOR_BYTES)

    g_ms, calib["gather"] = gather_rate(CALIB_BIG_ELEMS)
    c_ms, calib["cached_gather"] = gather_rate(CALIB_SMALL_ELEMS)
    part_tbl = engine.indexes["part"].table
    p_ms = per_dim["probe_rows"]["part"]["ms"]
    calib["lane"] = p_ms * 1e6 / (n_fact * part_tbl.bucket_width)
    skeys = torch.randint(0, 1 << 30, (CALIB_N,), generator=cgen,
                          device="cuda", dtype=torch.int32)
    s_ms = event_ms(lambda: torch.sort(skeys, stable=True), 3)
    calib["sort"] = s_ms * 1e6 / (CALIB_N * np.log2(CALIB_N))
    x_ms = event_ms(lambda: skeys + 1, KERNEL_REPS)
    calib["pass"] = x_ms * 1e6 / CALIB_N
    tiny = torch.ones(1, dtype=torch.int32, device="cuda")
    sync()
    t = time.perf_counter()
    for _ in range(CALIB_OPS):
        tiny = tiny + 1
    sync()
    calib["op"] = (time.perf_counter() - t) * 1e9 / CALIB_OPS
    del skeys, tiny
    torch.cuda.empty_cache()
    log(f"[calib] {smi}: gather: {CALIB_N} random 4-byte reads of a "
        f"{CALIB_BIG_ELEMS * 4 >> 20} MiB table {g_ms:.4f} ms, "
        f"{calib['gather']:.6f} ns per sector byte (entry: "
        f"{cost.gather_ns_per_byte})")
    log(f"[calib] {smi}: cached_gather: the same reads of a "
        f"{CALIB_SMALL_ELEMS * 4 >> 20} MiB table {c_ms:.4f} ms, "
        f"{calib['cached_gather']:.6f} ns per sector byte (entry: "
        f"{cost.cached_gather_ns_per_byte})")
    log(f"[calib] {smi}: cache_bytes: L2 {calib['cache_bytes']} bytes "
        f"(entry: {cost.cache_bytes})")
    log(f"[calib] {smi}: lane: probe_rows on part ({n_fact} probes, table "
        f"{tuple(part_tbl.keys.shape)}) {p_ms:.4f} ms, {calib['lane']:.6f} "
        f"ns per probe per lane (entry: {cost.lane_ns})")
    log(f"[calib] {smi}: sort: torch.sort(stable=True) of {CALIB_N} int32 "
        f"keys {s_ms:.4f} ms, {calib['sort']:.6f} ns per element per log2 "
        f"(entry: {cost.sort_ns_per_elem_log2})")
    log(f"[calib] {smi}: pass: an int32 elementwise pass over {CALIB_N} "
        f"rows {x_ms:.4f} ms, {calib['pass']:.6f} ns per row (entry: "
        f"{cost.pass_ns})")
    log(f"[calib] {smi}: op: {CALIB_OPS} one-element launches by the host "
        f"clock, {calib['op']:.1f} ns each (entry: {cost.op_ns})")

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

    # [plan] run_all on the cache: plan_query's pick against both flavors
    # (no launches: every probe is cached), and the cuda kernel's mega
    # estimate beside the per-query mega and cold paths of this phase
    engine.warm_cache()
    sync()
    ra_ms = {"mega": [], "composed": []}
    for _ in range(3):
        for f in ra_ms:
            ra_ms[f].append(timed_call(
                lambda: engine.run_all(fusion=f)) * 1e3)
    qp = plan_query(n_fact, len(names), backend="cuda", kernel="torch")
    best = {f: min(v) for f, v in ra_ms.items()}
    log(f"[plan] {smi}: run_all on the cache, {len(names)} queries: "
        f"plan_query picks {qp.fusion!r} ({qp.reason}); estimated mega "
        f"{qp.est_mega_s * 1e3:.4f} ms, composed "
        f"{qp.est_composed_s * 1e3:.4f} ms; measured (host clock, best of "
        f"3) mega {best['mega']:.3f} ms, composed {best['composed']:.3f} "
        f"ms; estimate / measured {qp.est_mega_s * 1e3 / best['mega']:.3f} "
        f"and {qp.est_composed_s * 1e3 / best['composed']:.3f}")
    if engine._plan_fusion(len(names)) != qp.fusion or \
            best[qp.fusion] > PICK_SLACK * min(best.values()):
        raise AssertionError(f"run_all's pick {qp.fusion} is not within "
                             f"{PICK_SLACK} of the fastest: {best}")
    qk = plan_query(n_fact, len(names), backend="cuda", kernel="cuda",
                    num_segments=max(
                        int(np.prod([c for *_, c in SSB_QUERIES[q].group_by]))
                        for q in names))
    mega_sum = sum(wall["mega"].values()) * 1e3
    cold_sum = sum(wall["cold"].values()) * 1e3
    log(f"[plan] {smi}: fused_query per query (kernel 'cuda'): plan_query "
        f"picks {qk.fusion!r} ({qk.reason}); estimated mega "
        f"{qk.est_mega_s * 1e3:.4f} ms against the mega path's "
        f"{mega_sum:.3f} ms ({qk.est_mega_s * 1e3 / mega_sum:.3f}), "
        f"composed {qk.est_composed_s * 1e3:.4f} ms against the cold "
        f"path's {cold_sum:.3f} ms ({qk.est_composed_s * 1e3 / cold_sum:.3f})")

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

    # -- 5b. skew-aware schedules: auto, then forced -----------------------------
    auto_eng = SSBEngine(tables, indexes=engine.indexes,
                         policy=ExecutionPolicy(schedule="auto"))
    log_plans(auto_eng, "schedule='auto'")
    if any(p.schedule != "gathered" for p in auto_eng.plans.values()):
        raise AssertionError("schedule='auto' on the CUDA kernels must keep "
                             "gathered")
    drive_paths(auto_eng, ("cached", "cold"))  # warm-up pass
    (res_x, _), got = counted(lambda: drive_paths(auto_eng,
                                                   ("cached", "cold")))
    check_counts(got, EXPECTED_CACHED_COLD, "schedule='auto' path")
    check_agree(res_x, res["cached"], ("cached", "cold"), "auto")
    log(f"[agree] schedule='auto' on the card: all {len(names)} queries, "
        "cached and cold, equal phase 4's, bit for bit")
    del auto_eng, res_x
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
        want = (EXPECTED_CACHED_COLD if sched == "deduped"
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
    log_plans(twin, "torch twin (the model's own picks)")
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

    # the delta overlay per dimension (device ms: the plain overlay_delta
    # after the main table's probe), and what compaction_plan prices
    overlay_ms, cplans = {}, {}
    for dim in DIM_PK:
        idx = effective_index(mut.indexes[dim])
        fk = fact_cols[FACT_FK[dim]]
        pr = lookup(dataclasses.replace(idx, delta=None), fk, impl="cuda")
        overlay_ms[dim] = event_ms(lambda: overlay_delta(pr, idx.delta, fk),
                                   3)
        cplans[dim] = mut.compaction_plan(dim)
        del pr
    torch.cuda.empty_cache()

    # auto_compact=True: the same ops, the card's entry deciding the folds;
    # the answers must equal the auto_compact=False engine's
    auto_c = SSBEngine(own_dims())
    for dim, dels, ups, pays, rows_new in mut_ops:
        for label, plan in (
                ("delete", auto_c.ingest(dim, dels, op="delete")),
                ("upsert", auto_c.ingest(dim, ups, pays, op="upsert"))):
            log(f"[plan] ingest({dim!r}, {label}, auto_compact=True) of "
                f"{dels.shape[0]} keys: {plan}")
        auto_c.append_rows(dim, rows_new)
        log(f"[plan] append_rows({dim!r}, auto_compact=True) of "
            f"{dels.shape[0]} rows: compactions so far "
            f"{auto_c.ingest_info()['compactions']}, delta live "
            f"{auto_c.indexes[dim].delta is not None}")
    check_agree({"auto_compact": auto_c.run_all(fusion="composed")},
                res_live["cached"], ("auto_compact",), "auto_compact=True")
    log(f"[agree] auto_compact=True ({auto_c.ingest_info()['compactions']} "
        f"compactions): all {len(names)} queries equal the "
        "auto_compact=False engine's, bit for bit")
    del auto_c
    torch.cuda.empty_cache()

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
    for dim, cp in cplans.items():
        log(f"[plan] {smi}: {dim} delta: compaction_plan {cp.compact} "
            f"({cp.reason}); overlay estimated "
            f"{cp.est_overlay_s * 1e3:.4f} ms, measured {overlay_ms[dim]:.4f} "
            f"ms (device; {cp.est_overlay_s * 1e3 / overlay_ms[dim]:.3f}); "
            f"merge estimated {cp.est_merge_s * 1e3:.4f} ms, compact "
            f"measured {compact_ms[dim]:.3f} ms (host clock; "
            f"{cp.est_merge_s * 1e3 / compact_ms[dim]:.3f})")
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
    # [plan] the planner's extend-or-reprobe prices beside the tail
    # extension and a reprobe of the whole padded column (device ms)
    fa_plans = {d: fa._fact_append_plan(d, bp, n0) for d in DIM_PK}
    split["reprobe"] = {d: event_ms(lambda d=d: fa._join(d), 3)
                        for d in DIM_PK}
    torch.cuda.empty_cache()
    for d, ap in fa_plans.items():
        log(f"[plan] {smi}: {d} fact append of {n_batch} rows: "
            f"plan_fact_append {ap.reason}; tail estimated "
            f"{ap.est_tail_s * 1e3:.4f} ms, lookup + splice measured "
            f"{split['extend'][d]:.4f} ms ("
            f"{ap.est_tail_s * 1e3 / split['extend'][d]:.3f}); reprobe "
            f"estimated {ap.est_reprobe_s * 1e3:.4f} ms, measured "
            f"{split['reprobe'][d]:.4f} ms over {fact.n_physical} rows ("
            f"{ap.est_reprobe_s * 1e3 / split['reprobe'][d]:.3f}); the "
            f"extension {split['reprobe'][d] / split['extend'][d]:.2f}x "
            "faster")
        if not ap.extend or split["extend"][d] > split["reprobe"][d]:
            raise AssertionError(f"{d}: the append plan {ap} disagrees with "
                                 "the measurement")
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

    # -- 6c. snapshots and serving --------------------------------------------
    t_6c = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    resident_6c = torch.cuda.memory_allocated()  # held from earlier phases
    rng = np.random.default_rng(args.seed + 3)
    mv = SSBEngine(tables)
    mv.warm_cache()
    sync()
    mv_ops = []       # the dimension ops, replayed on rebuilt engines
    upserted = {d: [] for d in DIM_PK}
    mvcc = {"append": {}, "compact": {}}
    launches_6c = dict(_ZERO)

    def counted6(fn):
        """``counted``, with the counts added to the phase's total."""
        out, got = counted(fn)
        for k, v in got.items():
            launches_6c[k] += v
        return out, got
    filtered = {d: sum(d in SSB_QUERIES[q].dim_filters for q in names)
                for d in DIM_PK}

    def snap_ms(reps=10):
        """ms per ``snapshot()`` on ``mv`` (each released at once)."""
        out = []
        for _ in range(reps):
            t = time.perf_counter()
            s = mv.snapshot()
            out.append((time.perf_counter() - t) * 1e3)
            s.release()
        return out

    def drive_snap(snap):
        """A snapshot's three paths: cached run_all on its frozen cache,
        cold and mega per query."""
        out = {"cached": snap.run_all(fusion="composed"),
               "cold": {q: snap.run(q, use_cache=False) for q in names},
               "mega": {q: snap.run(q, fusion="mega") for q in names}}
        sync()
        return out

    def live_expected(delta_dims, cached_probes):
        """Launches of the cached, cold and mega paths with live deltas on
        ``delta_dims``: a filtered cold probe of such a dimension takes
        probe_filter_rows_delta (two pack_bits), others probe_filter_rows;
        ``cached_probes`` probe_rows for the cached path, 4 for the cold
        path's unfiltered probes."""
        fd = sum(filtered[d] for d in delta_dims)
        return dict(_ZERO, probe_rows=cached_probes + 4,
                    probe_filter_rows=32 - fd, probe_filter_rows_delta=fd,
                    pack_bits=32 + fd, fused_query=13, pack_query_bits=13)

    def mv_append(label):
        """One append on ``mv`` (4 probe_rows), timed; returns the pin
        counters' change, whether the fact buffers moved, the report."""
        info0 = mv.snapshot_info()
        ptr0 = mv.tables["lineorder"]["orderkey"].data_ptr()
        batch = generate_fact_batch(mv.tables, n_batch, rng)
        box = []
        secs, got = counted6(lambda: timed_call(
            lambda: box.append(mv.append_fact_rows(batch))))
        rep = box[0]
        check_counts(got, EXPECTED_APPEND, f"mvcc append {label}", quiet=True)
        info = mv.snapshot_info()
        mvcc["append"][label] = round(secs * 1e3, 3)
        return (info["pin_copies"] - info0["pin_copies"],
                info["fact_gen"] - info0["fact_gen"],
                mv.tables["lineorder"]["orderkey"].data_ptr() != ptr0, rep)

    def dim_ops(dim):
        """Deletes then upserts (to rows inside the table) of
        MUTATION_FRAC of ``dim``'s keys on ``mv``, recorded for the
        replays.  No delete touches a key an earlier batch upserted (the
        host oracle resolves a delete after an upsert as the upsert)."""
        pk = mv.tables[dim][DIM_PK[dim]].cpu().numpy()
        n = pk.shape[0]
        k = max(1, int(n * MUTATION_FRAC))
        pool = np.setdiff1d(pk, np.asarray(upserted[dim], pk.dtype))
        dels = rng.choice(pool, k, replace=False).astype(np.int32)
        ups = rng.choice(pk, k, replace=False).astype(np.int32)
        pays = rng.integers(0, n, k, dtype=np.int32)
        mv.ingest(dim, dels, op="delete", auto_compact=False)
        mv.ingest(dim, ups, pays, op="upsert", auto_compact=False)
        mv_ops.append(("ingest", dim, dels, ups, pays))
        upserted[dim].extend(ups.tolist())

    def compact_mv(dim, label):
        secs = timed_call(lambda: mv.compact(dim))
        mvcc["compact"][label] = round(secs * 1e3, 3)
        mv_ops.append(("compact", dim))

    def replay(eng):
        for op in mv_ops:
            if op[0] == "ingest":
                _, dim, dels, ups, pays = op
                eng.ingest(dim, dels, op="delete", auto_compact=False)
                eng.ingest(dim, ups, pays, op="upsert", auto_compact=False)
            else:
                eng.compact(op[1])

    mvcc["snapshot_ms"] = snap_ms()
    s0 = mv.snapshot()
    # the first append grows the capacity (fresh buffers whatever the
    # pins); the second writes those in place: S0 pins an older generation
    pc, gen, moved, rep = mv_append("growth, S0 live")
    if (pc, gen, moved, rep["capacity_grew"]) != (0, 1, True, True):
        raise AssertionError(f"first append: pin copies {pc}, fact gen "
                             f"+{gen}, moved {moved}, {rep}")
    pc, gen, moved, rep = mv_append("in place, S0 on an older generation")
    if (pc, gen, moved, rep["capacity_grew"]) != (0, 0, False, False):
        raise AssertionError(f"second append: pin copies {pc}, fact gen "
                             f"+{gen}, moved {moved}, {rep}")
    dim_ops("part")
    dim_ops("customer")
    planes = mv.indexes["part"].table.keys
    planes_copy = planes.clone()
    pc0 = mv.snapshot_info()["pin_copies"]
    compact_mv("part", "swap (pinned by S0)")
    if mv.snapshot_info()["pin_copies"] != pc0 + 1 or \
            mv.indexes["part"].table.keys is planes or \
            not torch.equal(planes, planes_copy):
        raise AssertionError("the pinned compaction did not swap")
    del planes_copy
    # S0 answers as phase 4, on every path
    res_s0, got = counted6(lambda: drive_snap(s0))
    check_counts(got, dict(EXPECTED_LAUNCHES, probe_rows=4),
                 "mvcc: S0 after the mutations")
    check_agree(res_s0, res["cached"], ("cached", "cold", "mega"),
                "S0 against phase 4")
    log(f"[agree] S0 (epoch {s0.epoch}, lag {s0.epoch_lag()}): all "
        f"{len(names)} queries, cached, cold and mega, equal phase 4's, "
        "bit for bit")
    # the head, then S1 on its image
    (res_head, _), got = counted6(lambda: drive_paths(mv, PATHS))
    want_head = live_expected(("customer",), 4)
    check_counts(got, want_head, "mvcc: head, customer's delta live")
    s1 = mv.snapshot()
    res_s1, got = counted6(lambda: drive_snap(s1))
    check_counts(got, live_expected(("customer",), 0), "mvcc: S1")
    rebuilt = rebuilt_answers(mv, replay)
    check_agree(res_head, rebuilt, ("cached", "cached_warm", "cold", "mega"),
                "head against the rebuilt engine")
    check_agree(res_s1, rebuilt, ("cached", "cold", "mega"),
                "S1 against the rebuilt engine")
    log(f"[agree] head and S1 (epoch {s1.epoch}): all {len(names)} queries, "
        "every path, equal an engine rebuilt on the trimmed tables with "
        "the same dimension ops, bit for bit")
    pc, gen, moved, _ = mv_append("pinned copy, S1 live")
    if (pc, gen, moved) != (1, 1, True):
        raise AssertionError(f"pinned append: pin copies {pc}, fact gen "
                             f"+{gen}, moved {moved}")
    res_s1b, _ = counted6(lambda: drive_snap(s1))
    check_agree(res_s1b, rebuilt, ("cached", "cold", "mega"),
                "S1 after a pinned append")
    del res_s0, res_s1, res_s1b, rebuilt
    s0.release()
    s1.release()
    if mv.snapshot_info()["live_snapshots"] != 0:
        raise AssertionError("snapshots still live after release")
    pc, gen, moved, _ = mv_append("in place, released")
    if (pc, gen, moved) != (0, 0, False):
        raise AssertionError(f"append after release: pin copies {pc}, fact "
                             f"gen +{gen}, moved {moved}")
    dim_ops("part")
    planes = mv.indexes["part"].table.keys
    pc0 = mv.snapshot_info()["pin_copies"]
    compact_mv("part", "in place")
    if mv.snapshot_info()["pin_copies"] != pc0 or \
            mv.indexes["part"].table.keys is not planes:
        raise AssertionError("the unpinned compaction did not write in "
                             "place")
    (res_ip, _), got = counted6(lambda: drive_paths(mv, PATHS))
    check_counts(got, want_head, "mvcc: head after the in-place compaction")
    check_agree(res_ip, rebuilt_answers(mv, replay),
                ("cached", "cached_warm", "cold", "mega"),
                "in-place compaction against the rebuilt engine")
    log(f"[agree] after release, an in-place append and an in-place "
        f"compaction: all {len(names)} queries, every path, equal a "
        "rebuilt engine's, bit for bit")
    # background compaction's two halves: publish, then a conflict
    t = time.perf_counter()
    prep = mv.prepare_compact("customer")
    sync()
    mvcc["prepare_ms"] = round((time.perf_counter() - t) * 1e3, 3)
    epoch = mv.epoch
    t = time.perf_counter()
    if not mv.publish_compact(prep) or mv.epoch != epoch + 1 or \
            mv.indexes["customer"].delta is not None:
        raise AssertionError("publish_compact on a fresh delta did not "
                             "publish")
    mvcc["publish_ms"] = round((time.perf_counter() - t) * 1e3, 3)
    mv_ops.append(("compact", "customer"))
    dim_ops("supplier")
    prep = mv.prepare_compact("supplier")
    dim_ops("supplier")
    if mv.publish_compact(prep) is not False:
        raise AssertionError("a conflicting ingest did not stop the publish")
    log("[mvcc] prepare_compact/publish_compact: customer published "
        f"(epoch {epoch} -> {epoch + 1}); supplier's publish refused after "
        "a conflicting ingest; supplier's delta stays live")
    del prep, res_ip
    mvcc["peak"] = torch.cuda.max_memory_allocated()

    # -- serving: the batch flavor (the engine's composed policy) and mega
    from repro_torch.serving import (PARAM_QUERIES, BatchRunner,
                                     LogicalModel, QueryScheduler,
                                     ServeConfig)
    prng = np.random.default_rng(args.seed + 3)
    per_query = 8
    requests = [(q, PARAM_QUERIES[q].sample(prng)) for q in names
                for _ in range(per_query)]
    mv.invalidate_probe_cache()  # the pinned snapshot probes lazily
    ref_snap = mv.snapshot()
    composed = {}
    for q, p in requests:
        [composed[(q, p)]] = BatchRunner().run_batch(ref_snap, q, [p],
                                                     flavor="composed")
    serve = {"rps": {}, "ms": {}}

    def check_clean(info, tickets, label):
        """No retry, failure, composed fallback, rejection, timeout, dead
        worker, breaker trip or degraded response: the scheduler retries a
        failed launch and ladders to the composed flavor, which would
        hide a kernel fault behind a right answer."""
        bad = {k: info[k] for k in ("retries", "failed", "composed_batches",
                                    "rejected", "timed_out",
                                    "refresh_failures", "worker_deaths",
                                    "breaker_trips") if info[k] != 0}
        degraded = sum(tk.response.degraded for tk in tickets)
        if bad or degraded or info["breakers_open"]:
            raise AssertionError(f"serving {label}: {json.dumps(bad)}, "
                                 f"{degraded} degraded responses, breakers "
                                 f"open {info['breakers_open']}")
    mv_mega = SSBEngine(mv.tables, indexes=mv.indexes,
                        policy=ExecutionPolicy(fusion="mega"))
    joined = sum(len(SSB_QUERIES[q].joined_dims()) for q in names)
    # one batched_tail launch per dispatch on both flavors
    for label, eng, want in (
            ("batch", mv, dict(_ZERO, probe_rows=len(DIM_PK),
                               batched_tail=len(names))),
            ("mega", mv_mega, dict(_ZERO, probe_rows=joined,
                                   batched_tail=len(names)))):
        sched = QueryScheduler(eng, ServeConfig(max_queue=len(requests)))
        tickets = [sched.submit(q, p) for q, p in requests]
        t = time.perf_counter()
        _, got = counted6(sched.pump)
        sync()
        secs = time.perf_counter() - t
        check_counts(got, want, f"serving, {label} flavor")
        info = sched.info()
        sched.close()
        if info["batches"] != len(names) or info["completed"] != \
                len(requests):
            raise AssertionError(f"serving {label}: {json.dumps(info)}")
        check_clean(info, tickets, label)
        for tk, (q, p) in zip(tickets, requests):
            r = tk.response
            total, groups = composed[(q, p)]
            if not r.ok or r.total != total or \
                    not np.array_equal(r.groups, groups):
                raise AssertionError(f"serving {label}: {q}{p} differs from "
                                     f"the composed flavor ({r.status})")
        serve["rps"][label] = len(requests) / secs
    del mv_mega
    log(f"[agree] serving: {len(requests)} requests ({per_query} sampled "
        f"parameter vectors x {len(names)} queries) on the batch and mega "
        "flavors equal the composed flavor's, bit for bit")
    model = LogicalModel(mv.tables)
    for op in mv_ops:
        if op[0] == "ingest":
            _, dim, dels, ups, pays = op
            model.delete_keys(dim, dels)
            for k, r in zip(ups.tolist(), pays.tolist()):
                model.repoint(dim, k, r)
    for q, p in requests:
        if q in ("Q1.1", "Q2.1"):
            total, groups = model.param_query(q, p)
            if total != composed[(q, p)][0] or \
                    not np.array_equal(groups, composed[(q, p)][1]):
                raise AssertionError(f"{q}{p} differs from LogicalModel")
    del model
    log(f"[numpy] serving: Q1.1 and Q2.1 at all {2 * per_query} sampled "
        "parameter vectors equal LogicalModel on the host arrays")
    for f in ("batch", "mega", "composed"):
        for w in (1, 4, 8):
            per = {}
            for q in ("Q1.1", "Q2.1", "Q3.1", "Q4.3"):
                ps = [p for q2, p in requests if q2 == q][:w]
                BatchRunner().run_batch(ref_snap, q, ps, flavor=f)
                sync()
                per[q] = round(min(timed_call(lambda: BatchRunner().run_batch(
                    ref_snap, q, ps, flavor=f)) for _ in range(2)) * 1e3, 3)
            serve["ms"][(f, w)] = per
    n_rows_6c = ref_snap.tables["lineorder"].n_rows
    ref_snap.release()
    for w in (1, 8):
        est = costmodel.batch_serve_seconds(w, n_rows_6c,
                                            backend="cuda") * 1e3
        meas = serve["ms"][("batch", w)]
        log(f"[plan] {smi}: batch dispatch of width {w} over {n_rows_6c} "
            f"rows: estimated {est:.4f} ms; measured (wall ms) "
            f"{json.dumps(meas)}; estimate / measured "
            f"{min(est / v for v in meas.values()):.3f} to "
            f"{max(est / v for v in meas.values()):.3f}")
    # a second pass with a background compaction of customer's delta
    dim_ops("customer")
    snaps = {mv.epoch: mv.snapshot()}
    sched = QueryScheduler(mv, ServeConfig(max_queue=len(requests)))
    half = len(requests) // 2
    tickets = [sched.submit(q, p) for q, p in requests[:half]]
    bg = sched.compact_in_background("customer")
    _, got_bg = counted6(sched.pump)
    tickets += [sched.submit(q, p) for q, p in requests[half:]]
    bg.join(timeout=120.0)
    if bg.is_alive():
        raise AssertionError("the background compaction did not finish")
    _, got = counted6(sched.pump)
    for k, v in got.items():
        got_bg[k] += v
    info = sched.info()
    sched.close()
    snaps[mv.epoch] = mv.snapshot()
    if info["bg_compactions"] != 1 or info["bg_compact_conflicts"] != 0 \
            or mv.indexes["customer"].delta is not None:
        raise AssertionError(f"background compaction: {json.dumps(info)}")
    check_clean(info, tickets, "beside compact_in_background")
    # each snapshot the scheduler pinned probes, once, every dimension the
    # queries it answered join (the merge itself launches no kernel)
    joined_at = {}
    for tk, (q, p) in zip(tickets, requests):
        joined_at.setdefault(tk.response.epoch, set()).update(
            SSB_QUERIES[q].joined_dims())
    check_counts(got_bg, dict(_ZERO, probe_rows=sum(
        len(d) for d in joined_at.values()), batched_tail=info["batches"]),
        "serving beside compact_in_background")
    lags = {}
    for tk, (q, p) in zip(tickets, requests):
        r = tk.response
        if not r.ok or r.epoch not in snaps:
            raise AssertionError(f"background pass: {q}{p} {r.status} at "
                                 f"epoch {r.epoch}")
        [(total, groups)] = BatchRunner().run_batch(snaps[r.epoch], q, [p],
                                                    flavor="composed")
        if r.total != total or not np.array_equal(r.groups, groups):
            raise AssertionError(f"background pass: {q}{p} differs from "
                                 f"the snapshot at its epoch {r.epoch}")
        key = f"epoch {r.epoch} lag {r.epoch_lag}"
        lags[key] = lags.get(key, 0) + 1
    for s in snaps.values():
        s.release()
    serve["bg"] = lags
    log(f"[agree] serving beside compact_in_background('customer'): all "
        f"{len(tickets)} responses ok and equal to the snapshot at their "
        f"epoch, bit for bit: {json.dumps(lags)}")
    del mv, snaps
    torch.cuda.empty_cache()
    secs_6c = time.perf_counter() - t_6c
    log(f"[mvcc] {smi}: ms per snapshot() on a warm SF{args.sf:g} engine "
        f"({len(mvcc['snapshot_ms'])} calls): "
        f"{json.dumps([round(x, 4) for x in mvcc['snapshot_ms']])}")
    log(f"[mvcc] {smi}: ms per append_fact_rows of {n_batch} rows (host "
        f"clock ending in synchronize): {json.dumps(mvcc['append'])}")
    log(f"[mvcc] {smi}: ms per compact('part') (host clock): "
        f"{json.dumps(mvcc['compact'])}; prepare_compact('customer') "
        f"{mvcc['prepare_ms']} ms, publish_compact {mvcc['publish_ms']} ms")
    log(f"[mvcc] peak allocated over phase 6c: {mvcc['peak']} bytes "
        f"({mvcc['peak'] / 2**30:.3f} GiB), of which {resident_6c} bytes "
        f"({resident_6c / 2**30:.3f} GiB) were held from earlier phases "
        f"when it began; over the static main path: {peak} bytes "
        f"({peak / 2**30:.3f} GiB)")
    log(f"[serve] {smi}: requests per second through QueryScheduler.pump "
        f"({len(requests)} requests, {len(names)} dispatches, host clock "
        f"ending in synchronize): "
        f"{json.dumps({k: round(v, 2) for k, v in serve['rps'].items()})}")
    for (f, w), per in serve["ms"].items():
        log(f"[serve] {smi}: {f} flavor, width {w}: wall ms per dispatch "
            f"(best of 2): {json.dumps(per)}")
    log(f"[launches] phase 6c in all (MVCC reads and appends, both serving "
        f"pumps): {json.dumps(launches_6c)}")
    log(f"[6c] snapshots and serving: {secs_6c:.1f} s")

    # -- 6d. maintained views --------------------------------------------------
    from repro_torch.ivm import MaintainedSuite
    t_6d = time.perf_counter()
    rng = np.random.default_rng(args.seed + 4)
    iv = SSBEngine(own_dims())
    iv.warm_cache()
    sync()
    ivm = {"events": []}
    t = time.perf_counter()
    suite = MaintainedSuite.attach(iv)
    ivm["attach_s"] = time.perf_counter() - t

    def check_suite(full, label):
        """The suite is fresh and equals ``full`` (13 answers) bit for
        bit."""
        if not suite.fresh_at(iv.epoch):
            raise AssertionError(f"maintained views ({label}) not fresh: "
                                 f"valid {suite.valid}, epoch {suite.epoch} "
                                 f"vs {iv.epoch}")
        got = suite.results()
        for q in names:
            total, groups = full[q]
            if got[q][0] != int(total) or \
                    not np.array_equal(got[q][1], groups.cpu().numpy()):
                raise AssertionError(f"maintained {q} ({label}) differs "
                                     "from run_all")

    check_suite(iv.run_all(), "attach, run_all with the default policy")

    def iv_event(label, fn):
        """One mutation: its maintenance ms and rows touched (the suite's
        counters), then run_all(fusion="composed") timed (the recompute
        the event forces) and held against the suite."""
        st0 = dict(suite.stats)
        fn()
        sync()
        t = time.perf_counter()
        full = iv.run_all(fusion="composed")
        sync()
        rec = time.perf_counter() - t
        check_suite(full, label)
        ivm["events"].append({
            "event": label,
            "maintain_ms": round((suite.stats["maintain_s"]
                                  - st0["maintain_s"]) * 1e3, 3),
            "rows_touched": suite.stats["rows_touched"]
            - st0["rows_touched"],
            "recompute_ms": round(rec * 1e3, 3)})

    def iv_dim_ops(dim):
        """Deletes then upserts of MUTATION_FRAC of ``dim``'s keys."""
        pk = iv.tables[dim][DIM_PK[dim]].cpu().numpy()
        n = pk.shape[0]
        k = max(1, int(n * MUTATION_FRAC))
        dels = rng.choice(pk, k, replace=False).astype(np.int32)
        ups = rng.choice(pk, k, replace=False).astype(np.int32)
        pays = rng.integers(0, n, k, dtype=np.int32)
        iv_event(f"ingest delete {dim} ({k} keys)", lambda: iv.ingest(
            dim, dels, op="delete", auto_compact=False))
        iv_event(f"ingest upsert {dim} ({k} keys)", lambda: iv.ingest(
            dim, ups, pays, op="upsert", auto_compact=False))

    iv_event(f"append_fact_rows ({n_batch} rows)", lambda: iv.append_fact_rows(
        generate_fact_batch(iv.tables, n_batch, rng)))
    snap = iv.snapshot()
    if snap.maintained is None:
        raise AssertionError("a snapshot of a fresh suite froze no answers")
    frozen = {q: (t, g.copy()) for q, (t, g) in snap.maintained.items()}
    iv_event(f"append_fact_rows ({n_batch} rows)", lambda: iv.append_fact_rows(
        generate_fact_batch(iv.tables, n_batch, rng)))
    at_snap = snap.run_all(fusion="composed")
    for q in names:
        if snap.maintained[q][0] != frozen[q][0] or \
                frozen[q][0] != int(at_snap[q][0]) or \
                not np.array_equal(frozen[q][1], at_snap[q][1].cpu().numpy()):
            raise AssertionError(f"the snapshot's frozen {q} moved or "
                                 "differs from its run_all")
    snap.release()
    log(f"[agree] maintained views: a snapshot froze all {len(names)} "
        "answers; after the next append they equal the snapshot's run_all")
    iv_dim_ops("part")
    iv_dim_ops("customer")
    n = iv.tables["supplier"].n_rows
    k = max(1, int(n * MUTATION_FRAC))
    src = rng.integers(0, n, k)
    rows_new = {c: v.cpu().numpy()[src]
                for c, v in iv.tables["supplier"].columns.items()}
    rows_new["suppkey"] = np.arange(n, n + k, dtype=np.int32)
    iv_event(f"append_rows supplier ({k} rows)", lambda: iv.append_rows(
        "supplier", rows_new, auto_compact=False))
    iv_event("compact part", lambda: iv.compact("part"))
    tbl = iv.indexes["date"].table
    iv.table_update("date", [0], tbl.keys[:1].clone(), tbl.values[:1].clone())
    if suite.valid or suite.stats["invalidations"] != 1:
        raise AssertionError("table_update did not invalidate the suite")
    t = time.perf_counter()
    suite.rebuild()
    ivm["rebuild_s"] = time.perf_counter() - t
    check_suite(iv.run_all(fusion="composed"), "rebuilt")
    log(f"[agree] maintained views at SF{args.sf:g}: after each of "
        f"{len(ivm['events'])} events, and rebuilt after a table_update "
        f"invalidated them, all {len(names)} answers equal run_all, bit "
        "for bit")
    # serving: canonical requests from the frozen views, the rest batched
    prng = np.random.default_rng(args.seed + 4)
    reqs = [(q, None) for q in names] + [
        (q, PARAM_QUERIES[q].sample(prng)) for q in names
        for _ in range(IVM_SAMPLED)]
    canonical = sum(p is None or tuple(p) == PARAM_QUERIES[q].defaults
                    for q, p in reqs)
    ref_snap = iv.snapshot()
    want = {i: BatchRunner().run_batch(
        ref_snap, q, [PARAM_QUERIES[q].defaults if p is None else p],
        flavor="composed")[0] for i, (q, p) in enumerate(reqs)}
    sched = QueryScheduler(iv, ServeConfig(max_queue=len(reqs)))
    tickets = [sched.submit(q, p) for q, p in reqs]
    t = time.perf_counter()
    sched.pump()
    sync()
    ivm["serve_s"] = time.perf_counter() - t
    info = sched.info()
    sched.close()
    check_clean(info, tickets, "maintained views")
    if info["maintained_served"] != canonical or \
            info["completed"] != len(reqs):
        raise AssertionError(f"maintained serving: {json.dumps(info)}, "
                             f"{canonical} canonical requests")
    for i, tk in enumerate(tickets):
        r = tk.response
        total, groups = want[i]
        if not r.ok or r.epoch != ref_snap.epoch or r.total != total or \
                not np.array_equal(r.groups, groups):
            raise AssertionError(f"maintained serving: {reqs[i]} differs "
                                 "from the composed flavor")
    ref_snap.release()
    log(f"[agree] maintained serving: {len(reqs)} requests, "
        f"{info['maintained_served']} answered from the maintained views "
        f"(the {canonical} canonical ones), {info['batches']} dispatches "
        "for the rest, all equal the composed flavor, bit for bit")
    suite.detach()
    del suite, iv, sched, tickets, want
    torch.cuda.empty_cache()
    secs_6d = time.perf_counter() - t_6d
    log(f"[ivm] {smi}: MaintainedSuite.attach at SF{args.sf:g} "
        f"({n_fact} fact rows): {ivm['attach_s']:.3f} s; rebuild "
        f"{ivm['rebuild_s']:.3f} s")
    for ev in ivm["events"]:
        log(f"[ivm] {smi}: {ev['event']}: maintained in "
            f"{ev['maintain_ms']} ms, {ev['rows_touched']} rows touched; "
            f"recompute (run_all composed after it) {ev['recompute_ms']} ms")
    log(f"[ivm] {smi}: serving {len(reqs)} requests "
        f"({info['maintained_served']} maintained): {ivm['serve_s']:.3f} s, "
        f"{len(reqs) / ivm['serve_s']:.2f} requests/s")
    log(f"[6d] maintained views: {secs_6d:.1f} s")

    # -- 6e. durability -------------------------------------------------------
    import shutil
    import tempfile
    from repro_torch.durability import (CrashPoint, FailpointFS, boom_on,
                                        checkpoint_crash_sites, engine_state,
                                        read_records, state_nbytes)
    from repro_torch.durability.manager import WAL_NAME
    t_6e = time.perf_counter()
    rng = np.random.default_rng(args.seed + 5)
    launches_6e = dict(_ZERO)
    dur = {"ms": {}, "plans": [], "recovery": {}}

    def dim_ops_6e(t):
        """The stream's dimension mutations over ``t``'s dimension tables:
        deletes then upserts of MUTATION_FRAC of part's and customer's
        keys, an append of MUTATION_FRAC of supplier's rows (new keys),
        then compact("part"); customer's and supplier's deltas stay live
        (``auto_compact=False``), so recovery restores and replays them."""
        ops = []
        for dim in ("part", "customer"):
            pk = t[dim][DIM_PK[dim]].cpu().numpy()
            n = pk.shape[0]
            k = max(1, int(n * MUTATION_FRAC))
            ops.append(("delete", dim, rng.choice(pk, k, replace=False)
                        .astype(np.int32)))
            ops.append(("upsert", dim, (rng.choice(pk, k, replace=False)
                                        .astype(np.int32),
                                        rng.integers(0, n, k,
                                                     dtype=np.int32))))
        n = t["supplier"].n_rows
        k = max(1, int(n * MUTATION_FRAC))
        src = rng.integers(0, n, k)
        cols = {c: v.cpu().numpy()[src]
                for c, v in t["supplier"].columns.items()}
        cols["suppkey"] = np.arange(n, n + k, dtype=np.int32)
        ops.append(("append_rows", "supplier", cols))
        ops.append(("compact", "part", None))
        return ops

    def apply_6e(eng, op):
        kind, dim, data = op
        if kind == "append_fact_rows":
            eng.append_fact_rows(data)
        elif kind == "delete":
            eng.ingest(dim, data, op="delete", auto_compact=False)
        elif kind == "upsert":
            eng.ingest(dim, data[0], data[1], op="upsert",
                       auto_compact=False)
        elif kind == "append_rows":
            eng.append_rows(dim, data, auto_compact=False)
        else:
            eng.compact(dim)

    base_6e = own_dims()
    facts = [generate_fact_batch(base_6e, n_batch, rng) for _ in range(9)]
    head = [("append_fact_rows", None, b) for b in facts[:6]] + \
        dim_ops_6e(base_6e)
    tail = [("append_fact_rows", None, b) for b in facts[6:8]]
    # the roots go where the disk has most room: the temporary directory
    # or a git-ignored directory beside this script
    spots = [tempfile.gettempdir(), str(Path(__file__).resolve().parent)]
    spot = max(spots, key=lambda p: shutil.disk_usage(p).free)
    dur_dir = tempfile.mkdtemp(prefix=".durable_", dir=spot)
    try:
        vol = SSBEngine(own_dims())
        de = SSBEngine(own_dims())
        vol.warm_cache()
        de.warm_cache()
        sync()
        state_b = state_nbytes(de)
        free = shutil.disk_usage(dur_dir).free
        log(f"[durable] roots under {dur_dir}: {free} bytes free "
            f"(candidates: " + ", ".join(
                f"{p} {shutil.disk_usage(p).free}" for p in spots)
            + f"); state_nbytes {state_b}")
        if free < 3 * state_b:
            raise AssertionError(f"{free} bytes free under {dur_dir}, fewer "
                                 f"than 3x the checkpoint's {state_b}")
        root1 = os.path.join(dur_dir, "r1")
        t = time.perf_counter()
        mgr = de.persist(root1, keep=2)
        dur["genesis_s"] = time.perf_counter() - t
        dur["genesis"] = dict(mgr.last_checkpoint)

        def step(op):
            """One mutation on the durable engine and on the volatile
            twin, each timed by the host clock ending in a synchronize;
            the checkpoint decision after it."""
            b0 = mgr.bytes_logged
            ms_d = timed_call(lambda: apply_6e(de, op)) * 1e3
            ms_v = timed_call(lambda: apply_6e(vol, op)) * 1e3
            dur["ms"].setdefault(op[0], []).append(
                (ms_d, ms_v, mgr.bytes_logged - b0))
            p = mgr.last_plan
            dur["plans"].append((op[0], op[1], de.epoch, p))
            if de.epoch != vol.epoch:
                raise AssertionError(f"durable epoch {de.epoch} != volatile "
                                     f"{vol.epoch} after {op[:2]}")

        for op in head:
            step(op)
        want_pc = vol.run_all(fusion="composed")
        n_pc = de.epoch
        t = time.perf_counter()
        mgr.checkpoint(de)
        dur["forced_s"] = time.perf_counter() - t
        dur["forced"] = dict(mgr.last_checkpoint)
        for op in tail:
            step(op)
        want_final = vol.run_all(fusion="composed")
        sync()
        info1 = mgr.info()
        de.close()
        del de
        torch.cuda.empty_cache()

        def live_counts(live):
            """The fixed launches of the four paths when the dimensions
            ``live`` maps to True hold a live delta: phase 6's live counts
            on such a dimension, phase 4's on the others."""
            want = dict(_ZERO, probe_rows=4 + len(unfiltered),
                        fused_query=len(names), pack_query_bits=len(names))
            for q in names:
                for d in SSB_QUERIES[q].dim_filters:
                    k = ("probe_filter_rows_delta" if live[d]
                         else "probe_filter_rows")
                    want[k] += 1
                    want["pack_bits"] += 2 if live[d] else 1
            return want

        for flag, ref in ((True, EXPECTED_LIVE), (False, EXPECTED_LAUNCHES)):
            if live_counts(dict.fromkeys(DIM_PK, flag)) != ref:
                raise AssertionError("the live-count rule does not give "
                                     "phase 4's and phase 6's counts")

        def check_recovered(rec, want, label, root, fs=None):
            """A recovered engine: its epoch is the surviving record count;
            its four paths (cached, cold, mega, and a kernel="torch"
            engine on its state) equal ``want`` bit for bit, with the fixed
            launches; probe_filter_rows_delta and fused_query against their
            plain versions on its operands."""
            n_rec = len(read_records(os.path.join(root, WAL_NAME), fs))
            if rec.epoch != n_rec:
                raise AssertionError(f"{label}: epoch {rec.epoch}, "
                                     f"{n_rec} surviving records")
            drive_paths(rec, PATHS)  # warm-up pass
            (res_r, _), got = counted(lambda: drive_paths(rec, PATHS))
            for k, v in got.items():
                launches_6e[k] += v
            live = {d: rec.indexes[d].delta is not None for d in DIM_PK}
            check_counts(got, live_counts(live), f"{label}, four paths")
            tw = SSBEngine(rec.tables, indexes=rec.indexes,
                           policy=ExecutionPolicy(kernel="torch"))
            res_r["torch"] = tw.run_all(fusion="composed")
            del tw
            check_agree(res_r, want, ("cached", "cached_warm", "cold",
                                      "mega", "torch"), label)
            for dim in DIM_PK:
                if not live[dim]:
                    continue
                idx = effective_index(rec.indexes[dim])
                tbl, dl = idx.table, idx.delta
                fk = rec.tables["lineorder"][FACT_FK[dim]]
                dmask = SSB_QUERIES[FILTER_QUERY[dim]].dim_filters[dim](
                    rec.tables[dim])
                check_probe_kernel(
                    "probe_filter_rows_delta",
                    (tbl.keys, tbl.values, slot_predicate(tbl, dmask),
                     encode(idx.dictionary, fk), tbl.hash_mode, dl.keys,
                     delta_slot_words(dl, dmask), fk, dl.hash_mode), (3, 7),
                    dim, 2 * tbl.bucket_width + 2 * dl.bucket_width + 8,
                    timed=False)
            check_fused(rec, label, timed=False)
            r = dict(rec.durability.recovery)
            dur["recovery"][label] = r
            log(f"[agree] {label}: epoch {rec.epoch} = {n_rec} surviving "
                f"records ({r['records_replayed']} replayed past the "
                f"checkpoint at epoch {r['checkpoint_epoch']}); all "
                f"{len(names)} queries, cached, cold, mega and a "
                "kernel='torch' engine on the recovered state, equal the "
                "volatile engine over the surviving prefix, bit for bit; "
                f"launches {json.dumps(got)}; live deltas "
                f"{sorted(d for d, v in live.items() if v)}; "
                "probe_filter_rows_delta and fused_query bit-identical to "
                "their plain versions on the recovered operands")
            torch.cuda.empty_cache()

        # (a) after a clean close()
        rec_a = SSBEngine.open(root1, device="cuda", keep=2)
        check_recovered(rec_a, want_final, "recovery (a), clean close",
                        root1)

        # (c) a kill at a leaf write of the forced checkpoint, then (b) a
        # kill after the fsync of the last fact append's record, on a
        # second root whose log goes through a FailpointFS
        fs = FailpointFS(np.random.default_rng(args.seed + 5))
        root2 = os.path.join(dur_dir, "r2")
        d2 = SSBEngine(own_dims())
        mgr2 = d2.persist(root2, fs=fs, keep=2)
        for op in head:
            apply_6e(d2, op)
        n_logged = len(read_records(os.path.join(root2, WAL_NAME), fs))
        tree, _ = engine_state(d2)
        n_leaves = sum(len(v) for grp in tree.values() for v in grp.values())
        del tree
        # the kill lands at the write of the middle leaf
        steps_before = mgr2.ckpt.steps()
        with checkpoint_crash_sites(boom_on("ckpt_save", nth=n_leaves // 2)):
            try:
                mgr2.checkpoint(d2)
            except CrashPoint as e:
                killed = str(e)
            else:
                raise AssertionError("the checkpoint kill did not fire")
        if mgr2.ckpt.steps() != steps_before:
            raise AssertionError(f"the killed save left steps "
                                 f"{mgr2.ckpt.steps()}, not {steps_before}")
        del d2, mgr2
        torch.cuda.empty_cache()
        rec_c = SSBEngine.open(root2, fs=fs, device="cuda", keep=2)
        if rec_c.epoch != n_pc or rec_c.durability.recovery[
                "checkpoint_epoch"] != steps_before[-1]:
            raise AssertionError(f"recovery (c): epoch {rec_c.epoch}, "
                                 f"checkpoint "
                                 f"{rec_c.durability.recovery}")
        log(f"[durable] recovery (c): {killed} (of {n_leaves} leaves); "
            f"{n_logged} records in the log; the steps before it stay "
            f"({steps_before}) and the replay covers every record past "
            f"epoch {steps_before[-1]}")
        check_recovered(rec_c, want_pc, "recovery (c), killed checkpoint",
                        root2, fs)
        rec_c.durability.checkpoint(rec_c)
        apply_6e(rec_c, tail[0])
        fs.arm(0, "after", site="fsync")
        try:
            apply_6e(rec_c, tail[1])
        except CrashPoint as e:
            killed = str(e)
        else:
            raise AssertionError("the log kill did not fire")
        fs.disarm()
        if rec_c.epoch != n_pc + 1:
            raise AssertionError("the killed append published its epoch")
        del rec_c
        torch.cuda.empty_cache()
        rec_b = SSBEngine.open(root2, fs=fs, device="cuda", keep=2)
        log(f"[durable] recovery (b): {killed}; the record is durable, its "
            f"epoch {n_pc + 2} was never published, and it replays")
        check_recovered(rec_b, want_final,
                        "recovery (b), killed after the record's fsync",
                        root2, fs)
        rec_b.close()
        del rec_b
        torch.cuda.empty_cache()

        # (a) takes one more append: logged, and it answers as the twin
        wal_a = rec_a.durability.wal.size
        _, got = counted(lambda: apply_6e(
            rec_a, ("append_fact_rows", None, facts[8])))
        for k, v in got.items():
            launches_6e[k] += v
        check_counts(got, EXPECTED_APPEND, "recovery (a), one more append")
        apply_6e(vol, ("append_fact_rows", None, facts[8]))
        if rec_a.durability.records_logged != 1 or \
                rec_a.durability.wal.size <= wal_a:
            raise AssertionError("the append after recovery was not logged")
        res_a9, got = counted(lambda: rec_a.run_all(fusion="composed"))
        for k, v in got.items():
            launches_6e[k] += v
        check_agree({"recovered": res_a9}, vol.run_all(fusion="composed"),
                    ("recovered",), "recovery (a), one more append")
        log(f"[agree] recovery (a) after one more append (logged, "
            f"{rec_a.durability.wal.size - wal_a} WAL bytes): all "
            f"{len(names)} queries equal the volatile engine's, bit for bit")
        rec_a.close()
        del rec_a, vol
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(dur_dir)
    secs_6e = time.perf_counter() - t_6e

    # [durable] and [plan] lines
    for mkind, rows_ in dur["ms"].items():
        d_ms = [r[0] for r in rows_]
        v_ms = [r[1] for r in rows_]
        log(f"[durable] {smi}: {mkind} x{len(rows_)}: durable ms "
            f"{json.dumps([round(x, 3) for x in d_ms])}, volatile ms "
            f"{json.dumps([round(x, 3) for x in v_ms])}; median durable / "
            f"volatile {np.median(d_ms) / np.median(v_ms):.3f}; WAL bytes "
            f"per record {json.dumps(sorted({r[2] for r in rows_}))}")
    for label in ("genesis", "forced"):
        c = dur[label]
        log(f"[durable] {smi}: {label} checkpoint (epoch {c['epoch']}): "
            f"{c['bytes']} bytes in {dur[label + '_s']:.3f} s: device to "
            f"host {c['d2h_s']:.3f} s, CRC32 {c['crc_s']:.3f} s, writes "
            f"with fsync {c['write_s']:.3f} s, rename {c['rename_s']:.4f} s; "
            f"disk write rate {c['bytes'] / c['write_s'] / 1e9:.3f} GB/s "
            f"(the cost model's CKPT_DISK_BYTES_PER_S "
            f"{costmodel.CKPT_DISK_BYTES_PER_S / 1e9:.3f} GB/s); engine lock "
            f"held {c['lock_s']:.3f} s")
        log(f"[plan] {smi}: checkpoint_write_seconds({state_b}) "
            f"{costmodel.checkpoint_write_seconds(state_b):.3f} s beside the "
            f"measured {label} save {dur[label + '_s']:.3f} s")
    for label, r in dur["recovery"].items():
        per = r["replay_s"] / max(1, r["records_replayed"])
        log(f"[durable] {smi}: {label}: load with CRC {r['load_s']:.3f} s, "
            f"host to device and build {r['build_s']:.3f} s, replay "
            f"{r['replay_s']:.3f} s for {r['records_replayed']} records "
            f"({per * 1e3:.3f} ms per record)")
    log_b = info1["bytes_logged"] / max(1, info1["records_logged"])
    r = dur["recovery"]["recovery (c), killed checkpoint"]
    est = costmodel.wal_replay_seconds(int(log_b), 1, backend="cuda")
    log(f"[plan] {smi}: wal_replay_seconds of one mean record "
        f"({log_b:.0f} bytes) {est * 1e3:.4f} ms beside the measured replay "
        f"{r['replay_s'] / max(1, r['records_replayed']) * 1e3:.3f} ms per "
        f"record (recovery (c))")
    for mkind, dim, ep, p in dur["plans"]:
        log(f"[plan] {smi}: after {mkind}({dim or ''}) at epoch {ep}: "
            f"plan_checkpoint {p.checkpoint} ({p.reason}); replay "
            f"estimated {p.est_replay_s * 1e3:.4f} ms, write "
            f"{p.est_write_s:.3f} s")
    log(f"[durable] {smi}: log of the first root: {json.dumps(info1)}")
    log(f"[launches] phase 6e in all (three recoveries' four paths and "
        f"the append after recovery): {json.dumps(launches_6e)}")
    log(f"[6e] durability: {secs_6e:.1f} s")

    # -- 6f. the sharded fact engine ------------------------------------------
    from repro_torch.engine import (ShardedSSBEngine, generate_ssb_dims,
                                    sharded_lookup, stream_ssb_fact)
    from repro_torch.launch import make_data_mesh
    sync()
    t_6f = time.perf_counter()
    resident_6f = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    seed_6f = args.seed + 6
    dev = engine.device
    rng = np.random.default_rng(seed_6f)
    launches_6f = dict(_ZERO)
    walls_6f = {}       # label -> {path: ms}
    append_6f = {}      # engine -> [ms per append]
    reshard_s = {}
    expect_mega = dict(_ZERO, fused_query=len(names),
                       pack_query_bits=len(names))

    def counted6f(fn):
        """``counted``, with the counts added to the phase's total."""
        out, got = counted(fn)
        for k, v in got.items():
            launches_6f[k] += v
        return out, got

    def suites(eng, label, want):
        """The cached (``run_all`` from an empty cache), cold and mega
        paths of ``eng`` (a ``kernel="torch"`` engine, sharded or not),
        each counted and held against ``want``: no probe kernel, and one
        fused_query a mega query.  Returns {path: ms}."""
        walls = {}
        for path in ("cached", "cold", "mega"):
            (res, wall), got = counted6f(
                lambda: drive_paths(eng, (path,)))
            check_counts(got, expect_mega if path == "mega" else _ZERO,
                         f"6f {label} {path}", quiet=True)
            check_agree(res, want, (path,), f"6f {label}")
            walls[path] = (wall["cached_suite"] if path == "cached"
                           else sum(wall[path].values())) * 1e3
        walls["physical"] = eng.tables["lineorder"].n_physical
        walls_6f[label] = walls
        return walls

    def answers(eng):
        return eng.run_all(fusion="composed")

    # 1. open: the fact table streams into 4 shards' capacity tails
    mesh4 = make_data_mesh(4, device=dev)
    t = time.perf_counter()
    sh = ShardedSSBEngine.from_streamed(args.sf, seed_6f, mesh=mesh4,
                                        chunk_rows=1 << 20)
    sync()
    open_s = time.perf_counter() - t
    n_open = sh.shard_info()["live_rows"]
    if sh.policy != ExecutionPolicy(kernel="torch"):
        raise AssertionError(f"sharded default policy {sh.policy}")
    log(f"[shard] {smi}: from_streamed(sf={args.sf}, seed={seed_6f}, 4 "
        f"shards, chunks of 2^20 rows): {n_open} rows in {open_s:.3f} s "
        f"({n_open / open_s:.0f} rows/s); {json.dumps(sh.shard_info())}")
    # the oracle: a default engine (CUDA kernels) on the dimensions and the
    # host concatenation of the same chunks; an unsharded kernel="torch"
    # engine on the same tables for the timings
    t = time.perf_counter()
    chunks = list(stream_ssb_fact(args.sf, seed_6f, chunk_rows=1 << 20))
    host_fact = {k: np.concatenate([c[k] for c in chunks])
                 for k in chunks[0]}
    del chunks
    o_tables = generate_ssb_dims(args.sf, seed_6f, device=dev)
    o_tables["lineorder"] = Table.from_numpy(host_fact, dev)
    del host_fact
    oracle = SSBEngine(o_tables)
    t_tables = generate_ssb_dims(args.sf, seed_6f, device=dev)
    t_tables["lineorder"] = o_tables["lineorder"]
    tw = SSBEngine(t_tables, policy=ExecutionPolicy(kernel="torch",
                                                    schedule="gathered"))
    sync()
    if oracle.tables["lineorder"].n_rows != n_open:
        raise AssertionError(f"streamed {n_open} rows, the oracle holds "
                             f"{oracle.tables['lineorder'].n_rows}")
    log(f"[shard] oracle (default policy) and unsharded kernel='torch' "
        f"engine on the concatenated chunks: "
        f"{time.perf_counter() - t:.3f} s")

    # 2. answers: cached, cold and mega equal the oracle's
    def reference(label):
        """The oracle's three paths (they must agree) and the unsharded
        torch engine's, timed; returns the oracle's answers."""
        res, wall = drive_paths(oracle, ("cached", "cold", "mega"))
        check_agree(res, res["cached"], ("cold", "mega"), "6f oracle")
        walls_6f[f"default, {label}"] = dict({
            p: (wall["cached_suite"] if p == "cached"
                else sum(wall[p].values())) * 1e3
            for p in ("cached", "cold", "mega")},
            physical=oracle.tables["lineorder"].n_physical)
        suites(tw, f"unsharded torch, {label}", res["cached"])
        return res["cached"]

    want = reference("open")
    suites(sh, "4 shards, open", want)
    log(f"[agree] 6f open: the 4-shard engine's cached, cold and mega "
        f"answers equal the oracle's, bit for bit")

    # 7. the sharded probe on the card against the probe_rows kernel
    pidx = oracle.indexes["part"]
    fkp = oracle.tables["lineorder"]["partkey"]
    fkp_n = fkp.shape[0]
    want_pr, got = counted6f(lambda: lookup(pidx, fkp, impl="cuda"))
    check_counts(got, dict(_ZERO, probe_rows=1), "6f lookup(impl='cuda')",
                 quiet=True)
    got_pr, got = counted6f(lambda: sharded_lookup(pidx, fkp, mesh4))
    check_counts(got, _ZERO, "6f sharded_lookup", quiet=True)
    f = want_pr.found
    if not torch.equal(got_pr.found, f) or \
            not torch.equal(got_pr.payload[f], want_pr.payload[f]):
        raise AssertionError("sharded_lookup differs from probe_rows")
    lookup_ms = {
        "sharded_lookup, 4 shards": float(np.median(
            [timed_call(lambda: sharded_lookup(pidx, fkp, mesh4))
             for _ in range(3)])) * 1e3,
        "lookup(impl='cuda')": float(np.median(
            [timed_call(lambda: lookup(pidx, fkp, impl="cuda"))
             for _ in range(3)])) * 1e3}
    del want_pr, got_pr, f
    log(f"[agree] 6f sharded_lookup(part index, {fkp.shape[0]} FKs, 4 "
        f"shards) equals lookup(impl='cuda') (probe_rows) on found and on "
        f"payload where found")

    # 3. an append of a row count 4 does not divide, every dim cached
    n_app = int(n_open * APPEND_FRAC) + 1
    n_app += n_app % 4 == 0

    def append_all(batch, label):
        """``batch`` into the sharded, default and torch engines, each
        timed; the sharded append launches no kernel and extends every
        cached dimension per shard."""
        out = {}

        def run_sh():
            out["report"] = sh.append_fact_rows(batch)

        ms, got = counted6f(lambda: timed_call(run_sh) * 1e3)
        check_counts(got, _ZERO, f"6f append ({label})", quiet=True)
        append_6f.setdefault("4 shards", []).append(ms)
        append_6f.setdefault("default", []).append(
            timed_call(lambda: oracle.append_fact_rows(batch)) * 1e3)
        append_6f.setdefault("unsharded torch", []).append(
            timed_call(lambda: tw.append_fact_rows(batch)) * 1e3)
        rep = out["report"]
        if rep["dims"] != {d: "extended" for d in DIM_PK}:
            raise AssertionError(f"6f append ({label}): {rep['dims']}")
        return rep

    for e in (sh, oracle, tw):
        e.warm_cache()
    rep = append_all(generate_fact_batch(oracle.tables, n_app, rng),
                     "every dimension cached")
    info = sh.shard_info()
    if info["dead_rows"] <= 0 or info["live_rows"] != \
            oracle.tables["lineorder"].n_rows:
        raise AssertionError(f"6f after the append: {info}")
    start, per, n = sh._windows[-1]
    dead = [(i // per, start + i % per) for i in range(n, 4 * per)]
    for dim, (found, _) in sh._probe_cache.items():
        reg = found.view(4, -1)
        if bool(reg[:, sh._shard_valid:].any()) or \
                any(bool(reg[r, c]) for r, c in dead):
            raise AssertionError(f"6f: a dead or padding row of {dim} is "
                                 "found")
    log(f"[shard] append of {n_app} rows: {json.dumps(rep)}; "
        f"{json.dumps(info)}; no dead row ({len(dead)}) is found")
    want = answers(oracle)
    suites(sh, "4 shards, after the append", want)

    # 4. dimension mutations with a live delta, then compact("part")
    for dim in ("part", "customer"):
        pk = oracle.tables[dim][DIM_PK[dim]].cpu().numpy()
        k = max(1, int(pk.shape[0] * MUTATION_FRAC))
        dels = rng.choice(pk, k, replace=False).astype(np.int32)
        ups = rng.choice(pk, k, replace=False).astype(np.int32)
        pays = rng.integers(0, pk.shape[0], k, dtype=np.int32)
        for e in (sh, oracle, tw):
            e.ingest(dim, dels, op="delete", auto_compact=False)
            e.ingest(dim, ups, pays, op="upsert", auto_compact=False)
    want = answers(oracle)
    suites(sh, "4 shards, live deltas", want)
    for e in (sh, oracle, tw):
        e.compact("part")
    want = answers(oracle)
    suites(sh, "4 shards, part compacted", want)
    log(f"[agree] 6f: after the append, the part/customer deletes and "
        f"upserts and compact('part'), the 4-shard answers equal the "
        f"oracle's on every path")

    # 5. a snapshot held across one more append; a torn publish
    sh.warm_cache()
    snap = sh.snapshot()
    gen0 = sh._fact_gen
    append_all(generate_fact_batch(oracle.tables, n_app, rng),
               "under a snapshot")
    snap_res = {}
    snap_res["cached"], got = counted6f(
        lambda: snap.run_all(fusion="composed"))
    check_counts(got, _ZERO, "6f snapshot cached", quiet=True)
    snap_res["mega"], got = counted6f(
        lambda: {q: snap.run(q, fusion="mega") for q in names})
    check_counts(got, expect_mega, "6f snapshot mega", quiet=True)
    check_agree(snap_res, want, ("cached", "mega"), "6f snapshot")
    if not bool((snap.epoch_stamps == snap.epoch).all()) or \
            sh._fact_gen == gen0:
        raise AssertionError("6f snapshot: stamps or pin")
    want = answers(oracle)
    check_agree({"cached": answers(sh)}, want, ("cached",), "6f head")
    sh._epoch_stamps = sh._epoch_stamps + 1  # a torn publish
    try:
        sh.snapshot()
    except RuntimeError as e:
        if "mixed-epoch" not in str(e):
            raise
    else:
        raise AssertionError("6f: a mixed-epoch image froze")
    sh._wal_publish()  # re-stamps every shard
    with sh.snapshot() as s2:
        if not bool((s2.epoch_stamps == sh.epoch).all()):
            raise AssertionError("6f: the republish did not heal")
    snap.release()
    del snap, s2, snap_res
    log(f"[agree] 6f snapshot: answers at its epoch after an append, "
        f"stamps uniform; a torn publish refused, the republish heals")

    # 6. reshard 4 -> 1 -> 2
    def check_logical(eng, label):
        got = eng.logical_fact_columns()
        trimmed = oracle.tables["lineorder"].trimmed()
        for c in trimmed.names():
            if not np.array_equal(got[c], trimmed[c].cpu().numpy()):
                raise AssertionError(f"6f {label}: logical {c} differs")

    t = time.perf_counter()
    sh1 = sh.reshard(make_data_mesh(1, device=dev))
    sync()
    reshard_s["4 -> 1"] = time.perf_counter() - t
    del sh
    torch.cuda.empty_cache()
    want = reference("after the mutations")
    suites(sh1, "1 shard, after the mutations", want)
    check_logical(sh1, "1 shard")
    t = time.perf_counter()
    sh2 = sh1.reshard(make_data_mesh(2, device=dev))
    sync()
    reshard_s["1 -> 2"] = time.perf_counter() - t
    del sh1
    torch.cuda.empty_cache()
    check_agree({"cached": answers(sh2)}, want, ("cached",), "6f 2 shards")
    check_logical(sh2, "2 shards")
    info2 = sh2.shard_info()
    del sh2
    log(f"[agree] 6f reshard 4 -> 1 -> 2: answers and logical fact "
        f"columns equal the oracle's; 2 shards: {json.dumps(info2)}")
    peak_6f = torch.cuda.max_memory_allocated()
    del oracle, tw, o_tables, t_tables, pidx, fkp
    torch.cuda.empty_cache()
    secs_6f = time.perf_counter() - t_6f

    # [shard] lines
    for label, w in walls_6f.items():
        log(f"[shard] {smi}: {label}: cached run_all {w['cached']:.3f} ms, "
            f"cold {w['cold']:.3f} ms, mega {w['mega']:.3f} ms (13 "
            f"queries over {w['physical']} physical rows, host clock "
            f"ending in synchronize)")
    for label, ms in append_6f.items():
        log(f"[shard] {smi}: append_fact_rows of {n_app} rows, {label}: "
            f"{json.dumps([round(x, 3) for x in ms])} ms")
    log(f"[shard] {smi}: {fkp_n} part probes, median of 3 (host clock "
        f"ending in synchronize): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in lookup_ms.items()))
    log(f"[shard] {smi}: reshard "
        + ", ".join(f"{k} {v:.3f} s" for k, v in reshard_s.items()))
    log(f"[memory] phase 6f: resident at its start {resident_6f} bytes, "
        f"peak allocated over it {peak_6f} bytes "
        f"({peak_6f / 2**30:.3f} GiB)")
    log(f"[launches] phase 6f, checked calls (the sharded and unsharded "
        f"torch engines' suites, the snapshot's, the sharded appends, one "
        f"sharded_lookup and one lookup(impl='cuda'); not the oracle's "
        f"suites and appends nor the timing repeats): "
        f"{json.dumps(launches_6f)}")
    log(f"[6f] sharded fact engine: {secs_6f:.1f} s")

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
        # [plan] the card's estimates beside the measured lookups
        auto_plan = plan_probe(stats, bucket_width=sidx.table.bucket_width,
                               backend="cuda", impl="cuda",
                               code_space=SKEW_KEYS,
                               hash_mode=sidx.table.hash_mode)
        own = plan_probe(stats, bucket_width=sidx.table.bucket_width,
                         backend="cuda", impl="torch", code_space=SKEW_KEYS,
                         hash_mode=sidx.table.hash_mode)
        est = {k: v * 1e3 for k, v in auto_plan.est_seconds}
        fastest = min(SCHEDULES, key=ms.get)
        log(f"[plan] {smi}: s={zs}: the CUDA kernels keep "
            f"{auto_plan.schedule!r} (the model's own pick: "
            f"{own.schedule!r}); estimated ms "
            f"{json.dumps({k: round(v, 4) for k, v in est.items()})}; "
            f"measured ms {json.dumps({k: round(ms[k], 4) for k in SCHEDULES})}; "
            f"estimate / measured "
            f"{json.dumps({k: round(est[k] / ms[k], 3) for k in SCHEDULES})}; "
            f"fastest measured {fastest!r}, gathered at "
            f"{ms['gathered'] / ms[fastest]:.3f}x of it")
        if auto_plan.schedule != "gathered" or \
                ms["gathered"] > PICK_SLACK * ms[fastest]:
            raise AssertionError(f"s={zs}: the pick {auto_plan.schedule} is "
                                 f"not within {PICK_SLACK} of the fastest "
                                 f"schedule {fastest}: {ms}")
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

    # -- 6g. LM serving --------------------------------------------------------
    # last of the phases, so that every engine can be freed before it and
    # the phases before it allocate as they did without it; ``fact`` (the
    # grown lineorder of 6b) and ``base_6e`` (phase 4's lineorder) are the
    # last tables still referenced
    del engine, baseline, tables, fact_cols, sidx, fact, base_6e
    gc.collect()
    torch.cuda.empty_cache()
    t_6g = time.perf_counter()
    resident_6g = torch.cuda.memory_allocated()
    got = counted(lambda: lm_serving(args.seed + 7, smi, dev))[1]
    check_counts(got, _ZERO, "phase 6g (LM serving: no JSPIM kernel)")
    log(f"[memory] phase 6g: resident at its start {resident_6g} bytes, "
        f"after deleting the earlier phases' engines and tables")
    log(f"[6g] LM serving: {time.perf_counter() - t_6g:.1f} s")

    # -- 6h. LM training -------------------------------------------------------
    # after 6g, with every earlier phase's state freed
    gc.collect()
    torch.cuda.empty_cache()
    t_6h = time.perf_counter()
    resident_6h = torch.cuda.memory_allocated()
    got = counted(lambda: lm_training(args.seed + 8, smi, dev))[1]
    check_counts(got, _ZERO, "phase 6h (LM training: no JSPIM kernel)")
    log(f"[memory] phase 6h: resident at its start {resident_6h} bytes")
    log(f"[6h] LM training: {time.perf_counter() - t_6h:.1f} s")

    # -- 6i. the mesh path of LM training ------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    t_6i = time.perf_counter()
    resident_6i = torch.cuda.memory_allocated()
    got = counted(lambda: lm_mesh(args.seed + 9, smi, dev))[1]
    check_counts(got, _ZERO, "phase 6i (the mesh path: no JSPIM kernel)")
    log(f"[memory] phase 6i: resident at its start {resident_6i} bytes")
    log(f"[6i] the mesh path of LM training: "
        f"{time.perf_counter() - t_6i:.1f} s")

    # -- 6j. the batched query tail at SF30 ----------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    t_6j = time.perf_counter()
    (rows["batched_tail"], tail_launches), got = counted(
        lambda: query_tails(args.seed + 10, smi, dev))
    log(f"[launches] phase 6j: {json.dumps(got)}")
    gc.collect()
    torch.cuda.empty_cache()
    skewed_tails(args.seed + 10, smi, dev)
    log(f"[6j] the batched query tail: {time.perf_counter() - t_6j:.1f} s")

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
                             "coalesce_window_mask"],
                         batched_tail=tail_launches)
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
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
