"""One run of one cell: set-up, the measured window, the check, the line.

The cell names a configuration (``bench/configs/<config>.json``) and a
traffic mix (``bench/traffic/<traffic>.json``), both found through
``BENCHMARK.json`` and checked by ``bench/deploy.py``: a key the harness
does not honour stops the run.  Set-up draws the configuration's tables on
the device from the seed, builds the system under test (an ``SSBEngine``
with the configuration's ``ExecutionPolicy``, a ``QueryScheduler`` with
its ``ServeConfig``), and warms up: the probe cache, each query id of the
mix through the scheduler, and the mix's first writes.  Then the window:
requests arrive through ``QueryScheduler.submit``, from closed-loop
clients with no think time or on an open-loop Poisson schedule, while the
writer issues the mix's writes, one per ``every_queries`` queries sent or
one per ``period_ms``.  When the window has closed, every request sent in
it is waited for, the peak memory is read, the system is freed, and a
sample of the answers, drawn from the seed, is held against the plain
reference.

The metrics are read from the run by the readers in ``bench/metrics/``,
one file per metric, found by the metric's name.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from bench import deploy, tracing
from bench.datagen import DataGen, WriteGen, sub_seed
from bench.reference.compare import Answer, compare
from bench.reference.replay import LogEntry, Replay
from bench.reference.ssb import QUERY_IDS, TEMPLATES

ROOT = Path(__file__).resolve().parent.parent
# answers held against the reference in each run
CHECK_SAMPLE = 256
# how long past the window's close a request sent in it is waited for
GRACE_S = 60.0
# where each run's spans go (git-ignored)
RUNS_DIR = ROOT / ".bench_runs"
ALIGN_MARKER = "bench.align"


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def resolve_cell(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell's entry with its configuration and traffic mix loaded."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((root / "bench" / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    deploy.check_config(config)
    deploy.check_traffic(traffic, cell["traffic"])
    return {"cell": cell, "config": config, "traffic": traffic}


def metrics_for(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (``trace`` off) or per-layer ones."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def load_reader(name: str, root: Path = ROOT):
    """The ``read(run)`` function of ``bench/metrics/<name>.py``.  A
    quantity split by cell group (``queries_per_s.refresh``) is read by
    its own file where it has one, else by the file of the name before
    the first dot (``queries_per_s.py``)."""
    path = root / "bench" / "metrics" / f"{name}.py"
    if not path.exists():
        path = path.with_name(f"{name.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Request:
    client: int
    name: str
    params: tuple[int, ...]
    sent: float
    done: float | None = None
    status: str | None = None
    epoch: int | None = None
    total: int | None = None
    groups: np.ndarray | None = None


@dataclasses.dataclass
class WriteRecord:
    index: int
    kind: str
    dim: str | None
    due: float
    start: float | None = None
    done: float | None = None
    error: str | None = None


@dataclasses.dataclass
class Run:
    """What a run measured: the metric readers' input."""

    workload: str
    seed: int
    seconds: float
    t0: float = 0.0
    t_end: float = 0.0
    setup_s: float = 0.0
    requests: list[Request] = dataclasses.field(default_factory=list)
    writes: list[WriteRecord] = dataclasses.field(default_factory=list)
    spans: tracing.Spans = dataclasses.field(default_factory=tracing.Spans)
    stats_start: dict = dataclasses.field(default_factory=dict)
    stats_end: dict = dataclasses.field(default_factory=dict)
    peak_bytes: int | None = None
    device_kind: str | None = None
    device_events: list | None = None   # trace only, clipped to the window

    def in_window(self) -> list[Request]:
        return [r for r in self.requests if self.t0 <= r.sent < self.t_end]

    def ok_in_window(self) -> int:
        """Requests answered ``ok`` within the window."""
        return sum(1 for r in self.requests if r.status == "ok"
                   and r.done is not None and r.done <= self.t_end)


def client_stream(seed: int, client: int, ids=QUERY_IDS):
    """A client's requests: rounds of the query ids in a seeded order,
    each with constants drawn by SSB's substitution rules."""
    rng = np.random.default_rng(sub_seed(seed, "client", client))
    while True:
        for i in rng.permutation(len(ids)):
            name = ids[int(i)]
            yield name, TEMPLATES[name].sample(rng)


def arrival_times(seed: int, arrivals: dict, seconds: float):
    """Offsets into the window of an open-loop Poisson schedule: ``rate_per_s``
    requests a second, times ``factor`` for ``for_s`` seconds at the start
    of every ``every_s`` seconds where the mix has a ``burst``."""
    rng = np.random.default_rng(sub_seed(seed, "arrivals"))
    rate, burst = float(arrivals["rate_per_s"]), arrivals.get("burst")
    t, out = 0.0, []
    while True:
        r = rate
        if burst and t % float(burst["every_s"]) < float(burst["for_s"]):
            r *= float(burst["factor"])
        t += rng.exponential(1.0 / r)
        if t >= seconds:
            return out
        out.append(t)


class Writer:
    """Applies writes to the engine and logs them for the reference."""

    def __init__(self, engine, device: torch.device):
        self.engine = engine
        self.device = device
        self.log: list[LogEntry] = []

    def _sync(self) -> None:
        """Wait for the work queued before this point (the write's own and
        what it queued behind), not for what the dispatcher queues later."""
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            done.synchronize()

    def apply(self, write) -> None:
        eng = self.engine
        for call in write.calls:
            a = call.arrays
            ac = {"auto_compact": call.auto_compact}
            if call.api == "append_fact_rows":
                eng.append_fact_rows(a)
                op = "fact_append"
            elif call.api == "append_rows":
                eng.append_rows(call.dim, a, **ac)
                op = "dim_append"
            elif call.api == "upsert":
                eng.ingest(call.dim, a["keys"], a["rows"], op="upsert", **ac)
                op = "dim_upsert"
            elif call.api == "delete":
                eng.ingest(call.dim, a["keys"], op="delete", **ac)
                op = "dim_delete"
            elif call.api == "compact":
                # folds the delta: the rows the reference sees stay the same
                eng.compact(call.dim)
                continue
            else:
                raise ValueError(f"unknown write call {call.api!r}")
            self.log.append(LogEntry(op, call.dim, a, eng.epoch))
        self._sync()


class WriteFeed:
    """The mix's writes in order, each drawn one ahead of its use: the
    next write's rows are ready when it falls due, as a loader's batch
    is.  On the card the draw runs on a stream of its own, so it waits for
    none of the queries' work."""

    def __init__(self, data: DataGen, wcfg: dict, device: torch.device):
        self.gen = WriteGen(data)
        self.cycle = wcfg["cycle"]
        self.stream = torch.cuda.Stream(device) \
            if device.type == "cuda" else None
        self.i = 0
        self.ready = None

    def prefetch(self) -> None:
        if self.ready is None:
            spec = self.cycle[self.i % len(self.cycle)]
            ctx = torch.cuda.stream(self.stream) if self.stream is not None \
                else contextlib.nullcontext()
            with ctx:
                self.ready = self.gen.make(self.i, spec)
            self.i += 1

    def next(self):
        self.prefetch()
        w, self.ready = self.ready, None
        return w

    def close(self) -> None:
        self.ready = None
        if self.stream is not None:
            self.stream.synchronize()


def power_limit_w() -> float | None:
    """The card's power limit in W (``nvidia-smi``), or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True)
        return float(out.stdout.strip())
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


def _wait(sched, name, params):
    t = sched.submit(name, params)
    resp = t.wait(GRACE_S)
    if resp is None or resp.status != "ok":
        raise RuntimeError(f"warm-up request {name}{params} got "
                           f"{None if resp is None else resp.status}")


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, *, device, t_start: float, root: Path = ROOT,
             rows: dict | None = None, plant=None, control: bool = False,
             log=print) -> dict:
    """Run one cell and return ``{"run", "result", "checks"}``.

    The benchmark's own tests use the keywords the command leaves unset:
    ``rows`` replaces the configuration's row counts (a size a CPU test
    can hold); ``plant(engine, scheduler)``, called once set-up is done,
    may break the system under test; with ``control`` the plain reference,
    accumulating in float32, answers in the scheduler's place
    (``bench/control.py``)."""
    from repro_torch.engine import SSBEngine, Table
    from repro_torch.serving import QueryScheduler

    dev = torch.device(device)

    def peak() -> int:
        return torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else 0

    spec = resolve_cell(bench, workload, root)
    config, traffic = spec["config"], spec["traffic"]
    if rows is not None:
        config = {**config, "rows": rows}
    run = Run(workload, seed, float(seconds))

    # -- set-up: data, system, warm-up ----------------------------------------
    data = DataGen(config, seed, dev)
    fact, dims = data.tables()
    wcfg = traffic.get("writer")
    tables = {"lineorder": Table(fact), **{d: Table(c) for d, c in
                                           dims.items()}}
    del fact, dims
    engine = SSBEngine(tables, policy=deploy.policy(config), device=dev)
    del tables
    if traffic.get("warm_probe_cache", True):
        engine.warm_cache()
    writer = Writer(engine, dev)
    if control:
        from bench.control import ControlServer
        fact, dims = DataGen(config, seed, dev).tables()
        sched = ControlServer(Replay(fact, dims, writer.log))
        del fact, dims
    else:
        sched = QueryScheduler(engine, deploy.serve_config(config))
    sched.start(traffic.get("dispatchers", 1))
    ids = tuple(traffic.get("query_ids", QUERY_IDS))
    warm_rng = np.random.default_rng(sub_seed(seed, "warm"))
    for name in ids:
        _wait(sched, name, TEMPLATES[name].sample(warm_rng))
    writes = WriteFeed(data, wcfg, dev) if wcfg else None
    if writes is not None:
        for _ in range(wcfg.get("warm_writes", 0)):
            writer.apply(writes.next())
        for name in ids:
            _wait(sched, name, TEMPLATES[name].sample(warm_rng))
        writes.prefetch()
    else:
        data.release()
    if plant is not None:
        plant(engine, sched)

    prof = None
    traced = contextlib.ExitStack()
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        from repro_torch.kernels import ops as kernel_ops
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        if not control:
            tracing.wrap_dispatch(sched.runner, run.spans, peak)
        traced.enter_context(tracing.probe_spans(kernel_ops, run.spans))
        prof = traced.enter_context(profile(activities=acts))
        with record_function(ALIGN_MARKER):
            marker_at = time.perf_counter()

    # -- the window ----------------------------------------------------------
    go = threading.Event()
    lock = threading.Lock()
    sent_cv = threading.Condition(lock)
    marks: list[float] = []      # send times of every ``every_queries``-th
    every = wcfg.get("every_queries") if wcfg else None
    arrivals = traffic["arrivals"]

    def count_sent(t: float | None = None) -> float:
        """Count a query sent in the window at ``t`` (now, by default, read
        under the lock so the counts keep the order of the times); wake
        the writer at its due points.  Returns the send time."""
        if every is None:
            return time.perf_counter() if t is None else t
        with sent_cv:
            t = time.perf_counter() if t is None else t
            count_sent.n += 1
            if count_sent.n % every == 0:
                marks.append(t)
                sent_cv.notify_all()
        return t
    count_sent.n = 0

    def client(c: int):
        stream = client_stream(seed, c, ids)
        mine = []
        go.wait()
        while True:
            if time.perf_counter() >= run.t_end:
                break
            name, p = next(stream)
            r = Request(c, name, p, count_sent())
            mine.append(r)
            resp = sched.submit(name, p).wait(
                max(0.0, run.t_end + GRACE_S - r.sent))
            r.done = time.perf_counter()
            if resp is None:
                r.done = None
                break
            r.status, r.epoch = resp.status, resp.epoch
            if resp.status == "ok":
                r.total, r.groups = resp.total, resp.groups
        with lock:
            run.requests.extend(mine)

    def open_loop():
        """Sends on the Poisson schedule; a request's latency runs from its
        scheduled time, so a sender that falls behind counts against it."""
        stream = client_stream(seed, 0, ids)
        offsets = arrival_times(seed, arrivals, seconds)
        sent = []
        go.wait()
        for off in offsets:
            due = run.t0 + off
            delay = due - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            name, p = next(stream)
            r = Request(0, name, p, due)
            count_sent(due)
            at = time.perf_counter()
            sent.append((r, at, sched.submit(name, p)))
        for r, at, ticket in sent:
            resp = ticket.wait(max(0.0, run.t_end + GRACE_S
                                   - time.perf_counter()))
            if resp is not None:
                lat = getattr(ticket, "latency_s", None)
                r.done = at + lat if lat is not None else time.perf_counter()
                r.status, r.epoch = resp.status, resp.epoch
                if resp.status == "ok":
                    r.total, r.groups = resp.total, resp.groups
        with lock:
            run.requests.extend(r for r, _, _ in sent)

    def due_time(i: int) -> float | None:
        """When the window's ``i``-th write is due, or None if it is not
        due before the window closes."""
        if every is None:
            due = run.t0 + i * wcfg["period_ms"] / 1000.0
            return due if due < run.t_end else None
        with sent_cv:
            while len(marks) <= i and time.perf_counter() < run.t_end:
                sent_cv.wait(max(0.0, min(0.05, run.t_end
                                          - time.perf_counter())))
            return marks[i] if len(marks) > i else None

    def write_loop():
        go.wait()
        i = 0
        while True:
            due = due_time(i)
            if due is None:
                break
            i += 1
            w = writes.next()
            rec = WriteRecord(w.index, w.kind, w.dim, due)
            run.writes.append(rec)
            delay = due - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            rec.start = time.perf_counter()
            try:
                writer.apply(w)
            except Exception as e:  # noqa: BLE001 - the run records it
                rec.error = f"{type(e).__name__}: {e}"
                log(f"[bench] write {w.index} ({w.kind}) failed: "
                    f"{rec.error}")
                return
            rec.done = time.perf_counter()
            run.spans.add(f"write.{w.kind}", rec.start, rec.done,
                          dim=w.dim, due=due, peak=peak())
            writes.prefetch()

    if arrivals["process"] == "closed":
        threads = [threading.Thread(target=client, args=(c,),
                                    name=f"client-{c}")
                   for c in range(arrivals["clients"])]
    else:
        threads = [threading.Thread(target=open_loop, name="open-loop")]
    if wcfg:
        threads.append(threading.Thread(target=write_loop, name="writer"))
    for t in threads:
        t.start()
    run.stats_start = dict(sched.stats)
    run.t0 = time.perf_counter()
    run.t_end = run.t0 + seconds
    run.setup_s = run.t0 - t_start
    setup_peak = peak()
    go.set()
    for t in threads:
        t.join(seconds + GRACE_S + 60.0)
    hung = [t.name for t in threads if t.is_alive()]
    run.stats_end = dict(sched.stats)
    sched.close()
    if writes is not None:
        writes.close()
    data.release()

    traced.close()
    if prof is not None:
        events = tracing.device_events(prof, ALIGN_MARKER, marker_at)
        run.device_events = tracing.clip(events, run.t0, run.t_end)
        del prof, events

    # -- after the window: memory, diagnostics, then free the system ---------
    if dev.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated(dev)
        run.device_kind = torch.cuda.get_device_name(dev)
    info = {"scheduler": run.stats_end,
            "engine": {"cache": engine.cache_info(),
                       "fact": engine.fact_append_info(),
                       "snapshots": engine.snapshot_info(),
                       "ingest": {k: v for k, v in engine.ingest_info().items()
                                  if k != "deltas"}}}
    log_entries = writer.log
    del sched, engine, writer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------------
    sent = run.in_window()
    missing = sum(1 for r in sent if r.done is None) + len(hung)
    ok = [r for r in sent if r.status == "ok"]
    pick = np.random.default_rng(sub_seed(seed, "check")).permutation(
        len(ok))[:CHECK_SAMPLE]
    answers = [Answer(ok[i].name, ok[i].params, ok[i].epoch, ok[i].total,
                      ok[i].groups) for i in sorted(pick)]
    fact, dims = DataGen(config, seed, dev).tables()
    verdict = compare(answers, Replay(fact, dims, log_entries))
    del fact, dims
    write_errors = sum(1 for w in run.writes if w.error)
    checks = {"wrong_answers": {"value": verdict["wrong"], "limit": 0},
              "missing_answers": {"value": missing, "limit": 0},
              "write_errors": {"value": write_errors, "limit": 0},
              "answers_compared": {"value": verdict["compared"],
                                   "at_least": 1}}
    correct = (verdict["wrong"] == 0 and missing == 0 and write_errors == 0
               and verdict["compared"] >= 1)
    for ex in verdict["examples"]:
        log(f"[bench] wrong answer: {ex}")

    # -- metrics ---------------------------------------------------------------
    metrics = {}
    for m in metrics_for(bench, workload, trace):
        v = load_reader(m["name"], root)(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    n_writes = len(run.writes)
    attempted = len(sent) + n_writes
    failed = sum(1 for r in sent if r.status != "ok") + write_errors
    lateness = [w.start - w.due for w in run.writes if w.start is not None]
    log(f"[bench] {workload} seed {seed}: setup {run.setup_s:.3f} s, "
        f"{len(sent)} requests sent in {seconds} s, {len(ok)} ok, "
        f"{len(sent) - len(ok)} not ok, {n_writes} writes due")
    if lateness:
        from bench.stats import DIM_WRITES, write_latency_ms
        kinds = {"fact appends": ("fact_append",),
                 "dimension changes": DIM_WRITES}
        by_kind = ", ".join(
            f"{k} p50 {write_latency_ms(run, ks, 0.5)} p90 "
            f"{write_latency_ms(run, ks, 0.9)} ms" for k, ks in kinds.items())
        log(f"[bench] writer lateness: max {max(lateness) * 1e3:.3f} ms, "
            f"mean {sum(lateness) / len(lateness) * 1e3:.3f} ms; latency "
            f"from due: {by_kind}")
    log(f"[bench] engine and scheduler: {json.dumps(info, default=str)}")
    if run.peak_bytes:
        first = next((sp for sp in sorted(run.spans.items,
                                          key=lambda sp: sp.end)
                      if sp.attrs.get("peak") == run.peak_bytes), None)
        log(f"[bench] memory peak: {setup_peak / 2 ** 30:.3f} GiB after "
            f"set-up, {run.peak_bytes / 2 ** 30:.3f} GiB at the end; "
            f"first seen at the end of "
            f"{'an unspanned call' if first is None else first.name} "
            f"{'' if first is None else f'{first.end - run.t0:.3f} s in'}")
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": run.device_kind, "count": 1,
                   "memory_peak_bytes": run.peak_bytes,
                   "power_limit_w": power_limit_w()
                   if dev.type == "cuda" else None}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device_info}
    if trace and run.device_events is not None:
        busy = sum(b - a for a, b in tracing.busy_intervals(
            run.device_events))
        device_info["busy_s"] = busy
        device_info["window_s"] = run.t_end - run.t0
        result["breakdown"] = tracing.breakdown(
            run.device_events, run.spans.items, run.t0, run.t_end)
    run.spans.dump(RUNS_DIR / f"{workload}.seed{seed}.trace{int(trace)}"
                   ".spans.jsonl")
    result["checks"] = checks
    return {"run": run, "result": result, "checks": checks}
