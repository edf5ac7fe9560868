"""The program's spans and the benchmark: device time charged to the span
that launched it (``bench/attribution.py``), the benchmark's readers
reading the same with program spans among a run's, and a traced run of a
cell on the CPU, which leaves the program's recorder off."""
import time
import types

import pytest
import torch

from bench import attribution, harness, tracing
from bench.attribution import Op
from bench.harness import Request, Run, WriteRecord, load_reader
from bench.tracing import DeviceEvent

# the per-layer and end-to-end metrics the benchmark had before the
# program's spans
EARLIER = ("requests_per_dispatch", "torch_device_ms_per_query",
           "device_idle_pct", "probe_kernels_roofline", "append_call_ms_p50",
           "dim_write_call_ms_p50", "query_p95_ms", "queries_per_s",
           "peak_mem_gib", "append_p50_ms", "append_p90_ms",
           "dim_write_p90_ms", "setup_s")
TORCH = ("void at::native::vectorized_elementwise_kernel<4, "
         "at::native::(anonymous namespace)::where_kernel_impl>(int)")
PROBE = "void (anonymous namespace)::rows_kernel<8>(int const*, int const*)"
DISPATCHER, WRITER = 7, 9
# the second marker that ties the program's spans to the profiler's clock
CHARGE_MARKER = "bench.align_program"


def pspan(run, name, start, end, sid, parent=None, thread=DISPATCHER,
          **attrs):
    """A program span among a run's: id, parent, native."""
    run.spans.items.append(tracing.Span(
        name, start, end, thread,
        {**attrs, "id": sid, "parent": parent, "native": thread + 1000}))


def base_run():
    """Requests, writes, the benchmark's spans and a device trace."""
    r = Run("cell", 1, 10.0, t0=100.0, t_end=110.0, setup_s=12.5)
    for i in range(20):
        sent = 100.0 + 0.4 * i
        r.requests.append(Request(0, "Q1.1", (1,), sent,
                                  done=sent + 0.01 * (i + 1), status="ok"))
    for i, (kind, ms) in enumerate([("fact_append", 40), ("dim_delete", 120),
                                    ("fact_append", 60),
                                    ("dim_new_version", 200)]):
        due = 100.0 + 0.25 * i
        r.writes.append(WriteRecord(i, kind, None, due, start=due + 0.005,
                                    done=due + 0.005 + ms / 1e3))
    r.stats_start = {"completed": 100, "batches": 50, "refreshes": 5}
    r.stats_end = {"completed": 140, "batches": 66, "refreshes": 15}
    r.peak_bytes = 3 * 2 ** 30
    r.device_kind = "NVIDIA H100 80GB HBM3"
    r.device_events = [DeviceEvent(PROBE, 101.0, 101.002),
                       DeviceEvent(TORCH, 102.0, 104.0)]
    r.spans.add("kernel.probe_rows", 100.999, 101.0001, bytes=3_350_000)
    r.spans.add("dispatch.Q1.1", 100.5, 108.0, width=2)
    r.spans.add("write.fact_append", 106.0, 107.0)
    return r


def with_program(r):
    """``r`` with the program's spans."""
    # 20 requests queued 10..200 ms in the window, one never taken, one
    # queued before the window
    for i in range(20):
        pspan(r, "serve.queue", 100.0 + 0.4 * i,
              100.0 + 0.4 * i + 0.01 * (i + 1), 100 + i, thread=20 + i,
              batch=1)
    pspan(r, "serve.queue", 109.0, 109.5, 200, thread=50, outcome="rejected")
    pspan(r, "serve.queue", 99.0, 99.9, 201, thread=51, batch=1)
    pspan(r, "serve.batch", 101.0, 103.0, 1, batch=1)
    pspan(r, "batch.tail", 101.5, 102.5, 2, parent=1, batch=1)
    pspan(r, "probe.overlay", 101.6, 101.7, 3, parent=2, batch=1)
    pspan(r, "batch.readback", 102.5, 102.9, 4, parent=1, batch=1)
    # lock waits: two overlapping on the dispatcher, one past the window's
    # end, one on the writer (not a dispatcher)
    pspan(r, "engine.lock_wait", 101.0, 101.2, 5, parent=1, site="snapshot")
    pspan(r, "engine.lock_wait", 101.1, 101.3, 6, parent=1, site="release")
    pspan(r, "engine.lock_wait", 109.9, 110.5, 7, site="snapshot")
    pspan(r, "engine.lock_wait", 102.0, 103.0, 8, thread=WRITER,
          site="ingest")
    # merges: r = 30 (0.2 s of device time its own, 0.1 s in a span
    # nested in it), 0.5 and 1; one before the window, one with no estimate
    pspan(r, "engine.compact", 104.0, 104.1, 9, thread=WRITER,
          est_merge_s=0.01)
    pspan(r, "probe.overlay", 104.01, 104.02, 14, parent=9, thread=WRITER)
    pspan(r, "engine.compact", 105.0, 105.02, 10, thread=WRITER,
          est_merge_s=0.04)
    pspan(r, "engine.compact", 106.0, 106.01, 11, thread=WRITER,
          est_merge_s=0.01)
    pspan(r, "engine.compact", 99.0, 99.5, 12, thread=WRITER,
          est_merge_s=0.01)
    pspan(r, "engine.compact", 107.0, 108.0, 13, thread=WRITER)
    return r


def value(name, run):
    return load_reader(name)(run)


def test_the_earlier_readers_read_the_same_with_program_spans():
    before = {n: value(n, base_run()) for n in EARLIER}
    after = {n: value(n, with_program(base_run())) for n in EARLIER}
    assert after == before
    assert sum(v is not None for v in before.values()) == len(EARLIER)


def test_runtime_calls_give_each_operation_its_launch():
    from torch.autograd import DeviceType

    def ev(name, dev, corr, start_ns, dur_ns, res=0):
        return types.SimpleNamespace(
            name=lambda: name, device_type=lambda: dev,
            correlation_id=lambda: corr, start_ns=lambda: start_ns,
            duration_ns=lambda: dur_ns, device_resource_id=lambda: res,
            is_user_annotation=lambda: False)

    events = [ev("bench.align", DeviceType.CPU, 1, 2_000_000_000, 10),
              ev("cudaLaunchKernel", DeviceType.CPU, 77, 2_500_000_000, 5,
                 res=-12345),
              ev("aten::add", DeviceType.CPU, 77, 2_400_000_000, 500),
              ev("k", DeviceType.CUDA, 77, 3_000_000_000, 1_000),
              ev("lost", DeviceType.CUDA, 78, 3_000_000_000, 1_000)]
    off = attribution.clock_offset(events, "bench.align", 50.0)
    assert off == pytest.approx(2.0 - 50.0)
    ops = attribution.device_ops(events, off)
    assert ops == [Op("k", 51.0, 51.0 + 1e-6, -12345, 50.5),
                   Op("lost", 51.0, 51.0 + 1e-6, None, None)]
    span = tracing.Span("serve.batch", 50.0, 52.0, 2 ** 40 + 2 ** 32 - 12345,
                        {"id": 1, "native": 99})
    assert {-12345, 99} <= attribution.thread_keys(span)
    c = attribution.charge(ops, [span], 0.0, 100.0)
    assert c.device_s == {1: pytest.approx(1e-6)}
    assert c.uncharged_s == pytest.approx(1e-6) and \
        c.uncharged_share == pytest.approx(0.5)


def test_ops_of_a_cpu_trace_go_to_their_innermost_span():
    from repro_torch import trace
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.ones(64)
    trace.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function(harness.ALIGN_MARKER):
                pass
            marker_at = attribution.mark(CHARGE_MARKER)
            t0 = time.perf_counter()
            with trace.span("serve.batch"):
                torch.add(x, 1)
                with trace.span("batch.tail"):
                    with trace.span("probe.overlay"):
                        torch.mul(x, 2)
                    torch.neg(x)
                torch.sub(x, 1)
            torch.div(x, 2)
            t1 = time.perf_counter()
    finally:
        spans = trace.disable()
    program = [tracing.Span(s.name, s.start, s.end, s.thread,
                            {**s.attrs, "id": s.id, "parent": s.parent,
                             "native": s.native}) for s in spans]
    ids = {s.name: s.attrs["id"] for s in program}
    events = prof.profiler.kineto_results.events()
    off = attribution.clock_offset(events, CHARGE_MARKER, marker_at)
    owner = {}
    for e in events:
        if e.name() not in ("aten::add", "aten::mul", "aten::neg",
                            "aten::sub", "aten::div"):
            continue
        # a host operation stands in for a launch: it launches itself
        s = e.start_ns() * 1e-9 - off
        op = Op(e.name(), s, s + e.duration_ns() * 1e-9,
                e.device_resource_id(), s)
        c = attribution.charge([op], program, t0, t1)
        owner[e.name()] = next(iter(c.device_s), None)
    assert owner == {"aten::add": ids["serve.batch"],
                     "aten::mul": ids["probe.overlay"],
                     "aten::neg": ids["batch.tail"],
                     "aten::sub": ids["serve.batch"], "aten::div": None}


def test_a_traced_run_leaves_the_recorder_off(few_threads):
    from repro_torch import trace
    from bench.test_bench_check import TINY

    bench = harness.load_benchmark()
    out = harness.run_cell(
        bench, "ssb30_refresh", 2 ** 31 + 5, 0.8, True, device="cpu",
        t_start=time.perf_counter(), rows=TINY, log=lambda *a: None)
    run, result = out["run"], out["result"]
    assert result["correct"], out["checks"]
    assert not trace.enabled()
    assert not [s for s in run.spans.items if "id" in s.attrs]
    assert "requests_per_dispatch.refresh" in result["metrics"]
    # the scheduler's new counter reaches the counters the run keeps
    assert run.stats_end["refreshes"] >= run.stats_start["refreshes"] >= 1
