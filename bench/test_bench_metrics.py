"""Each metric reader on a canned run: requests, writes, spans and a
profiler trace with known numbers."""
import json
import math
import types

import pytest
import torch

from bench import tracing
from bench.harness import ROOT, Request, Run, WriteRecord, load_reader
from bench.kernels import probe_launch_bytes
from bench.tracing import DeviceEvent

PROBE = "void (anonymous namespace)::rows_kernel<8>(int const*, int const*)"
PACK = "void (anonymous namespace)::pack_kernel<8, true>(int const*, long)"
FUSED_PACK = ("void (anonymous namespace)::pack_kernel((anonymous "
              "namespace)::PackArgs)")
TORCH = ("void at::native::vectorized_elementwise_kernel<4, "
         "at::native::(anonymous namespace)::where_kernel_impl>(int)")


@pytest.fixture
def run():
    r = Run("cell", 1, 10.0, t0=100.0, t_end=110.0, setup_s=12.5)
    # 20 requests sent in the window, latencies 10..200 ms, one rejected;
    # one sent before the window; one sent in it and answered after it
    for i in range(20):
        sent = 100.0 + 0.4 * i
        r.requests.append(Request(0, "Q1.1", (1,), sent,
                                  done=sent + 0.01 * (i + 1), status="ok"))
    r.requests[5].status = "rejected"
    r.requests.append(Request(0, "Q1.1", (1,), 99.0, done=100.5,
                              status="ok"))
    r.requests.append(Request(1, "Q1.1", (1,), 109.95, done=110.2,
                              status="ok"))
    for i, (kind, ms) in enumerate([("fact_append", 40), ("dim_delete", 120),
                                    ("fact_append", 60),
                                    ("dim_new_version", 200)]):
        due = 100.0 + 0.25 * i
        r.writes.append(WriteRecord(i, kind, None, due, start=due + 0.005,
                                    done=due + 0.005 + ms / 1e3))
    r.stats_start = {"completed": 100, "batches": 50}
    r.stats_end = {"completed": 140, "batches": 66}
    r.peak_bytes = 3 * 2 ** 30
    r.device_kind = "NVIDIA H100 80GB HBM3"
    r.device_events = [DeviceEvent(PROBE, 101.0, 101.002),
                       DeviceEvent(PACK, 101.002, 101.003),
                       DeviceEvent(TORCH, 102.0, 104.0),
                       DeviceEvent(FUSED_PACK, 104.0, 104.5),
                       DeviceEvent("Memcpy DtoH (Device -> Pageable)", 103.0,
                                   105.0)]
    r.spans.add("kernel.probe_rows", 100.999, 101.0001, bytes=3_350_000)
    r.spans.add("kernel.probe_rows", 99.0, 99.1, bytes=10 ** 12)  # before
    r.spans.add("dispatch.Q1.1", 100.5, 108.0, width=2)
    r.spans.add("write.fact_append", 106.0, 107.0)
    return r


def value(name, run):
    return load_reader(name)(run)


def test_query_p95_counts_failures_as_late(run):
    # 21 sent in the window: 10..200 ms with the 60 ms one rejected
    # (infinite), and 250 ms: the 20th of 21 by nearest rank is 250 ms
    assert value("query_p95_ms", run) == pytest.approx(250.0)
    for r in run.requests[:3]:
        r.status = "failed"
    assert value("query_p95_ms", run) is None   # the tail is failures


def test_queries_per_s_counts_ok_answers_in_the_window(run):
    # 19 ok of the first 20 sent in it, plus the one sent before it; the
    # one answered after it does not count
    assert value("queries_per_s", run) == pytest.approx(20 / 10.0)


def test_write_p50_from_the_due_time(run):
    # latencies from the due time: appends 45 and 65 ms (the dimension
    # changes' 125 and 205 ms are not appends)
    assert value("append_p50_ms", run) == pytest.approx(45.0)
    run.writes[0].done = None   # a failed write is infinitely late
    assert value("append_p50_ms", run) == pytest.approx(65.0)
    run.writes[2].done = None
    assert value("append_p50_ms", run) is None
    run.writes = []
    assert value("append_p50_ms", run) is None


def test_write_p90_by_kind(run):
    assert value("append_p90_ms", run) == pytest.approx(65.0)
    assert value("dim_write_p90_ms", run) == pytest.approx(205.0)
    run.writes[3].done = None   # the tail is a failure
    assert value("dim_write_p90_ms", run) is None
    assert value("append_p90_ms", run) == pytest.approx(65.0)


def test_compactions_are_not_dimension_changes(run):
    run.writes.append(WriteRecord(9, "compact", "part", 101.0, start=101.0,
                                  done=102.0))
    assert value("dim_write_p90_ms", run) == pytest.approx(205.0)
    assert value("dim_write_call_ms_p50", run) == pytest.approx(120.0)


def test_peak_and_setup(run):
    assert value("peak_mem_gib", run) == 3.0
    assert value("setup_s", run) == 12.5
    run.peak_bytes = None
    assert value("peak_mem_gib", run) is None


def test_requests_per_dispatch(run):
    assert value("requests_per_dispatch", run) == pytest.approx(40 / 16)


def test_device_idle_pct(run):
    # busy: 2 + 1 ms, then 102.0-105.0 (the copy overlaps the torch kernel)
    busy = 0.003 + 3.0
    assert value("device_idle_pct", run) == pytest.approx(
        100 * (1 - busy / 10.0))
    run.device_events = None
    assert value("device_idle_pct", run) is None


def test_torch_device_ms_per_query_leaves_out_port_kernels(run):
    # only the 2 s torch kernel counts, over the 20 ok answers
    assert value("torch_device_ms_per_query", run) == pytest.approx(
        2000.0 / 20)


def test_probe_kernels_roofline(run):
    # 3.35 MB at 3.35 TB/s is 1 us, against 3 ms of probe kernels
    assert value("probe_kernels_roofline", run) == pytest.approx(
        100 * 1e-6 / 0.003)
    run.device_kind = "an unknown card"
    assert value("probe_kernels_roofline", run) is None


def test_write_span_medians(run):
    assert value("append_call_ms_p50", run) == pytest.approx(40.0)
    assert value("dim_write_call_ms_p50", run) == pytest.approx(120.0)


def test_every_metric_in_benchmark_json_has_a_reader():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(load_reader(m["name"])), m["name"]


def test_breakdown_charges_idle_time_to_the_open_span(run):
    b = tracing.breakdown(run.device_events, run.spans.items, run.t0,
                          run.t_end)
    assert b["device_ops"][0][0] == TORCH[:160]
    idle = dict(b["idle_gaps"])
    # 100.0-100.5 before any span; the dispatch span to 108.0 except the
    # busy time and the write span's second; the write 106-107; 108-110
    assert idle["dispatch.Q1.1"] == pytest.approx(7.5 - 3.003 - 1.0 - 0.001,
                                                  abs=1e-6)
    assert idle["kernel.probe_rows"] == pytest.approx(0.001, abs=1e-6)
    assert idle["write.fact_append"] == pytest.approx(1.0)
    assert idle["no benchmark span"] == pytest.approx(0.5 + 2.0, abs=1e-6)
    assert sum(idle.values()) == pytest.approx(10.0 - 3.003, abs=1e-6)


def test_device_events_align_with_the_marker():
    from torch.autograd import DeviceType

    def ev(name, dev, start_ns, dur_ns):
        return types.SimpleNamespace(
            name=lambda: name, device_type=lambda: dev,
            start_ns=lambda: start_ns, duration_ns=lambda: dur_ns)

    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: [
            ev("k", DeviceType.CUDA, 5_000_000_000, 1_000),
            ev("bench.align", DeviceType.CPU, 2_000_000_000, 10)])))
    out = tracing.device_events(prof, "bench.align", 50.0)
    assert out == [DeviceEvent("k", 53.0, 53.0 + 1e-6)]
    assert tracing.clip(out, 53.0000005, 60.0)[0].start == 53.0000005


def test_probe_bytes_match_the_kernel_table():
    """``PERF.md``'s kernel table at SF10: 60M probes into part's 524,288 x
    8 table (and its 65,536 x 8 delta)."""
    m, b, w = 60_000_000, 524_288, 8
    plane = torch.empty((b, w), dtype=torch.int32, device="meta")
    keys = torch.empty(m, dtype=torch.int32, device="meta")
    delta = torch.empty((65_536, w), dtype=torch.int32, device="meta")
    assert probe_launch_bytes("probe_rows", (plane, plane, keys, "f")) == \
        513_554_432
    assert probe_launch_bytes("probe_filter_rows",
                              (plane, plane, plane, keys, "f")) == 530_331_648
    assert probe_launch_bytes(
        "probe_filter_rows_delta",
        (plane, plane, plane, keys, "f", delta, delta, keys, "f")) == \
        774_525_952
    few = torch.empty(1000, dtype=torch.int32, device="meta")
    # a small launch counts one key row and one value per probe
    assert probe_launch_bytes("probe_rows", (plane, plane, few, "f")) == \
        8 * 1000 + 1000 * (4 * w + 4)
    empty = torch.empty(0, dtype=torch.int32, device="meta")
    assert probe_launch_bytes("probe_rows", (plane, plane, empty, "f")) == 0
    assert math.isclose(513_554_432 / 3.35e12 * 1e3, 0.1533, rel_tol=1e-3)
