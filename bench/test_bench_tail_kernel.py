"""``tail_kernel_ms_per_query`` on canned runs: only the batched tail
kernel's launches count, over the requests answered ``ok`` in the window."""
import pytest

from bench.harness import Request, Run, load_reader
from bench.tracing import DeviceEvent

TAIL4 = ("void (anonymous namespace)::batched_tail_kernel<4, (anonymous "
         "namespace)::Measure>((anonymous namespace)::TailArgs)")
TAIL8 = ("void (anonymous namespace)::batched_tail_kernel<8, (anonymous "
         "namespace)::Measure>((anonymous namespace)::TailArgs)")
OTHERS = [
    "void (anonymous namespace)::rows_kernel<8>(int const*, int const*)",
    "void (anonymous namespace)::pack_kernel<8, true>(int const*, long)",
    "void at::native::vectorized_elementwise_kernel<4, "
    "at::native::(anonymous namespace)::where_kernel_impl>(int)",
    "Memcpy DtoH (Device -> Pageable)",
    # a name that holds the kernel's without its template bracket
    "void (anonymous namespace)::batched_tail_kernel_plain(int)",
]


def _run(statuses, events):
    r = Run("cell", 1, 10.0, t0=100.0, t_end=110.0)
    for i, st in enumerate(statuses):
        sent = 100.0 + 0.5 * i
        r.requests.append(Request(0, "Q2.1", (1, 2), sent, done=sent + 0.1,
                                  status=st))
    r.device_events = events
    return r


def read(run):
    return load_reader("tail_kernel_ms_per_query")(run)


def test_only_the_tail_kernel_counts_over_ok_requests():
    events = [DeviceEvent(TAIL4, 101.0, 101.003),
              DeviceEvent(TAIL8, 102.0, 102.005)]
    events += [DeviceEvent(n, 103.0 + i, 104.0 + i)
               for i, n in enumerate(OTHERS)]
    run = _run(["ok"] * 4 + ["rejected"], events)
    # 3 + 5 ms of the kernel over the 4 requests answered ok
    assert read(run) == pytest.approx(8.0 / 4)


def test_nothing_to_read_without_the_kernel():
    run = _run(["ok"] * 4, [DeviceEvent(n, 103.0, 104.0) for n in OTHERS])
    assert read(run) is None


def test_nothing_to_read_without_ok_requests():
    run = _run(["rejected", "failed"], [DeviceEvent(TAIL4, 101.0, 101.5)])
    assert read(run) is None
    assert read(_run([], [DeviceEvent(TAIL4, 101.0, 101.5)])) is None


@pytest.mark.parametrize("events", [None, []], ids=["untraced", "empty"])
def test_nothing_to_read_without_a_trace(events):
    assert read(_run(["ok"] * 3, events)) is None
