"""Device time charged to the program span that launched it.

``torch.profiler`` records each device operation (kernel, copy, set) and
the CUDA runtime call that launched it under one correlation id.  The
runtime call carries its time and the id of the host thread that made
it; the program's spans (``repro_torch.trace``) carry their thread's ids
and their times on the spans' clock, which the benchmark's alignment
marker ties to the profiler's (``tracing.device_events``).  So each
device operation is charged to the innermost program span open on the
launching thread at the launch, and one launched outside every program
span to none.

The profiler's own host records cannot do this in a served run: it
records host operations and ``record_function`` ranges only on the thread
that started it (the harness's), not on the dispatcher or the writer, and
a kernel the port launches through ``ctypes`` has no host operation to
link to.  The runtime call is recorded on every thread; its thread id is
the operating system's for the profiler's own thread and the low 32 bits
of ``threading.get_ident()`` for the others (torch 2.11 on the H100), so
a span answers to both.

The traced run (``bench/harness.py``) does not call this yet: that takes
turning the program's recorder on over the window, adding the spans it
returns to the run's (with ``id``, ``parent`` and ``native`` among their
attributes) and a second marker recorded with ``mark`` after the
profiler starts; ``bench/test_bench_program_spans.py`` shows the steps on
a CPU trace.
"""
from __future__ import annotations

import bisect
import ctypes
import dataclasses
import re
import time

# the CUDA runtime and driver calls among the profiler's host events
RUNTIME_CALL = re.compile(r"^cu(da)?[A-Z]")


@dataclasses.dataclass(frozen=True)
class Op:
    """One device operation: its time on the device and its launch, on
    the spans' clock; ``thread`` is the launching thread's id as the
    profiler gives it (None where no launch was found)."""

    name: str
    start: float
    end: float
    thread: int | None
    launched: float | None


@dataclasses.dataclass
class Charge:
    """Device seconds in the window by the program span that launched
    them; what no span launched is ``uncharged_s`` of ``total_s``."""

    device_s: dict[int, float]
    uncharged_s: float
    total_s: float

    @property
    def uncharged_share(self) -> float | None:
        return self.uncharged_s / self.total_s if self.total_s > 0 else None


def mark(name: str) -> float:
    """Record a host range ``name`` in the running profiler and return its
    time on the spans' clock, the middle of a read before and after it.
    Call it after the profiler's first range: the first one's timestamp
    precedes its return by about a millisecond (1.2 ms on a CPU), which a
    read after it would add to every time aligned by it."""
    from torch.profiler import record_function

    before = time.perf_counter()
    with record_function(name):
        after = time.perf_counter()
    return (before + after) / 2


def clock_offset(events, marker: str, marker_at: float) -> float:
    """The profiler's clock minus the spans' (seconds), from ``marker``, a
    host event recorded at ``marker_at`` (``time.perf_counter``)."""
    for e in events:
        if e.name() == marker:
            return e.start_ns() * 1e-9 - marker_at
    raise RuntimeError(f"profiler trace lacks the marker {marker!r}")


def device_ops(events, offset: float) -> list[Op]:
    """The device's operations in a profiler's events, each with the
    runtime call that launched it."""
    from torch.autograd import DeviceType

    calls = {}
    for e in events:
        if e.device_type() == DeviceType.CPU and \
                not e.is_user_annotation() and RUNTIME_CALL.match(e.name()):
            calls[e.correlation_id()] = e
    out = []
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        s = e.start_ns() * 1e-9 - offset
        call = calls.get(e.correlation_id())
        out.append(Op(e.name(), s, s + e.duration_ns() * 1e-9,
                      None if call is None else call.device_resource_id(),
                      None if call is None
                      else call.start_ns() * 1e-9 - offset))
    return out


def thread_keys(span) -> set[int]:
    """The ids a profiler may give a span's thread: the operating system's
    and ``threading.get_ident()``'s, whole and cut to 32 bits."""
    ident = span.thread
    keys = {ident, ctypes.c_int32(ident).value, ctypes.c_uint32(ident).value}
    if span.attrs.get("native") is not None:
        keys.add(span.attrs["native"])
    return keys


class _Timeline:
    """One thread's spans, for the innermost one open at a time."""

    def __init__(self, spans):
        spans = sorted(spans, key=lambda s: s.start)
        self.starts = [s.start for s in spans]
        self.spans = spans
        # the latest end among the spans started so far: a walk back from
        # a time stops where no earlier span can still be open
        self.reach = []
        hi = float("-inf")
        for s in spans:
            hi = max(hi, s.end)
            self.reach.append(hi)

    def innermost(self, t: float):
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.reach[i] > t:
            if self.spans[i].end > t:
                return self.spans[i]
            i -= 1
        return None


def charge(ops: list[Op], spans, t0: float, t1: float) -> Charge:
    """Charge each operation's device time inside ``[t0, t1]`` to the
    innermost of ``spans`` (program spans, with ``id`` and ``native`` in
    their attributes) open on its launching thread at its launch."""
    by_key: dict[int, list] = {}
    for s in spans:
        for k in thread_keys(s):
            by_key.setdefault(k, []).append(s)
    lines = {k: _Timeline(v) for k, v in by_key.items()}
    device_s: dict[int, float] = {}
    uncharged = total = 0.0
    for op in ops:
        d = min(op.end, t1) - max(op.start, t0)
        if d <= 0:
            continue
        total += d
        line = lines.get(op.thread) if op.launched is not None else None
        owner = line.innermost(op.launched) if line is not None else None
        if owner is None:
            uncharged += d
            continue
        sid = owner.attrs["id"]
        device_s[sid] = device_s.get(sid, 0.0) + d
    return Charge(device_s, uncharged, total)
