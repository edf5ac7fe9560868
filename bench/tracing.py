"""The benchmark's spans, the device trace, and what is read from them.

Spans are recorded by the benchmark's own code around its calls into the
system: each dispatch (``BatchRunner.run_batch``), each write, and in a
traced run each probe-kernel wrapper, with the bytes its operands need.
They are kept in memory and written to one file when the run ends.

In a traced run ``torch.profiler`` records the device's kernels, copies
and sets over the window.  The profiler's clock is aligned with the
spans' (``time.perf_counter``) by one marker recorded in both, so idle
device time can be charged to the host span open at the time.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import threading
import time
from pathlib import Path

from bench.kernels import PROBE_WRAPPERS, probe_launch_bytes


@dataclasses.dataclass
class Span:
    name: str
    start: float    # time.perf_counter() seconds
    end: float
    thread: int
    attrs: dict


class Spans:
    """Spans kept in memory."""

    def __init__(self):
        self.items: list[Span] = []

    def add(self, name: str, start: float, end: float, **attrs) -> None:
        self.items.append(Span(name, start, end, threading.get_ident(),
                               attrs))

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        t = time.perf_counter()
        try:
            yield attrs
        finally:
            self.add(name, t, time.perf_counter(), **attrs)

    def named(self, prefix: str) -> list[Span]:
        return [s for s in self.items if s.name.startswith(prefix)]

    def dump(self, path: Path) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            for s in self.items:
                f.write(json.dumps({"name": s.name, "start": s.start,
                                    "end": s.end, "thread": s.thread,
                                    **s.attrs}) + "\n")


def wrap_dispatch(runner, spans: Spans, peak) -> None:
    """Span every dispatch of a ``BatchRunner`` (an instance attribute, so
    the class stays as it is), with the allocator's peak at its end
    (``peak()``)."""
    run_batch = runner.run_batch

    @functools.wraps(run_batch)
    def traced(snap, name, params_list, *a, **k):
        with spans.span(f"dispatch.{name}", width=len(params_list),
                        epoch=getattr(snap, "epoch", None)) as attrs:
            out = run_batch(snap, name, params_list, *a, **k)
            attrs["peak"] = peak()
            return out

    runner.run_batch = traced


@contextlib.contextmanager
def probe_spans(ops_module, spans: Spans):
    """Span each probe-kernel wrapper call made through ``ops_module``
    (``repro_torch.kernels.ops``, where the engine reaches them), with the
    bytes its launch needs; restores the wrappers on exit."""
    saved = {}
    for name in PROBE_WRAPPERS:
        fn = getattr(ops_module, name)
        saved[name] = fn

        def traced(*args, _fn=fn, _name=name):
            moved = probe_launch_bytes(_name, args)
            with spans.span(f"kernel.{_name}", bytes=moved):
                return _fn(*args)

        setattr(ops_module, name, traced)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops_module, name, fn)


@dataclasses.dataclass(frozen=True)
class DeviceEvent:
    name: str
    start: float    # perf_counter seconds
    end: float


def device_events(prof, marker: str, marker_at: float) -> list[DeviceEvent]:
    """The device's operations in a finished ``torch.profiler`` run, on the
    spans' clock.  ``marker`` names a host event recorded at
    ``marker_at`` (perf_counter seconds)."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    offset = None
    for e in events:
        if e.name() == marker and e.device_type() == DeviceType.CPU:
            offset = e.start_ns() * 1e-9 - marker_at
            break
    if offset is None:
        raise RuntimeError(f"profiler trace lacks the marker {marker!r}")
    out = []
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            continue
        s = e.start_ns() * 1e-9 - offset
        out.append(DeviceEvent(e.name(), s, s + e.duration_ns() * 1e-9))
    out.sort(key=lambda e: e.start)
    return out


def clip(events: list[DeviceEvent], t0: float, t1: float
         ) -> list[DeviceEvent]:
    """Events cut to the window ``[t0, t1]``."""
    return [DeviceEvent(e.name, max(e.start, t0), min(e.end, t1))
            for e in events if e.end > t0 and e.start < t1]


def busy_intervals(events: list[DeviceEvent]) -> list[tuple[float, float]]:
    """The union of the events' intervals, in order."""
    out: list[list[float]] = []
    for e in sorted(events, key=lambda e: e.start):
        if out and e.start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e.end)
        else:
            out.append([e.start, e.end])
    return [(a, b) for a, b in out]


def _host_segments(spans: list[Span]) -> list[tuple[float, float, str]]:
    """The timeline as ``(start, end, innermost open span)`` pieces: where
    spans overlap, the one that started last."""
    edges = sorted([(s.start, 1, i) for i, s in enumerate(spans)]
                   + [(s.end, 0, i) for i, s in enumerate(spans)])
    active: list[int] = []
    out = []
    prev = None
    for t, opening, i in edges:
        if active and prev is not None and t > prev:
            label = max(active, key=lambda j: spans[j].start)
            out.append((prev, t, spans[label].name))
        if opening:
            active.append(i)
        else:
            active.remove(i)
        prev = t
    return out


def breakdown(events: list[DeviceEvent], spans: list[Span], t0: float,
              t1: float, top: int = 10) -> dict:
    """The device operations that took most time, and the device's idle
    time by the host span open meanwhile (the innermost one)."""
    by_op: dict[str, float] = {}
    for e in events:
        by_op[e.name] = by_op.get(e.name, 0.0) + (e.end - e.start)
    idle_pieces = []
    prev = t0
    for a, b in busy_intervals(events) + [(t1, t1)]:
        if a > prev:
            idle_pieces.append((prev, a))
        prev = max(prev, b)
    gaps: dict[str, float] = {}
    segs = _host_segments(spans)
    j = 0
    for a, b in idle_pieces:
        covered = 0.0
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            lo, hi = max(a, segs[k][0]), min(b, segs[k][1])
            if hi > lo:
                gaps[segs[k][2]] = gaps.get(segs[k][2], 0.0) + (hi - lo)
                covered += hi - lo
            k += 1
        if b - a > covered:
            gaps["no benchmark span"] = gaps.get("no benchmark span", 0.0) \
                + (b - a - covered)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle]}
