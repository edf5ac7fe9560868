"""Spans recorded inside the program, off unless a run turns them on.

A span is one timed piece of work on one thread: ``name``, ``id``,
``parent`` (the id of the span open around it on the same thread, or
None), ``start`` and ``end`` on ``time.perf_counter()``, the thread
(``thread``: ``threading.get_ident()``; ``native``: the operating
system's id of it) and attributes.  A span opened inside another takes
the enclosing span's ``batch`` and ``dim`` unless it sets its own, so
every span of one dispatch carries the dispatch's batch id.

``enable()`` starts recording and ``disable()`` stops it, returning the
spans that ended in between.  They stay in memory until then.  While the
recorder is off, ``span()`` returns one shared no-op context and reads no
clock, ``begin()`` returns None and ``locked()`` returns the lock itself:
a site costs one check of a module-level flag.

The sites, by layer: ``serve.queue`` (from ``submit`` until a batch takes
the request, begun and finished on different threads), ``serve.batch``
and ``serve.refresh`` (``serving/scheduler.py``); ``batch.probes``,
``batch.tail`` and ``batch.readback`` (``serving/batch.py``);
``snapshot.reprobe`` (``engine/snapshot.py``); ``engine.append_fact_rows``,
``engine.append_rows``, ``engine.ingest``, ``engine.extend_probe``,
``engine.compact`` and ``engine.skew_replan`` (``engine/queries.py``);
``engine.skew_measure`` (``engine/join.py``); ``engine.lock_wait``, the time
spent acquiring the engine lock where it exceeded ``LOCK_WAIT_MIN_S``;
``probe.overlay`` (``core/lookup.py``).
"""
from __future__ import annotations

import itertools
import threading
import time

# a lock acquisition that waited less than this records no span
LOCK_WAIT_MIN_S = 50e-6
# attributes a span takes from the span open around it
INHERITED = ("batch", "dim")

_on = False
_spans: list["Span"] = []
_ids = itertools.count(1)


class _Thread(threading.local):
    """Each thread's open spans and its two ids, read once per thread: the
    operating system's id costs a system call, on some hosts slower than
    all the rest of a span."""

    def __init__(self):
        self.stack: list[Span] = []
        self.ident = threading.get_ident()
        self.native = threading.get_native_id()


_local = _Thread()


class Span:
    """One recorded span; ``set`` adds attributes before it ends."""

    __slots__ = ("name", "id", "parent", "start", "end", "thread", "native",
                 "attrs", "_sink")

    def __init__(self, name: str, attrs: dict, parent: "Span | None"):
        self.name = name
        self.id = next(_ids)
        self.parent = None if parent is None else parent.id
        if parent is not None:
            for k in INHERITED:
                if k not in attrs and k in parent.attrs:
                    attrs[k] = parent.attrs[k]
        self.attrs = attrs
        self.thread = _local.ident
        self.native = _local.native
        self.start = time.perf_counter()
        self.end: float | None = None
        self._sink = _spans

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def _close(self) -> None:
        self.end = time.perf_counter()
        self._sink.append(self)

    def __enter__(self) -> "Span":
        _local.stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _local.stack.pop()
        self._close()

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"start={self.start}, end={self.end}, attrs={self.attrs})")


class _NoSpan:
    """The recorder's stand-in while it is off: a context that does
    nothing and takes no attributes."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NO_SPAN = _NoSpan()


def enable() -> None:
    """Start recording (dropping anything not yet collected)."""
    global _on, _spans
    _spans = []
    _on = True


def disable() -> list[Span]:
    """Stop recording; the spans that ended since ``enable()``, in the
    order they ended.  A span still open is not among them."""
    global _on, _spans
    _on = False
    out, _spans = _spans[:], []
    return out


def enabled() -> bool:
    return _on


def current() -> int | None:
    """The id of the span open innermost on this thread, or None."""
    s = _local.stack
    return s[-1].id if s else None


def within(names) -> bool:
    """Is a span named in ``names`` open on this thread?"""
    s = _local.stack
    return bool(s) and any(sp.name in names for sp in s)


def next_id() -> int:
    """A fresh id from the spans' sequence (a dispatch's batch id)."""
    return next(_ids)


def span(name: str, **attrs):
    """A context that records ``name`` around its block while the recorder
    is on; ``as sp`` gives the span, whose ``set`` adds attributes."""
    if not _on:
        return NO_SPAN
    s = _local.stack
    return Span(name, attrs, s[-1] if s else None)


def begin(name: str, **attrs) -> Span | None:
    """Start a span that ``finish`` ends, possibly on another thread
    (it opens no nesting on either); None while the recorder is off."""
    if not _on:
        return None
    s = _local.stack
    return Span(name, attrs, s[-1] if s else None)


def finish(sp: Span | None, **attrs) -> None:
    """End a span from ``begin`` (None: nothing was begun)."""
    if sp is not None:
        sp.attrs.update(attrs)
        sp._close()


class _TimedLock:
    __slots__ = ("lock", "site")

    def __init__(self, lock, site: str):
        self.lock = lock
        self.site = site

    def __enter__(self):
        if self.lock.acquire(blocking=False):
            return self
        t = time.perf_counter()
        self.lock.acquire()
        if time.perf_counter() - t >= LOCK_WAIT_MIN_S and _on:
            s = _local.stack
            sp = Span("engine.lock_wait", {"site": self.site},
                      s[-1] if s else None)
            sp.start = t
            sp._close()
        return self

    def __exit__(self, *exc) -> None:
        self.lock.release()


def locked(lock, site: str):
    """``lock`` as a context; while the recorder is on, a wait to acquire
    it of ``LOCK_WAIT_MIN_S`` or more is recorded as ``engine.lock_wait``
    with ``site``."""
    return _TimedLock(lock, site) if _on else lock
