"""Named fault points for harnesses (serving now, durability later).

PyTorch port's copy of the part of ``repro.durability.faults`` that the
serving tier and its harnesses use, host-only Python.  ``OpSchedule``,
``SiteProxy`` and ``checkpoint_crash_sites`` drive the write-ahead log's
and the checkpoint writer's crash harness and arrive with the durability
slice.  Production code marks interesting places with
``faults.hit(site)`` (worker bodies, batch dispatches, the serving
tier's snapshot refresh, background compaction); a harness arms
behaviour at those sites by prefix:

* :class:`FaultRegistry`: named fault points with prefix-matched hooks
  that raise (crash), sleep (straggler) or record.  The shared default
  :data:`NULL_FAULTS` makes every hit a no-op.
* :func:`boom_on`: a "raise at the nth hit" hook.
"""
from __future__ import annotations

import time
from collections import Counter
from typing import Callable


class CrashPoint(RuntimeError):
    """Simulated process/worker kill raised by an armed fault point."""


class FaultRegistry:
    """Named fault points with prefix-matched hooks.

    Production code marks interesting places with ``faults.hit(site)``;
    a chaos harness arms behavior at those sites:

    >>> faults = FaultRegistry()
    >>> faults.crash_on("worker:", nth=3)       # third worker entry dies
    >>> faults.delay_on("kernel_batch:Q1.1", 0.05)   # straggler
    >>> faults.on("snapshot_refresh", lambda s: 1/0)  # arbitrary hook

    Hooks run in registration order; the first one that raises wins.
    ``hits`` counts every site seen (armed or not) so tests can assert
    a fault point was actually exercised.
    """

    def __init__(self) -> None:
        self._hooks: list[tuple[str, Callable[[str], None]]] = []
        self.hits: Counter[str] = Counter()

    # -- instrumentation side ---------------------------------------------
    def hit(self, site: str) -> None:
        self.hits[site] += 1
        if not self._hooks:
            return
        for prefix, fn in list(self._hooks):
            if site.startswith(prefix):
                fn(site)

    # -- harness side ------------------------------------------------------
    def on(self, prefix: str, fn: Callable[[str], None]) -> None:
        """Run ``fn(site)`` at every hit whose site starts with ``prefix``."""
        self._hooks.append((prefix, fn))

    def crash_on(self, prefix: str, nth: int = 1,
                 exc: type[BaseException] = CrashPoint) -> None:
        """Raise ``exc`` at the nth hit under ``prefix``."""
        self.on(prefix, boom_on(prefix, nth, exc=exc, prefix=True))

    def delay_on(self, prefix: str, seconds: float, nth: int = 1,
                 every: bool = False) -> None:
        """Sleep at the nth (or every nth) hit under ``prefix``."""
        seen = {"n": 0}

        def hook(site: str) -> None:
            seen["n"] += 1
            if seen["n"] == nth or (every and seen["n"] % nth == 0):
                time.sleep(seconds)

        self.on(prefix, hook)

    def clear(self) -> None:
        self._hooks.clear()
        self.hits.clear()

    @property
    def armed(self) -> bool:
        return bool(self._hooks)


class _NullFaults(FaultRegistry):
    """Shared default: every hit is a no-op and hooks are refused."""

    def hit(self, site: str) -> None:  # noqa: D102 - hot path no-op
        pass

    def on(self, prefix, fn):  # pragma: no cover - misuse guard
        raise RuntimeError("NULL_FAULTS is shared; build a FaultRegistry")


NULL_FAULTS: FaultRegistry = _NullFaults()


def boom_on(site: str, nth: int = 1,
            exc: type[BaseException] = CrashPoint,
            prefix: bool = False) -> Callable[[str], None]:
    """Hook raising ``exc`` at the nth occurrence of ``site``.

    With ``prefix=True`` any site starting with ``site`` counts."""
    seen = {"n": 0}

    def hook(s: str) -> None:
        if s.startswith(site) if prefix else s == site:
            seen["n"] += 1
            if seen["n"] == nth:
                raise exc(f"kill at {s} #{nth}")

    return hook
