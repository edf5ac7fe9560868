"""Reusable fault-point machinery for the serving and durability tiers.

PyTorch port's copy of ``repro.durability.faults``, host-only Python.
Three layers, smallest first:

* :class:`OpSchedule`: the numbered-op kill schedule behind
  ``FailpointFS``: every instrumented operation consumes one op number,
  ``arm(crash_at, mode, site=)`` picks which op (optionally counting only
  ops under a site prefix) is the kill.
* :class:`FaultRegistry`: named fault *points*.  Production code calls
  ``faults.hit(site)`` at interesting places (worker bodies, batch
  dispatches, the serving tier's snapshot refresh, background
  compaction); harnesses attach hooks by site prefix that raise (crash),
  sleep (straggler) or record.  The shared default :data:`NULL_FAULTS`
  makes every hit a no-op.
* :class:`SiteProxy` / :func:`checkpoint_crash_sites` / :func:`boom_on`:
  module-proxy instrumentation that reports chosen syscalls of the
  checkpoint writer (``repro_torch.checkpoint.manager``) as crash sites,
  and a "raise at the nth hit" hook.
"""
from __future__ import annotations

import contextlib
import time
from collections import Counter
from typing import Callable


class CrashPoint(RuntimeError):
    """Simulated process/worker kill raised by an armed fault point."""


class OpSchedule:
    """Numbered-op kill schedule (the counting core of ``FailpointFS``).

    Every instrumented operation calls :meth:`tick` with a site name and
    consumes one op number.  ``arm(crash_at, mode)`` schedules a kill at
    a chosen op with a chosen overlap; what "before"/"partial"/"after"
    mean is up to the caller (for an fs write: payload never cached / a
    torn prefix cached / fully cached).  With ``site=`` the count runs
    over ops whose site name starts with that prefix, so one schedule
    can aim kills at one subsystem however many other ops precede it.
    """

    MODES = ("before", "partial", "after")

    def __init__(self) -> None:
        self.op = 0
        self.crash_at: int | None = None
        self.mode = "after"
        self.site: str | None = None
        self._site_seen = 0
        self.crashed_at: tuple[int, str, str] | None = None

    def arm(self, crash_at: int, mode: str = "after",
            site: str | None = None) -> None:
        assert mode in self.MODES, mode
        self.crash_at = int(crash_at)
        self.mode = mode
        self.site = site
        self._site_seen = 0

    def disarm(self) -> None:
        self.crash_at = None
        self.site = None

    def tick(self, site: str) -> bool:
        """Advance the op counter; True when this op is the kill."""
        n = self.op
        self.op += 1
        if self.crash_at is None:
            return False
        if self.site is not None:
            if not site.startswith(self.site):
                return False
            n = self._site_seen
            self._site_seen += 1
        if n == self.crash_at:
            self.crashed_at = (n, site, self.mode)
            return True
        return False


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


class SiteProxy:
    """Module stand-in reporting chosen attributes as fault sites.

    Wraps a real module; lookups of names in ``sites`` return the real
    callable behind a ``hook(f"{tag}{name}")`` call.  A hook that raises
    models a kill with that syscall never issued.
    """

    def __init__(self, real, sites, hook, tag: str = ""):
        self._real, self._sites, self._hook, self._tag = \
            real, sites, hook, tag

    def __getattr__(self, name):
        attr = getattr(self._real, name)
        if name in self._sites:
            hook, tag = self._hook, self._tag

            def _wrapped(*a, __attr=attr, __name=name, **k):
                hook(f"{tag}{__name}")
                return __attr(*a, **k)

            return _wrapped
        return attr


@contextlib.contextmanager
def checkpoint_crash_sites(hook: Callable[[str], None]):
    """Route the checkpoint writer's syscalls through ``hook(site)``.

    Sites: ``ckpt_save`` (leaf write), ``ckpt_fsync``, ``ckpt_replace``
    (the commit rename).  ``hook`` runs *before* the real operation: a
    hook that raises models a kill with that syscall never issued (the
    tmp dir keeps whatever the prior ops durably wrote).
    """
    import repro_torch.checkpoint.manager as cm

    real_np, real_os = cm.np, cm.os
    cm.np = SiteProxy(real_np, {"save"}, hook, tag="ckpt_")
    cm.os = SiteProxy(real_os, {"fsync", "replace"}, hook, tag="ckpt_")
    try:
        yield
    finally:
        cm.np, cm.os = real_np, real_os
