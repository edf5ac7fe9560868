"""Fault-isolated executors: a worker dies, the pool replaces it.

PyTorch port of ``repro.serving.workers`` (host-only Python).

Workers are the blast-radius boundary of the serving tier.  Every batch
dispatch runs inside exactly one worker; any exception escaping the
dispatch — injected fault, poisoned kernel, real bug — marks that worker
dead and surfaces as :class:`WorkerCrash` to the scheduler, which retries
the batch on a *fresh* worker against a *fresh* snapshot.  The pool never
shrinks: checking a dead worker back in mints a replacement with a new
id, so a crash loop degrades throughput but can never deadlock admission.
"""
from __future__ import annotations

import itertools
import threading

from repro_torch.durability.faults import NULL_FAULTS


class WorkerCrash(RuntimeError):
    """A worker died mid-dispatch; the batch it held is unserved."""


class Worker:
    """One executor slot.  ``run`` is the only entry point; the fault
    registry sees ``worker:{wid}`` before the payload runs."""

    def __init__(self, wid: int, faults=NULL_FAULTS):
        self.wid = wid
        self.faults = faults
        self.alive = True
        self.dispatches = 0

    def run(self, fn):
        if not self.alive:
            raise WorkerCrash(f"worker {self.wid} is dead")
        try:
            self.faults.hit(f"worker:{self.wid}")
            out = fn()
        except Exception as e:
            self.alive = False
            raise WorkerCrash(
                f"worker {self.wid} died in dispatch: {e}") from e
        self.dispatches += 1
        return out


class WorkerPool:
    """Fixed-width pool with blocking checkout and dead-worker renewal."""

    def __init__(self, n: int, faults=NULL_FAULTS):
        if n < 1:
            raise ValueError("pool needs at least one worker")
        self.faults = faults
        self._ids = itertools.count()
        self._cv = threading.Condition()
        self._free = [Worker(next(self._ids), faults) for _ in range(n)]
        self.width = n
        self.deaths = 0

    def checkout(self, timeout: float | None = None) -> Worker | None:
        """A free worker, blocking up to ``timeout``; None on timeout."""
        with self._cv:
            if not self._cv.wait_for(lambda: self._free, timeout=timeout):
                return None
            return self._free.pop()

    def checkin(self, worker: Worker) -> None:
        """Return a worker; a dead one is replaced by a fresh slot."""
        with self._cv:
            if worker.alive:
                self._free.append(worker)
            else:
                self.deaths += 1
                self._free.append(Worker(next(self._ids), self.faults))
            self._cv.notify()
