"""The resilient serving tier: admission → batch → execute → degrade.

PyTorch port of ``repro.serving.scheduler``.  One :class:`QueryScheduler`
fronts one engine.  Requests pass four gates (DESIGN.md §11):

* **admission** — a bounded queue; overflow is an *explicit*
  ``rejected`` response carrying ``retry_after_s`` estimated from the
  cost model, never silent growth or blocking.
* **batching** — compatible requests (same query id) fold into one
  batched dispatch; ``core.planner.plan_batch`` prices batch width
  against the tightest deadline in the group, halving until the modeled
  dispatch fits the slack.
* **maintained views** — a canonical request (``PARAM_QUERIES[name]
  .defaults``) is answered from the pinned snapshot's frozen maintained
  answers when a ``repro_torch.ivm.MaintainedSuite`` was fresh at its
  epoch (``ServeConfig.serve_maintained``); everything else dispatches.
* **execution** — every dispatch runs inside one fault-isolated
  :class:`~repro_torch.serving.workers.Worker` against a pinned
  :class:`~repro_torch.engine.snapshot.EpochSnapshot`.  A crash kills only
  that worker; the batch retries with backoff on a fresh snapshot up to
  ``max_retries``, then fails *explicitly*.
* **degrade** — a per-query circuit breaker: ``breaker_threshold``
  consecutive fused-path crashes route that query id through the
  composed (one request at a time) path for ``breaker_cooldown`` serves,
  then half-open.  Separately, when snapshot refresh fails (ingest stalled,
  recovery in flight) the scheduler keeps serving the last pinned
  snapshot and stamps every response with its ``epoch_lag``.

The invariant all four gates preserve: **degraded or rejected, never
wrong** — every ``ok`` response is bit-identical to the single-threaded
oracle at the epoch the response reports (chaos-tested in
``tests/test_torch_serving_chaos.py``).

Counters: ``stats`` (and ``info()``) count requests by outcome
(``submitted``, ``completed``, ``rejected``, ``timed_out``, ``failed``),
``retries``, dispatches (``batches``, ``composed_batches``), snapshot
refreshes (``refreshes``: the snapshots the scheduler took after its
first; ``refresh_failures``), background compactions and requests served
from maintained views.  Spans (``repro_torch.trace``, off unless a run
enables the recorder): ``serve.queue`` from ``submit`` until a batch takes
the request, ``serve.batch`` around each dispatch and ``serve.refresh``
around each refresh.

Pricing: both pricing sites (``submit``'s ``retry_after_s`` and the batch
width) price on the pinned snapshot's device type, the cost model's
``"cpu"`` or ``"cuda"`` entry.  On the CPU the plans equal the JAX
package's, which prices every device with its CPU entry.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable

import numpy as np

from repro_torch import trace
from repro_torch.core import costmodel
from repro_torch.core.planner import plan_batch
from repro_torch.durability.faults import NULL_FAULTS
from repro_torch.serving.batch import BatchRunner
from repro_torch.serving.params import PARAM_QUERIES
from repro_torch.serving.workers import WorkerCrash, WorkerPool

OK = "ok"
REJECTED = "rejected"
TIMED_OUT = "timed_out"
FAILED = "failed"


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Scheduler knobs; defaults suit tests — production would tune."""

    max_queue: int = 64          # admission bound (requests, all ids)
    max_batch: int = 16          # widest batched dispatch
    n_workers: int = 2
    checkout_timeout_s: float = 5.0
    max_retries: int = 2         # per batch, after the first attempt
    backoff_s: float = 0.005     # linear: attempt * backoff_s
    breaker_threshold: int = 3   # fused crashes in a row -> open
    breaker_cooldown: int = 8    # composed serves before half-open
    serve_maintained: bool = True  # answer canonical queries from fresh
    #                                maintained views
    default_deadline_s: float | None = None
    clock: Callable[[], float] = time.monotonic


@dataclasses.dataclass
class Response:
    """What every request resolves to — one of the four statuses.

    ``epoch`` is the snapshot epoch an ``ok`` result was computed at;
    ``epoch_lag`` how far the head had advanced when it resolved (the
    staleness contract: lag is reported, never hidden); ``degraded``
    marks composed-path or stale-pin service."""

    status: str
    name: str
    params: tuple[int, ...]
    total: int | None = None
    groups: np.ndarray | None = None
    epoch: int | None = None
    epoch_lag: int = 0
    degraded: bool = False
    stale: bool = False
    retries: int = 0
    retry_after_s: float | None = None
    reason: str = ""

    @property
    def ok(self) -> bool:
        return self.status == OK


class Ticket:
    """A submitted request's future; ``wait`` blocks for the response."""

    def __init__(self):
        self._ev = threading.Event()
        self.response: Response | None = None
        self.submitted_at: float | None = None   # wall (time.monotonic)
        self.resolved_at: float | None = None

    def _resolve(self, resp: Response) -> None:
        self.resolved_at = time.monotonic()
        self.response = resp
        self._ev.set()

    @property
    def latency_s(self) -> float | None:
        if self.resolved_at is None or self.submitted_at is None:
            return None
        return self.resolved_at - self.submitted_at

    def wait(self, timeout: float | None = None) -> Response | None:
        self._ev.wait(timeout)
        return self.response

    @property
    def done(self) -> bool:
        return self._ev.is_set()


@dataclasses.dataclass
class _Item:
    ticket: Ticket
    name: str
    params: tuple[int, ...]
    deadline: float | None   # absolute, in config.clock time
    qspan: trace.Span | None = None   # its ``serve.queue`` span, if traced
    batch: int | None = None          # the traced batch that took it


class _Pinned:
    """Refcounted snapshot pin: the scheduler holds one ref, each
    executing batch holds one for the length of its dispatch; the
    snapshot releases when the last ref drops (a retired pin can finish
    serving in-flight batches after a refresh swaps it out)."""

    def __init__(self, snap):
        self.snap = snap
        self._refs = 1
        self._mu = threading.Lock()

    def acquire(self) -> "_Pinned":
        with self._mu:
            self._refs += 1
        return self

    def release(self) -> None:
        with self._mu:
            self._refs -= 1
            dead = self._refs == 0
        if dead:
            self.snap.release()


class _Breaker:
    """Per-query-id circuit breaker over the fused batch path."""

    def __init__(self, threshold: int, cooldown: int):
        self.threshold = threshold
        self.cooldown = cooldown
        self.streak = 0
        self.open_for = 0   # composed serves left before half-open
        self.trips = 0

    @property
    def open(self) -> bool:
        return self.open_for > 0

    def record_fused(self, ok: bool) -> None:
        if ok:
            self.streak = 0
            return
        self.streak += 1
        if self.streak >= self.threshold:
            self.open_for = self.cooldown
            self.streak = 0
            self.trips += 1

    def record_composed_serve(self) -> None:
        if self.open_for > 0:
            self.open_for -= 1   # at 0: half-open, next serve tries fused


class QueryScheduler:
    """Batched, deadline-aware, fault-isolated serving over snapshots."""

    def __init__(self, engine, config: ServeConfig | None = None, *,
                 faults=NULL_FAULTS):
        self.engine = engine
        self.config = config or ServeConfig()
        self.faults = faults
        # the engine's ExecutionPolicy decides the default serve flavor
        # (fusion="mega" → one-launch dispatch); the breaker ladders any
        # flavor down to composed and never re-enters a poisoned kernel
        self.runner = BatchRunner(policy=getattr(engine, "policy", None))
        self.pool = WorkerPool(self.config.n_workers, faults)
        self._mu = threading.RLock()
        self._queue: list[_Item] = []
        self._pin = _Pinned(engine.snapshot())
        self._breakers: dict[str, _Breaker] = {}
        self._threads: list[threading.Thread] = []
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._closed = False
        self.stats = {"submitted": 0, "completed": 0, "rejected": 0,
                      "timed_out": 0, "failed": 0, "retries": 0,
                      "batches": 0, "composed_batches": 0,
                      "refreshes": 0, "refresh_failures": 0,
                      "bg_compactions": 0, "bg_compact_conflicts": 0,
                      "maintained_served": 0}

    # -- admission ---------------------------------------------------------
    def submit(self, name: str, params=None, *,
               deadline_s: float | None = None) -> Ticket:
        """Admit one request; full queue resolves immediately as
        ``rejected`` with a cost-model ``retry_after_s`` — load is shed
        at the door, never queued unboundedly."""
        qspan = trace.begin("serve.queue", query=name)
        if name not in PARAM_QUERIES:
            trace.finish(qspan, outcome="invalid")
            raise KeyError(f"unknown query {name!r}")
        pq = PARAM_QUERIES[name]
        p = pq.defaults if params is None else tuple(int(x) for x in params)
        if len(p) != pq.n_params:
            trace.finish(qspan, outcome="invalid")
            raise ValueError(f"{name} takes {pq.n_params} params "
                             f"{pq.params}, got {len(p)}")
        ticket = Ticket()
        ticket.submitted_at = time.monotonic()
        if deadline_s is None:
            deadline_s = self.config.default_deadline_s
        deadline = None if deadline_s is None else \
            self.config.clock() + deadline_s
        with self._mu:
            self.stats["submitted"] += 1
            if self._closed:
                ticket._resolve(Response(REJECTED, name, p,
                                         reason="scheduler closed"))
                self.stats["rejected"] += 1
                trace.finish(qspan, outcome=REJECTED)
                return ticket
            if len(self._queue) >= self.config.max_queue:
                snap = self._pin.snap
                drain = costmodel.batch_serve_seconds(
                    self.config.max_batch, snap.tables["lineorder"].n_rows,
                    backend=snap.device.type) * (
                    1 + len(self._queue) / self.config.max_batch)
                # clamp: never negative, and never shorter than the
                # tightest admitted deadline slack — a client retrying
                # on schedule must not land in a queue that is still
                # obligated to serve everything admitted ahead of it
                now = self.config.clock()
                slacks = [it.deadline - now for it in self._queue
                          if it.deadline is not None]
                retry_after = max(0.0, drain,
                                  max(0.0, min(slacks)) if slacks else 0.0)
                ticket._resolve(Response(REJECTED, name, p,
                                         retry_after_s=retry_after,
                                         reason="queue full"))
                self.stats["rejected"] += 1
                trace.finish(qspan, outcome=REJECTED)
                return ticket
            self._queue.append(_Item(ticket, name, p, deadline, qspan))
        self._wake.set()
        return ticket

    # -- snapshot refresh / degraded pinning -------------------------------
    def _refresh(self, *, force: bool = False) -> None:
        """Swap the pin to a fresh snapshot of the current engine.

        Failure (injected via the ``snapshot_refresh`` site, or a real
        one — engine mid-recovery, closed) keeps the old pin: serving
        degrades to stale-with-reported-lag instead of erroring."""
        with trace.span("serve.refresh") as sp:
            with self._mu:
                if not force and self.engine.epoch <= self._pin.snap.epoch:
                    sp.set(taken=False)
                    return
                try:
                    self.faults.hit("snapshot_refresh")
                    snap = self.engine.snapshot()
                except Exception:
                    self.stats["refresh_failures"] += 1
                    sp.set(taken=False)
                    return
                old, self._pin = self._pin, _Pinned(snap)
                self.stats["refreshes"] += 1
            sp.set(taken=True)
            old.release()

    def rebind(self, engine) -> None:
        """Point the scheduler at a recovered engine incarnation.

        The old incarnation's pinned snapshot keeps serving (stale,
        lag-stamped) until the first successful refresh against the new
        engine — recovery never blackholes in-flight traffic."""
        with self._mu:
            self.engine = engine
            self.runner.policy = getattr(engine, "policy",
                                         self.runner.policy)
        self._refresh(force=True)

    def _lag(self, snap) -> int:
        return max(0, self.engine.epoch - snap.epoch)

    # -- batching ----------------------------------------------------------
    def _next_batch(self) -> list[_Item] | None:
        cfg = self.config
        now = cfg.clock()
        with self._mu:
            survivors = []
            for it in self._queue:   # queue-exit deadline check
                if it.deadline is not None and now > it.deadline:
                    it.ticket._resolve(Response(
                        TIMED_OUT, it.name, it.params,
                        reason="deadline passed in queue"))
                    self.stats["timed_out"] += 1
                    trace.finish(it.qspan, outcome=TIMED_OUT)
                else:
                    survivors.append(it)
            self._queue = survivors
            if not self._queue:
                return None
            name = self._queue[0].name
            same = [it for it in self._queue if it.name == name]
            slacks = [it.deadline - now for it in same
                      if it.deadline is not None]
            snap = self._pin.snap
            plan = plan_batch(
                queue_depth=len(same),
                slack_s=min(slacks) if slacks else None,
                n_rows=snap.tables["lineorder"].n_rows,
                max_batch=cfg.max_batch, backend=snap.device.type)
            take = same[:plan.size]
            taken = set(map(id, take))
            self._queue = [it for it in self._queue
                           if id(it) not in taken]
        if trace.enabled():
            batch = trace.next_id()
            for it in take:
                it.batch = batch
                trace.finish(it.qspan, batch=batch)
        return take

    # -- maintained-view fast path -------------------------------------------
    def _serve_maintained(self, live: list[_Item]) -> list[_Item]:
        """Answer the requests the pinned snapshot's maintained views cover;
        return the rest.

        A maintained answer exists only for the canonical parameter point
        (the constants the 13 views are defined over) and only when the
        suite was fresh at the snapshot's epoch, where it equals what the
        dispatch would compute against the same snapshot.  An invalidated
        or stale suite contributes nothing: its requests dispatch.
        """
        if not self.config.serve_maintained:
            return live
        with self._mu:
            pin = self._pin.acquire()
        try:
            m = pin.snap.maintained
            if not m:
                return live
            epoch, lag = pin.snap.epoch, self._lag(pin.snap)
            rest: list[_Item] = []
            served = 0
            for it in live:
                if it.name in m and \
                        it.params == PARAM_QUERIES[it.name].defaults:
                    total, groups = m[it.name]
                    it.ticket._resolve(Response(
                        OK, it.name, it.params, total=int(total),
                        groups=np.array(groups, copy=True), epoch=epoch,
                        epoch_lag=lag, stale=lag > 0))
                    served += 1
                else:
                    rest.append(it)
            if served:
                with self._mu:
                    self.stats["maintained_served"] += served
                    self.stats["completed"] += served
            return rest
        finally:
            pin.release()

    # -- execution ---------------------------------------------------------
    def _execute(self, batch: list[_Item]) -> None:
        cfg = self.config
        name = batch[0].name
        self._refresh()
        now = cfg.clock()
        live = []
        for it in batch:             # batch-boundary deadline recheck
            if it.deadline is not None and now > it.deadline:
                it.ticket._resolve(Response(
                    TIMED_OUT, it.name, it.params,
                    reason="deadline passed at batch boundary"))
                self.stats["timed_out"] += 1
            else:
                live.append(it)
        if not live:
            return
        live = self._serve_maintained(live)
        if not live:
            return
        with self._mu:
            breaker = self._breakers.setdefault(
                name, _Breaker(cfg.breaker_threshold, cfg.breaker_cooldown))
            composed = breaker.open
            if composed:
                breaker.record_composed_serve()
        params = [it.params for it in live]
        attempt = 0
        while True:
            with self._mu:
                pin = self._pin.acquire()
            worker = self.pool.checkout(cfg.checkout_timeout_s)
            err: Exception | None = None
            results = None
            if worker is None:
                err = WorkerCrash("no worker available before timeout")
            else:
                try:
                    results = worker.run(
                        lambda: self.runner.run_batch(
                            pin.snap, name, params, composed=composed,
                            faults=self.faults))
                except WorkerCrash as e:
                    err = e
                finally:
                    self.pool.checkin(worker)
            if err is None:
                epoch, lag = pin.snap.epoch, self._lag(pin.snap)
                pin.release()
                with self._mu:
                    if not composed:
                        breaker.record_fused(True)
                    self.stats["batches"] += 1
                    if composed:
                        self.stats["composed_batches"] += 1
                    self.stats["completed"] += len(live)
                    refresh_failing = self.stats["refresh_failures"] > 0 \
                        and lag > 0
                for it, (total, groups) in zip(live, results):
                    it.ticket._resolve(Response(
                        OK, it.name, it.params, total=total, groups=groups,
                        epoch=epoch, epoch_lag=lag, stale=lag > 0,
                        degraded=composed or refresh_failing,
                        retries=attempt))
                return
            pin.release()
            with self._mu:
                if not composed:
                    breaker.record_fused(False)
                self.stats["retries"] += 1
            attempt += 1
            if attempt > cfg.max_retries:
                with self._mu:
                    self.stats["failed"] += len(live)
                for it in live:
                    it.ticket._resolve(Response(
                        FAILED, it.name, it.params, retries=attempt,
                        reason=f"batch failed after {attempt} attempts: "
                               f"{err}"))
                return
            time.sleep(attempt * cfg.backoff_s)
            self._refresh(force=True)   # retry against a fresh snapshot

    # -- drive -------------------------------------------------------------
    def pump(self, max_batches: int | None = None) -> int:
        """Deterministic drive: form and execute up to ``max_batches``
        batches on the calling thread (tests; threaded mode loops this)."""
        done = 0
        while max_batches is None or done < max_batches:
            batch = self._next_batch()
            if batch is None:
                break
            with trace.span("serve.batch", query=batch[0].name,
                            batch=batch[0].batch, width=len(batch)):
                self._execute(batch)
            done += 1
        return done

    def start(self, n_dispatchers: int = 1) -> None:
        """Threaded mode: dispatcher loops pumping as requests arrive."""

        def loop():
            while not self._stop.is_set():
                if self.pump(1) == 0:
                    self._wake.wait(0.002)
                    self._wake.clear()

        for i in range(n_dispatchers):
            t = threading.Thread(target=loop, name=f"dispatch-{i}",
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        for t in self._threads:
            t.join(timeout=10.0)
        self._threads.clear()

    def close(self) -> None:
        """Stop dispatchers, reject the residue, release the pin."""
        self.stop()
        with self._mu:
            self._closed = True
            residue, self._queue = self._queue, []
        for it in residue:
            it.ticket._resolve(Response(REJECTED, it.name, it.params,
                                        reason="scheduler closed"))
            trace.finish(it.qspan, outcome=REJECTED)
            with self._mu:
                self.stats["rejected"] += 1
        with self._mu:
            pin, self._pin = self._pin, None
        if pin is not None:
            pin.release()

    # -- background compaction (satellite: off the serving path) -----------
    def compact_in_background(self, dim: str, *, retries: int = 3
                              ) -> threading.Thread:
        """Run ``prepare_compact``/``publish_compact`` on a maintenance
        thread: the O(merge) work happens off-lock, queries keep serving
        the pinned snapshot throughout, and a publish conflict (someone
        else swapped the index first) re-stages a bounded number of
        times."""

        def work():
            for _ in range(max(1, retries)):
                self.faults.hit(f"compact_prepare:{dim}")
                prepared = self.engine.prepare_compact(dim)
                if prepared is None:
                    return
                self.faults.hit(f"compact_publish:{dim}")
                if self.engine.publish_compact(prepared):
                    with self._mu:
                        self.stats["bg_compactions"] += 1
                    return
                with self._mu:
                    self.stats["bg_compact_conflicts"] += 1

        t = threading.Thread(target=work, name=f"compact-{dim}",
                             daemon=True)
        t.start()
        return t

    # -- introspection -----------------------------------------------------
    def info(self) -> dict:
        with self._mu:
            out = dict(self.stats)
            out["queue_depth"] = len(self._queue)
            out["pinned_epoch"] = None if self._pin is None else \
                self._pin.snap.epoch
            out["worker_deaths"] = self.pool.deaths
            out["breaker_trips"] = sum(b.trips
                                       for b in self._breakers.values())
            out["breakers_open"] = sorted(n for n, b in
                                          self._breakers.items() if b.open)
        return out
