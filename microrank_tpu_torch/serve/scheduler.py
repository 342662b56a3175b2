"""The batching scheduler: one thread owns the card (counterpart of
``microrank_tpu/serve/scheduler.py``).

Requests enter per-tenant FIFOs (the HTTP frontend's threads only
enqueue); a single scheduler thread pops them fairly (weighted stride
scheduling across tenants, ``sched.WeightedFairQueue``: one chatty
tenant cannot starve the rest), hands the host half (parse, admission,
detection, the C++ build) to the build worker pool (``stream.pool``,
shared with the stream engine), parks built windows in the
micro-batcher's shape buckets, and dispatches full or aged batches.
Host builds overlap the card's work under load; every touch of the
card stays on the scheduler thread, which issues the rank programs in
order on one stream. ``build_pool=None`` (ServeConfig.build_workers=0)
builds on the scheduler thread.

Drain: ``stop(drain=True)`` (the SIGTERM path) processes everything
already admitted — queues empty, every bucket force-flushed, every
future resolved — before the thread exits; ``drain=False`` fails queued
requests fast with a shutdown error.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Callable, Optional

from ..sched import WeightedFairQueue
from .batcher import MicroBatcher
from .protocol import RankRequest

_IDLE_POLL_S = 0.2


class ShutdownError(RuntimeError):
    """Queued request abandoned by a non-draining shutdown."""

    status = 503


class BatchScheduler(threading.Thread):
    def __init__(
        self, service, journal=None, build_pool=None, router=None,
        flight=None, sched=None,
    ):
        super().__init__(name="mr-serve-sched", daemon=True)
        self.service = service
        # Co-deploy: ``sched`` is the unified DeviceScheduler sharing
        # the device with stream/backfill. Built windows then park into
        # ITS store (the batcher dispatches when called back from the
        # scheduler thread that owns the device); this thread keeps the
        # host half — fair dequeue and build-pool handoff — and never
        # touches the device. Solo (sched=None) it owns the device
        # exactly as before.
        self.sched = sched
        self.batcher = MicroBatcher(
            service.config, journal=journal, router=router, flight=flight,
            store=sched.store if sched is not None else None,
        )
        self.build_pool = build_pool
        self._cond = threading.Condition()
        # Weighted fair dequeue across tenant FIFOs (sched.store): with
        # the default all-equal weights the pop order is exactly the
        # old round-robin interleave; SchedConfig.tenant_weights skews
        # turns toward heavier tenants.
        sched_cfg = getattr(service.config, "sched", None)
        self._queue = WeightedFairQueue(
            dict(sched_cfg.tenant_weights) if sched_cfg else {},
            sched_cfg.default_weight if sched_cfg else 1.0,
        )
        self._builds = 0             # host builds in flight on the pool
        self._stopping = False
        self._draining = False

    # ------------------------------------------------------------ intake
    def submit(
        self,
        request: RankRequest,
        on_done: Optional[Callable] = None,
    ) -> Future:
        """Enqueue one admitted request; returns its response future.
        The request's trace root (trace_id = request_id) is minted here
        — at admission — so queue time is inside the ``request`` span.
        A caller ``traceparent`` header overrides the trace id: the
        request's spans then JOIN the caller's distributed trace (the
        root span additionally parent-links to the caller's span id,
        serve.server.build_pending)."""
        from ..obs.spans import get_tracer

        fut: Future = Future()
        tp = getattr(request, "traceparent", None)
        ctx = get_tracer().new_trace(
            tp[0] if tp else request.request_id
        )
        entry = (request, fut, time.monotonic(), on_done, ctx)
        with self._cond:
            if self._stopping:
                fut.set_exception(ShutdownError("service shutting down"))
                return fut
            self._queue.push(request.tenant, entry)
            self._cond.notify()
        return fut

    def queued(self) -> int:
        with self._cond:
            return len(self._queue)

    # ------------------------------------------------------- fair dequeue
    def _pop_fair(self, timeout: float):
        """Weighted-fair pop across tenant FIFOs (stride scheduling,
        sched.WeightedFairQueue): each turn serves the backlogged
        tenant with the least accumulated virtual time, so one chatty
        tenant cannot starve the rest — and configured tenant weights
        buy proportionally more turns. Equal weights reproduce the old
        round-robin interleave exactly."""
        with self._cond:
            if not self._queue:
                self._cond.wait(timeout=max(0.0, timeout))
            return self._queue.pop()

    # --------------------------------------------------------------- run
    def run(self) -> None:
        from ..utils.guards import claim_device_owner

        # The scheduler thread is the card's owner on the serve path:
        # every staging, dispatch and fetch and the degrade fallback
        # happen here; the HTTP threads only enqueue
        # and the build pool only does host work. Co-deployed, the
        # unified DeviceScheduler owns the device instead — this thread
        # then only dequeues/builds and parks into the shared store.
        if self.sched is None:
            claim_device_owner("serve-scheduler")
        while True:
            deadline = self.batcher.next_deadline()
            timeout = (
                _IDLE_POLL_S
                if deadline is None
                else min(_IDLE_POLL_S, max(0.0, deadline - time.monotonic()))
            )
            entry = self._pop_fair(timeout)
            if entry is not None:
                self._process(entry)
            # In-flight (already built or still building) windows always
            # complete at shutdown — only queued-not-yet-built requests
            # are failed by a non-draining stop. One condition hold for
            # the whole read: _stopping is written by stop() on another
            # thread, and the force decision must see a consistent
            # (stopping, queued, builds) triple.
            with self._cond:
                force = (
                    self._stopping
                    and not self._queue
                    and self._builds == 0
                )
            # All ready batches dispatch through the router pipelined:
            # batch i+1's staging (host pack + H2D) overlaps batch i's
            # device execution (dispatch router double-buffering).
            # Co-deployed, take_ready is empty (windows parked in the
            # shared store) and a drain instead force-kicks the
            # unified scheduler to flush the serve lane.
            self.batcher.dispatch_ready(
                self.batcher.take_ready(force=force)
            )
            if self.sched is not None and force:
                self.sched.kick(force=True)
            with self._cond:
                if (
                    self._stopping
                    and not self._queue
                    and self._builds == 0
                    and self.batcher.pending() == 0
                ):
                    return

    def builds_inflight(self) -> int:
        with self._cond:
            return self._builds

    def _expire_if_past_deadline(self, entry) -> bool:
        """Per-request ``deadline_ms``: a queued request whose caller
        deadline elapsed before its window staged is expired HERE (504
        + journal event) — a burst cannot dispatch device work nobody
        is waiting for. Returns True when the entry was expired."""
        request, fut, enqueued, on_done, _ctx = entry
        dl = getattr(request, "deadline_ms", None)
        if not dl:
            return False
        waited_ms = (time.monotonic() - enqueued) * 1e3
        if waited_ms <= float(dl):
            return False
        from .protocol import DeadlineExceeded

        err = DeadlineExceeded(
            f"request {request.request_id} expired in queue: waited "
            f"{waited_ms:.0f} ms of a {float(dl):.0f} ms deadline"
        )
        if not fut.done():
            fut.set_exception(err)
        if on_done is not None:
            on_done(None, err)
        journal = getattr(self.service, "journal", None)
        if journal is not None:
            journal.emit(
                "request_deadline_expired",
                request_id=request.request_id,
                tenant=request.tenant,
                deadline_ms=float(dl),
                waited_ms=round(waited_ms, 3),
                stage="queue",
            )
        return True

    def _process(self, entry) -> None:
        from ..obs.spans import get_tracer

        if self._expire_if_past_deadline(entry):
            return
        request, fut, enqueued, on_done, ctx = entry
        tracer = get_tracer()
        if self.build_pool is None:
            with tracer.attach(ctx):
                pw = self.service.build_pending(
                    request, fut, enqueued, on_done
                )
            if pw is not None:
                self.batcher.submit(pw)
            return
        # Host half off-thread: the pool builds while THIS thread keeps
        # dispatching ready batches; the completion callback parks the
        # built window (batcher.submit is thread-safe) and nudges the
        # scheduler, which alone touches the device.
        with self._cond:
            self._builds += 1

        def _done(f):
            pw = None
            try:
                pw = f.result()
            except Exception as e:  # noqa: BLE001 - build_pending
                # resolves its own failures; this catches only wrapper
                # faults, which must still answer the request.
                if not fut.done():
                    fut.set_exception(e)
                    if on_done is not None:
                        on_done(None, e)
            if pw is not None:
                self.batcher.submit(pw)
            with self._cond:
                self._builds -= 1
                self._cond.notify()

        # attach: the pool captures the scheduler thread's ambient
        # context at submit, carrying the request trace onto the worker.
        with tracer.attach(ctx):
            self.build_pool.submit(
                self.service.build_pending,
                request, fut, enqueued, on_done,
                on_done=_done,
            )

    # -------------------------------------------------------------- stop
    def stop(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop the thread; ``drain`` answers everything admitted first."""
        with self._cond:
            self._stopping = True
            self._draining = drain
            if not drain:
                for request, fut, _, on_done, _ctx in (
                    self._queue.drain_items()
                ):
                    err = ShutdownError("service shutting down")
                    fut.set_exception(err)
                    if on_done is not None:
                        on_done(None, err)
            self._cond.notify_all()
        if self.is_alive():
            self.join(timeout=timeout)
