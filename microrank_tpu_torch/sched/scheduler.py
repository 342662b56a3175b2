"""DeviceScheduler: the single thread that owns a co-deployed card
(counterpart of ``microrank_tpu/sched/scheduler.py``).

Solo deployments keep their own owner threads (serve's BatchScheduler,
the stream engine). When serve and stream share one card, each lane
parks work into the shared ``sched.store.ParkedWindowStore`` and THIS
thread, the only one to call ``claim_device_owner``, dequeues by the
store's lane / fair-share / quota policy and runs each batch's
``runner`` in dispatch order. A lane that needs a synchronous answer
(stream's gated dispatch) parks a thunk via :meth:`run_on` and blocks
on its future; the thunk runs here, on the owner thread.
"""

from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import Future
from typing import Optional

from ..utils.guards import claim_device_owner
from .store import LANE_NAMES, ParkedEntry, ParkedWindowStore

_IDLE_POLL_S = 0.2
_thunk_seq = itertools.count(1)


def _run_thunks(payloads) -> None:
    for fn, fut in payloads:
        if not fut.set_running_or_notify_cancel():
            continue
        try:
            fut.set_result(fn())
        except BaseException as exc:  # noqa: BLE001 - relayed to the
            # blocked caller via the future; the scheduler must survive.
            fut.set_exception(exc)


class DeviceScheduler(threading.Thread):
    """One consumer thread draining the shared parked-window store."""

    def __init__(self, store: ParkedWindowStore,
                 name: str = "mr-device-sched"):
        super().__init__(name=name, daemon=True)
        self.store = store
        self._stopping = False
        self._draining = True
        self._busy = False
        self.dispatched = 0     # batches run
        self.errors = 0         # runner exceptions contained

    # ------------------------------------------------------------- intake
    def submit_thunk(self, lane: int, tenant: str, fn,
                     cost: float = 1.0) -> Future:
        """Park ``fn`` for execution on the scheduler thread; returns
        its Future. Thunks carry a unique bucket key so each dequeues
        as its own singleton batch."""
        fut: Future = Future()
        self.store.park(ParkedEntry(
            lane, tenant, ("thunk", next(_thunk_seq)), (fn, fut),
            _run_thunks, cost=cost,
        ))
        return fut

    def run_on(self, lane: int, tenant: str, fn, cost: float = 1.0):
        """Run ``fn`` on the device-owner thread and return its result
        (raising what it raised). Called FROM the scheduler thread it
        runs inline — a runner may re-enter without deadlocking."""
        if threading.current_thread() is self:
            return fn()
        return self.submit_thunk(lane, tenant, fn, cost=cost).result()

    def kick(self, force: bool = False) -> None:
        """Wake the scheduler; ``force=True`` flushes partial serve
        buckets on the next pass (drain / test barriers)."""
        with self.store.cond:
            if force:
                self._force_once = True
            self.store.cond.notify_all()

    _force_once = False

    # -------------------------------------------------------------- drive
    def run(self) -> None:  # pragma: no branch - loop structure
        claim_device_owner("device-scheduler")
        store = self.store
        while True:
            now = time.monotonic()
            deadline = store.next_deadline()
            timeout = _IDLE_POLL_S if deadline is None else max(
                0.0, min(_IDLE_POLL_S, deadline - now)
            )
            with store.cond:
                if not store._buckets and not self._stopping:
                    store.cond.wait(timeout=timeout)
                stopping = self._stopping
                force = (stopping and self._draining) or self._force_once
                self._force_once = False
            for batch in store.take_ready(force=force):
                self._dispatch(batch)
            with store.cond:
                if stopping and not store._buckets:
                    break
        if not self._draining:
            for batch in store.take_ready(force=True):
                for e in batch:
                    if e.expire is not None:
                        try:
                            e.expire(e.payload)
                        except Exception:  # noqa: BLE001
                            pass

    def _dispatch(self, batch) -> None:
        with self.store.cond:
            self._busy = True
        try:
            batch[0].runner([e.payload for e in batch])
            self.dispatched += 1
            self._record(batch)
        except Exception:  # noqa: BLE001 - a lane's runner failing
            # (serve already degrades internally; a raw raise here
            # would silently kill every co-deployed lane's dispatch)
            self.errors += 1
        finally:
            with self.store.cond:
                self._busy = False
                self.store.cond.notify_all()

    # ---------------------------------------------------------- lifecycle
    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Block until the store is empty and no batch is running."""
        t_end = time.monotonic() + timeout
        with self.store.cond:
            while self.store._buckets or self._busy:
                left = t_end - time.monotonic()
                if left <= 0:
                    return False
                self.store.cond.wait(timeout=min(left, _IDLE_POLL_S))
        return True

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        with self.store.cond:
            self._stopping = True
            self._draining = drain
            self.store.cond.notify_all()
        if self.is_alive():
            self.join(timeout=timeout)

    # ------------------------------------------------------------ metrics
    def _record(self, batch) -> None:
        try:
            from ..obs.metrics import (
                record_sched_dispatch,
                record_sched_wait,
            )

            lane = LANE_NAMES.get(batch[0].lane, "serve")
            record_sched_dispatch(lane, batch[0].tenant, len(batch))
            record_sched_wait(
                lane, max(0.0, time.monotonic() - batch[0].parked)
            )
        except Exception:  # pragma: no cover - metrics best-effort
            pass
