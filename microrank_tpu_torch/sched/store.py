"""The parked-window store: one queue for every device workload
(counterpart of ``microrank_tpu/sched/store.py``).

Serve's bucket batcher and stream's gated dispatch (and, once its
slice is ported, warehouse backfill) park prepared work into ONE store
when they share a card, keyed by the dispatch router's ``bucket_key``
(kernel + padded leaf shapes: windows with equal keys stack into one
program), and a single dequeue policy decides what the card runs next:

* **priority lanes** — open-incident hot path (``LANE_INCIDENT``) >
  interactive serve (``LANE_SERVE``) > backfill (``LANE_BACKFILL``).
  ``take_ready`` returns every ready batch of a higher lane before any
  batch of a lower one, so an open incident's windows can never queue
  behind historical backfill (priority inversion is impossible by
  construction: ordering is by lane FIRST, and nothing a lower lane
  holds — no lock, no token state — is needed to dispatch a higher
  lane's batch).
* **weighted fair share** — stride scheduling over tenants: each
  dispatched window advances its tenant's virtual time by
  ``cost / weight``; the next batch goes to the backlogged tenant with
  the smallest virtual time, so long-run shares converge to the
  configured weights (SchedConfig.tenant_weights).
* **soft token-bucket quotas** — SchedConfig.tenant_rates refill
  per-tenant buckets in windows/second; an out-of-tokens tenant sorts
  behind every in-quota tenant but still dispatches when nothing else
  is ready. The scheduler is work-conserving: quotas shape ORDER under
  contention, they never idle the device or drop verdicts.
* **deadline expiry at dequeue** — entries carrying an absolute
  deadline (serve's per-request ``deadline_ms``) that lapsed while
  parked are expired here (their ``expire`` callback answers the 504)
  instead of burning device time on an abandoned answer.

Thread-safety: producers (HTTP threads via the serve scheduler, the
stream engine thread, backfill threads) park concurrently; one consumer
(the serve scheduler thread solo, or the DeviceScheduler thread when
co-deployed) drains. All state is guarded by one condition.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

LANE_INCIDENT = 0
LANE_SERVE = 1
LANE_BACKFILL = 2

LANE_NAMES = {
    LANE_INCIDENT: "incident",
    LANE_SERVE: "serve",
    LANE_BACKFILL: "backfill",
}

_seq = itertools.count(1)


class TokenBucket:
    """Windows/second refill up to ``burst``; time is passed in so the
    policy is deterministic under test. Not thread-safe — the store's
    condition guards every touch."""

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = max(0.0, float(rate))
        self.burst = max(0.0, float(burst))
        self.tokens = self.burst if self.rate > 0 else 0.0
        self._last = now

    def refill(self, now: float) -> None:
        if self.rate <= 0:
            return
        dt = max(0.0, now - self._last)
        self.tokens = min(self.burst, self.tokens + dt * self.rate)
        self._last = now

    def take(self, n: float) -> None:
        # May go negative: a batch dispatches whole even when the
        # tenant's remaining tokens cover only part of it — the debt
        # delays its NEXT batch, which is the soft-quota semantics.
        self.tokens -= n


class _Tenant:
    __slots__ = ("name", "weight", "bucket", "vt", "dispatched")

    def __init__(self, name, weight, bucket):
        self.name = name
        self.weight = max(1e-9, float(weight))
        self.bucket: Optional[TokenBucket] = bucket
        self.vt = 0.0           # stride-scheduling virtual time
        self.dispatched = 0     # windows dispatched (fair-share stats)


class ParkedEntry:
    """One parked unit of device work.

    Serve parks one PendingWindow per entry (``payload``), batched by
    bucket key at dequeue; stream and backfill park pre-formed dispatch
    thunks (``payload`` is the thunk, ``key`` unique) that dequeue as
    singleton batches. ``runner(payloads)`` executes the batch on the
    consuming (device-owner) thread; ``expire(payload)`` answers an
    entry whose deadline lapsed while parked.
    """

    __slots__ = (
        "lane", "tenant", "key", "payload", "runner", "expire",
        "parked", "deadline", "cost", "seq",
    )

    def __init__(
        self,
        lane: int,
        tenant: str,
        key: Tuple,
        payload,
        runner: Callable[[list], None],
        expire: Optional[Callable] = None,
        deadline: Optional[float] = None,
        cost: float = 1.0,
    ):
        self.lane = int(lane)
        self.tenant = str(tenant)
        self.key = key
        self.payload = payload
        self.runner = runner
        self.expire = expire
        self.parked = time.monotonic()
        self.deadline = deadline
        self.cost = float(cost)
        self.seq = next(_seq)


class ParkedWindowStore:
    """The one parked-window store; see the module docstring."""

    def __init__(self, config, serve_cfg=None):
        # ``config`` is the SchedConfig; ``serve_cfg`` (ServeConfig)
        # supplies the serve lane's batching knobs (max_batch_windows /
        # max_wait_ms) so the store flushes serve buckets exactly like
        # the old MicroBatcher did.
        self.cfg = config
        self.serve_cfg = serve_cfg
        self.cond = threading.Condition()
        # (lane, bucket key) -> FIFO of ParkedEntry (insertion = age).
        self._buckets: Dict[Tuple[int, Tuple], List[ParkedEntry]] = {}
        self._tenants: Dict[str, _Tenant] = {}
        self._weights = dict(config.tenant_weights)
        self._rates = dict(config.tenant_rates)
        self._global_vt = 0.0
        self.expired = 0

    # ------------------------------------------------------------ tenants
    def _tenant(self, name: str, now: float) -> _Tenant:
        t = self._tenants.get(name)
        if t is None:
            rate = self._rates.get(name)
            bucket = (
                None
                if rate is None
                else TokenBucket(rate, self.cfg.burst, now)
            )
            t = _Tenant(
                name, self._weights.get(name, self.cfg.default_weight),
                bucket,
            )
            # A newly active tenant joins at the current virtual time —
            # idling must not bank credit against busy tenants.
            t.vt = self._global_vt
            self._tenants[name] = t
        return t

    def tenant_shares(self) -> Dict[str, int]:
        """Windows dispatched per tenant (fair-share tests/metrics)."""
        with self.cond:
            return {
                name: t.dispatched for name, t in self._tenants.items()
            }

    # ------------------------------------------------------------- intake
    def park(self, entry: ParkedEntry) -> None:
        with self.cond:
            self._buckets.setdefault(
                (entry.lane, entry.key), []
            ).append(entry)
            self.cond.notify_all()
        self._record_depth()

    def pending(self, lane: Optional[int] = None) -> int:
        with self.cond:
            return sum(
                len(b)
                for (ln, _), b in self._buckets.items()
                if lane is None or ln == lane
            )

    def _lane_cap(self, lane: int) -> int:
        if lane == LANE_SERVE and self.serve_cfg is not None:
            return max(1, int(self.serve_cfg.max_batch_windows))
        return 1

    def _lane_wait_s(self, lane: int) -> float:
        if lane == LANE_SERVE and self.serve_cfg is not None:
            return max(0.0, float(self.serve_cfg.max_wait_ms)) / 1e3
        return 0.0  # thunk lanes are ready the moment they park

    def next_deadline(self) -> Optional[float]:
        """Monotonic time the oldest parked entry must flush by (the
        consumer's wait bound); None when the store is empty."""
        with self.cond:
            deadline = None
            for (lane, _), bucket in self._buckets.items():
                if not bucket:
                    continue
                d = bucket[0].parked + self._lane_wait_s(lane)
                deadline = d if deadline is None else min(deadline, d)
            return deadline

    def wait(self, timeout: float) -> None:
        with self.cond:
            if not self._buckets:
                self.cond.wait(timeout=max(0.0, timeout))

    # ------------------------------------------------------------ dequeue
    def take_ready(
        self,
        force: bool = False,
        lanes: Optional[Tuple[int, ...]] = None,
        now: Optional[float] = None,
    ) -> List[List[ParkedEntry]]:
        """Pop every ready batch, ordered for dispatch.

        Ready = a bucket holding a full batch (lane cap), an aged one
        (oldest entry past the lane's max wait), or anything at all
        under ``force`` (drain). Ordering: lane priority first; within
        a lane, in-quota tenants before out-of-quota ones, then
        smallest tenant virtual time, then oldest. Tokens are charged
        and virtual times advanced HERE — the returned order is the
        dispatch order.
        """
        now = time.monotonic() if now is None else now
        expired: List[ParkedEntry] = []
        out: List[List[ParkedEntry]] = []
        with self.cond:
            candidates: Dict[int, List[List[ParkedEntry]]] = {}
            for (lane, key) in list(self._buckets):
                bucket = self._buckets[(lane, key)]
                live = []
                for e in bucket:
                    if e.deadline is not None and now > e.deadline:
                        expired.append(e)
                    else:
                        live.append(e)
                bucket[:] = live
                if not bucket:
                    del self._buckets[(lane, key)]
                    continue
                if lanes is not None and lane not in lanes:
                    continue
                cap = self._lane_cap(lane)
                wait_s = self._lane_wait_s(lane)
                ready = candidates.setdefault(lane, [])
                while len(bucket) >= cap:
                    ready.append(bucket[:cap])
                    del bucket[:cap]
                if bucket and (
                    force or now - bucket[0].parked >= wait_s
                ):
                    ready.append(bucket[:])
                    bucket.clear()
                if not bucket:
                    del self._buckets[(lane, key)]
            for lane in sorted(candidates):
                out.extend(self._order_lane(candidates[lane], now))
            self.expired += len(expired)
        # Expiry callbacks resolve futures / emit journal events —
        # outside the lock so a callback touching the store (or a
        # waiter it wakes) cannot deadlock.
        for e in expired:
            if e.expire is not None:
                try:
                    e.expire(e.payload)
                except Exception:  # noqa: BLE001 - expiry is cleanup;
                    # one bad callback must not kill the dequeue.
                    pass
        if expired:
            self._record_expired(len(expired))
        self._record_depth()
        return out

    def _order_lane(
        self, batches: List[List[ParkedEntry]], now: float
    ) -> List[List[ParkedEntry]]:
        """Order one lane's ready batches by quota standing, then
        stride virtual time, then age — charging tokens and advancing
        virtual time as each batch is emitted (the emitted order IS
        the dispatch order, so later picks see earlier charges)."""
        for b in batches:
            t = self._tenant(b[0].tenant, now)
            if t.bucket is not None:
                t.bucket.refill(now)
        ordered: List[List[ParkedEntry]] = []
        remaining = list(batches)
        while remaining:
            def _rank(batch):
                t = self._tenants[batch[0].tenant]
                throttled = (
                    t.bucket is not None and t.bucket.tokens < 1.0
                )
                return (
                    1 if throttled else 0,
                    t.vt,
                    batch[0].parked,
                    batch[0].seq,
                )

            best = min(remaining, key=_rank)
            remaining.remove(best)
            throttled = _rank(best)[0] == 1
            for e in best:
                t = self._tenant(e.tenant, now)
                t.vt += e.cost / t.weight
                t.dispatched += 1
                if t.bucket is not None:
                    t.bucket.take(e.cost)
                self._global_vt = max(self._global_vt, t.vt)
            if throttled:
                self._record_throttled(best[0].tenant)
            ordered.append(best)
        return ordered

    # ------------------------------------------------------------ metrics
    def _record_depth(self) -> None:
        try:
            from ..obs.metrics import record_sched_parked

            with self.cond:
                depths = {name: 0 for name in LANE_NAMES.values()}
                for (lane, _), bucket in self._buckets.items():
                    depths[LANE_NAMES.get(lane, "serve")] += len(bucket)
            for name, depth in depths.items():
                record_sched_parked(name, depth)
        except Exception:  # pragma: no cover - metrics best-effort
            pass

    @staticmethod
    def _record_expired(n: int) -> None:
        try:
            from ..obs.metrics import record_sched_expired

            record_sched_expired(n)
        except Exception:  # pragma: no cover
            pass

    @staticmethod
    def _record_throttled(tenant: str) -> None:
        try:
            from ..obs.metrics import record_sched_throttled

            record_sched_throttled(tenant)
        except Exception:  # pragma: no cover
            pass


class WeightedFairQueue:
    """Tenant-keyed FIFOs popped by stride scheduling — the weighted
    upgrade of the serve scheduler's old round-robin ``_pop_fair``.
    With all-equal weights the pop order is exactly the old round-robin
    interleave (ties break by tenant arrival order); unequal weights
    give proportionally more turns to heavier tenants. NOT thread-safe:
    the owner holds its own condition around every call (the serve
    scheduler's ``_cond``), exactly like the OrderedDict it replaces.
    """

    def __init__(self, weights=None, default_weight: float = 1.0):
        self._weights = dict(weights or {})
        self._default = float(default_weight)
        self._queues: "Dict[str, List]" = {}
        self._vt: Dict[str, float] = {}
        self._arrival: Dict[str, int] = {}
        self._global_vt = 0.0
        self._n = 0

    def push(self, tenant: str, item) -> None:
        q = self._queues.get(tenant)
        if q is None:
            q = self._queues[tenant] = []
            self._arrival.setdefault(tenant, len(self._arrival))
            # Join at the current virtual time: returning tenants get
            # no banked credit for having been idle.
            self._vt[tenant] = max(
                self._vt.get(tenant, 0.0), self._global_vt
            )
        q.append(item)
        self._n += 1

    def pop(self):
        if not self._n:
            return None
        tenant = min(
            (t for t, q in self._queues.items() if q),
            key=lambda t: (self._vt[t], self._arrival[t]),
        )
        q = self._queues[tenant]
        item = q.pop(0)
        self._n -= 1
        w = max(1e-9, self._weights.get(tenant, self._default))
        self._vt[tenant] += 1.0 / w
        self._global_vt = max(self._global_vt, self._vt[tenant])
        if not q:
            del self._queues[tenant]
        return item

    def drain_items(self) -> List:
        """Remove and return every queued item (non-drain shutdown)."""
        items = [x for q in self._queues.values() for x in q]
        self._queues.clear()
        self._n = 0
        return items

    def __len__(self) -> int:
        return self._n

    def __bool__(self) -> bool:
        return self._n > 0
