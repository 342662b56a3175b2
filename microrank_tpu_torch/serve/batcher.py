"""Micro-batching across concurrent requests, keyed by shape buckets
(counterpart of ``microrank_tpu/serve/batcher.py``).

Concurrent requests whose host graphs land in the same bucket (the
router's ``bucket_key``: kernel and every leaf's padded shape) stack
into ONE rank program on the card (K18, ``dispatch.DispatchRouter``), so
a busy service shares the staging and the launches across tenants. A
bucket dispatches when it holds ``max_batch_windows`` requests or when
its oldest has waited ``max_wait_ms``.

Degradation: a failed device dispatch is retried as a batch under
JAX's ``DISPATCH_POLICY`` (``chaos.retry``: two attempts, jittered
backoff, the ``serve_dispatch`` breaker; the ``serve_dispatch`` chaos
seam and the legacy ``inject_dispatch_failures`` knob fire before each
attempt); if the retry fails too (or the breaker is open), the flight
recorder dumps (``degraded``) and, off
the card with ``fallback`` on, every member is ranked on the
``numpy_ref`` oracle (the host, float64) and answered with ``degraded:
true`` and ``kernel: "numpy_ref"``, counted in
``microrank_serve_degraded_total`` and logged at ERROR. On the card, or
with ``fallback`` off, the batch fails (500, an ERROR line): a service
whose kernels cannot launch never answers from the host instead (JAX's
service degrades there too; ROADMAP.md, deliberate differences).

An ``explain: true`` request whose explained program fails is answered
500 (an ERROR line), not with its ranking and no bundle as in JAX.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..config import MicroRankConfig
from ..dispatch import bucket_key
from ..pipeline.results import WindowResult
from .protocol import DeadlineExceeded, RankRequest

log = logging.getLogger("microrank_tpu_torch.serve")



@dataclass
class PendingWindow:
    """One admitted request, built and parked for coalescing."""

    request: RankRequest
    result: WindowResult
    table: object                    # the window's SpanTable (numpy_ref fallback)
    normal_ids: List[int]            # trace codes into table.trace_names
    abnormal_ids: List[int]
    graph: object                    # host graph, host_subset for kernel
    op_names: List[str]
    kernel: str
    future: Future
    enqueued: float                  # monotonic, at admission
    built: float = 0.0               # monotonic, graph build done
    on_done: Optional[Callable] = None
    # The request's root span context and the epoch-us the request
    # entered build; finish() records the root ``request`` span. A
    # caller traceparent's span id lands in ``parent_span``.
    ctx: object = None
    t0_us: int = 0
    parent_span: Optional[str] = None
    # The build's column identity (explain.ExplainContext) when the
    # request asked for an explain bundle.
    explain_ctx: object = None
    _finished: bool = field(default=False, repr=False)

    def finish(self, error: Optional[BaseException] = None) -> None:
        if self._finished:
            return
        self._finished = True
        # The root span first: the response goes out the moment the
        # future resolves, and a caller reading the ring right after it
        # must find its request's span.
        if self.ctx is not None and self.t0_us:
            from ..obs.spans import get_tracer

            get_tracer().record_span(
                "request", ctx=self.ctx, start_us=self.t0_us,
                dur_us=int(time.time() * 1e6) - self.t0_us, service="serve",
                parent_id=self.parent_span, tenant=self.request.tenant,
                degraded=bool(self.result.degraded),
                error=type(error).__name__ if error else None,
            )
        if error is not None:
            self.future.set_exception(error)
        else:
            self.future.set_result(self.result)
        if self.on_done is not None:
            self.on_done(self, error)


def _conv_summary(residuals, n_iters) -> dict:
    """Host summary of one window's fetched convergence row."""
    res = np.asarray(residuals, dtype=np.float64)
    n = int(n_iters)
    joint = res.max(axis=0)[:n]
    return {
        "iterations": n,
        "final_residual": float(joint[-1]) if n else None,
        "residuals": [float(x) for x in joint],
    }


class MicroBatcher:
    """Owns the shape buckets and the device dispatch of full batches.

    Only the batching scheduler's thread calls in (the lock guards the
    bucket bookkeeping so that stats can be read from the HTTP thread);
    dispatch is synchronous on that thread, the card's owner. Co-deployed
    (``store``, a ``sched.ParkedWindowStore``), built windows park in
    the shared store's serve lane and the ``sched.DeviceScheduler``'s
    thread calls ``dispatch`` back."""

    def __init__(self, config: MicroRankConfig, journal=None, router=None, flight=None,
                 store=None):
        from ..dispatch import DispatchRouter

        self.config = config
        self.serve = config.serve
        self.journal = journal
        self.flight = flight
        self.router = router if router is not None else DispatchRouter(config)
        self.store = store
        self._lock = threading.Lock()
        # bucket key -> FIFO of PendingWindow (insertion order = age).
        self._buckets: Dict[Tuple, List[PendingWindow]] = {}
        self._inject_failures = int(self.serve.inject_dispatch_failures)
        self.dispatches = 0
        # Retry-After pricing: the admission controller's cost observer,
        # called with the measured per-window seconds of each dispatch.
        self.cost_observer: Optional[Callable[[float], None]] = None
        # The warmup manifest's directory (set by ServeService): each
        # distinct (kernel, occupancy, leaf shapes) dispatched is
        # recorded there once.
        self.cache_dir: Optional[str] = None
        self._recorded_shapes: set = set()

    # ------------------------------------------------------------ intake
    def submit(self, pw: PendingWindow) -> None:
        key = bucket_key(pw.graph, pw.kernel)
        if self.store is not None:
            self._park_shared(pw, key)
            return
        with self._lock:
            self._buckets.setdefault(key, []).append(pw)

    def _park_shared(self, pw: PendingWindow, key) -> None:
        """Co-deploy intake: park into the shared store's serve lane; a
        deadline that lapses while parked expires at dequeue (504)."""
        from ..sched import LANE_SERVE, ParkedEntry

        dl = getattr(pw.request, "deadline_ms", None)
        deadline = pw.enqueued + float(dl) / 1e3 if dl else None
        self.store.park(ParkedEntry(LANE_SERVE, pw.request.tenant, key, pw,
                                    runner=self.dispatch, expire=self._expire_parked,
                                    deadline=deadline))

    def _expire_one(self, pw: PendingWindow, waited_ms: float, deadline_ms: float) -> None:
        pw.result.skipped_reason = "deadline_expired"
        if self.journal is not None:
            self.journal.emit("request_deadline_expired", request_id=pw.request.request_id,
                              tenant=pw.request.tenant, deadline_ms=deadline_ms,
                              waited_ms=round(waited_ms, 3), stage="batch")
        pw.finish(error=DeadlineExceeded(
            f"request {pw.request.request_id} expired before dispatch: waited "
            f"{waited_ms:.0f} ms of a {deadline_ms:.0f} ms deadline"))

    def _expire_parked(self, pw: PendingWindow) -> None:
        self._expire_one(pw, (time.monotonic() - pw.enqueued) * 1e3,
                         float(getattr(pw.request, "deadline_ms", 0) or 0))

    def pending(self) -> int:
        if self.store is not None:
            from ..sched import LANE_SERVE

            return self.store.pending(LANE_SERVE)
        with self._lock:
            return sum(len(v) for v in self._buckets.values())

    def next_deadline(self) -> Optional[float]:
        """Monotonic time the oldest parked request must dispatch by
        (co-deployed, the DeviceScheduler keeps the time)."""
        if self.store is not None:
            return None
        wait_s = max(0.0, float(self.serve.max_wait_ms)) / 1e3
        with self._lock:
            oldest = min((b[0].built for b in self._buckets.values() if b), default=None)
        return None if oldest is None else oldest + wait_s

    def take_ready(self, force: bool = False) -> List[List[PendingWindow]]:
        """Pop every bucket that is full, past its max wait, or (``force``,
        the drain) non-empty."""
        if self.store is not None:
            return []  # the DeviceScheduler drains the shared store
        now = time.monotonic()
        wait_s = max(0.0, float(self.serve.max_wait_ms)) / 1e3
        cap = max(1, int(self.serve.max_batch_windows))
        out: List[List[PendingWindow]] = []
        with self._lock:
            for key in list(self._buckets):
                bucket = self._buckets[key]
                while len(bucket) >= cap:
                    out.append(bucket[:cap])
                    del bucket[:cap]
                if bucket and (force or now - bucket[0].built >= wait_s):
                    out.append(bucket[:])
                    bucket.clear()
                if not bucket:
                    del self._buckets[key]
        return out

    # ---------------------------------------------------------- dispatch
    def dispatch_ready(self, batches: List[List[PendingWindow]]) -> None:
        """Dispatch every ready batch, double-buffered: batch i+1's
        staging is issued behind batch i's program (``next_items``). A
        failed batch retries then degrades without touching the others."""
        for i, batch in enumerate(batches):
            nxt = batches[i + 1] if i + 1 < len(batches) else None
            self.dispatch(batch, next_items=nxt)

    def _expire_deadlined(self, items: List[PendingWindow]) -> List[PendingWindow]:
        """Drop members whose ``deadline_ms`` elapsed while parked (504)."""
        live: List[PendingWindow] = []
        now = time.monotonic()
        for pw in items:
            dl = getattr(pw.request, "deadline_ms", None)
            waited_ms = (now - pw.enqueued) * 1e3
            if not dl or waited_ms <= float(dl):
                live.append(pw)
            else:
                self._expire_one(pw, waited_ms, float(dl))
        return live

    def dispatch(self, items: List[PendingWindow],
                 next_items: Optional[List[PendingWindow]] = None) -> None:
        """Rank one coalesced batch; resolves every member's future. The
        device attempts run under ``DISPATCH_POLICY``; past them (or with
        the breaker open) the batch degrades (``_degrade``). (The startup
        warmup dispatches through the router itself, ``dispatch.warmup``,
        and raises instead.)"""
        from ..chaos import DISPATCH_POLICY, retry_call

        items = self._expire_deadlined(items)
        if not items:
            return
        t0 = time.monotonic()
        try:
            outs, route_info = retry_call(
                "serve_dispatch", lambda: self._device_dispatch(items, next_items),
                policy=DISPATCH_POLICY,
                on_retry=lambda attempt, e, delay: log.warning(
                    "batch dispatch failed (%d windows): %s; retrying", len(items), e))
        except Exception as final:  # noqa: BLE001 - degraded loudly
            self._degrade(items, final)
            return
        batch_ms = (time.monotonic() - t0) * 1e3
        self._assign(items, outs, batch_ms, route_info)
        from ..obs.metrics import record_serve_batch

        record_serve_batch(len(items))
        if self.cost_observer is not None:
            # Measured per-window cost -> the Retry-After EWMA.
            self.cost_observer(batch_ms / 1e3 / max(1, len(items)))
        self._record_shapes(items, route_info)
        self.dispatches += 1
        failed = self._explain_requests(items)
        self._journal_batch(items, batch_ms, degraded=0, route_info=route_info)
        for pw in items:
            pw.finish(error=failed.get(id(pw)))

    def _record_shapes(self, items, route_info) -> None:
        """This batch's (kernel, occupancy, leaf shapes) into the warmup
        manifest, once per distinct signature, so a restarted process
        replays the shapes it served."""
        sched_cfg = self.config.sched
        if (self.cache_dir is None or not sched_cfg.shape_warmup
                or not self.config.dispatch.warmup_manifest or not items
                or items[0].graph is None):
            return
        kernel = route_info.kernel if route_info else items[0].kernel
        leaves = bucket_key(items[0].graph, kernel)[1:]
        sig = (kernel, len(items), leaves)
        if sig in self._recorded_shapes:
            return
        self._recorded_shapes.add(sig)
        from ..dispatch import record_manifest_entry

        record_manifest_entry(
            self.cache_dir, "serve", kernel, [len(items)],
            shapes=[{"occupancy": len(items), "leaves": [list(s) for s in leaves]}],
            max_shapes=sched_cfg.max_shapes,
        )

    def _explain_requests(self, items: List[PendingWindow]) -> Dict[int, BaseException]:
        """Rank provenance for ``explain: true`` members: one explained
        program (K15 after the rank program) a request, after the batch
        resolved, on this thread. Returns {id(member): error} for the
        members whose explain failed: each is answered with its error
        (500), the others stand."""
        need = [pw for pw in items if getattr(pw.request, "explain", False)
                and pw.graph is not None]
        if not need:
            return {}
        from ..explain import build_bundle, get_explain_store
        from ..obs.metrics import record_explain
        from ..obs.spans import get_tracer
        from ..rank_backends.blob import stage_rank_window
        from ..rank_backends.torch_cuda import pack_rank_outputs, unpack_rank_outputs
        from ..utils.guards import assert_device_owner

        assert_device_owner("serve.explain")
        cfg = self.config
        ex = dataclasses.replace(cfg.explain, enabled=True)
        failed: Dict[int, BaseException] = {}
        for pw in need:
            try:
                with get_tracer().span("explain", service="serve", ctx=pw.ctx,
                                       kernel=pw.kernel):
                    outs, staged = stage_rank_window(
                        pw.graph, cfg.pagerank, cfg.spectrum, pw.kernel, self.router.device,
                        cfg.runtime.blob_staging, explain=ex)
                    outs = unpack_rank_outputs(pack_rank_outputs(outs, staged))
                bundle = build_bundle(
                    outs, pw.op_names, pw.explain_ctx, method=cfg.spectrum.method,
                    kernel=pw.kernel,
                    window={"start": pw.result.start, "end": pw.result.end,
                            "request_id": pw.request.request_id},
                    trigger="request")
                pw.result.explain = bundle.data
                record_explain("request")
                get_explain_store().publish(str(pw.result.start), bundle.data)
            except Exception as e:  # noqa: BLE001 - answered as this member's error
                log.error("explain dispatch failed for %s: %s", pw.request.request_id, e)
                failed[id(pw)] = RuntimeError(
                    f"explain failed for request {pw.request.request_id}: {e}")
        return failed

    def _device_dispatch(self, items: List[PendingWindow],
                         next_items: Optional[List[PendingWindow]] = None):
        # The ``serve_dispatch`` chaos seam, and the legacy knob recorded
        # through the same surface.
        from ..chaos import maybe_inject, record_injection

        maybe_inject("serve_dispatch")
        if self._inject_failures > 0:
            self._inject_failures -= 1
            record_injection("serve_dispatch", "fail")
            raise RuntimeError(
                "injected device dispatch failure (ServeConfig.inject_dispatch_failures)")
        from ..obs.spans import get_tracer

        next_batch = None
        if next_items:
            next_batch = ([pw.graph for pw in next_items], next_items[0].kernel)
        # The router's spans attribute to the batch head's request trace
        # (one program answers the whole batch).
        with get_tracer().attach(items[0].ctx):
            return self.router.rank_batch(
                [pw.graph for pw in items], items[0].kernel,
                conv_trace=bool(self.config.runtime.convergence_trace),
                next_batch=next_batch)

    def _assign(self, items, outs, batch_ms: float, route_info=None) -> None:
        from ..obs.metrics import record_convergence
        from ..pipeline.table_runner import assert_finite_scores

        ti, ts, nv = outs[:3]
        per_window_ms = batch_ms / max(1, len(items))
        kernel = route_info.kernel if route_info else items[0].kernel
        for b, pw in enumerate(items):
            n = int(nv[b])
            names = [pw.op_names[int(i)] for i in ti[b][:n]]
            scores = [float(s) for s in ts[b][:n]]
            if self.config.runtime.validate_numerics:
                assert_finite_scores(scores, "serve batch window")
            pw.result.ranking = list(zip(names, scores))
            pw.result.batch_windows = len(items)
            pw.result.timings["rank_ms"] = round(per_window_ms, 3)
            if route_info is not None:
                pw.result.kernel = kernel
                pw.result.route = route_info.route
            if len(outs) > 3:
                conv = _conv_summary(outs[3][b], outs[4][b])
                pw.result.apply_convergence(conv)
                record_convergence(
                    kernel, conv["iterations"],
                    conv["final_residual"] if conv["final_residual"] is not None
                    else float("nan"))

    # -------------------------------------------------------- degradation
    def fallback(self) -> bool:
        """Whether a failed batch degrades to numpy_ref: ``fallback``,
        and only off the card."""
        return bool(self.serve.fallback) and self.router.device.type != "cuda"

    def _degrade(self, items, error) -> None:
        """The device path is down for this batch: answer each member
        from the numpy_ref oracle (``fallback()``), or fail the batch.
        Either way the flight recorder dumps the span ring first."""
        from ..utils.guards import assert_device_owner

        assert_device_owner("serve.degrade")
        if self.flight is not None:
            self.flight.dump("degraded")
        if not self.fallback():
            log.error("batch dispatch failed (%s); failing %d requests on %s", error,
                      len(items), self.router.device)
            for pw in items:
                pw.finish(error=error)
            return
        log.error("batch dispatch failed (%s); degrading %d windows to numpy_ref on the host",
                  error, len(items))
        from ..obs.metrics import record_serve_batch
        from ..rank_backends import NumpyRefBackend

        backend = NumpyRefBackend(self.config)
        done = []  # futures resolve only after the batch's metrics and journal
        degraded = 0
        for pw in items:
            t0 = time.monotonic()
            try:
                names, scores = backend.rank_window(pw.table, pw.normal_ids, pw.abnormal_ids)
            except Exception as e:  # noqa: BLE001 - answered as this member's error
                done.append((pw, e))
                continue
            pw.result.ranking = list(zip(names, scores))
            pw.result.degraded = True
            pw.result.kernel = "numpy_ref"
            pw.result.batch_windows = 1
            pw.result.timings["rank_ms"] = round((time.monotonic() - t0) * 1e3, 3)
            pw.result.apply_convergence(backend.last_convergence)
            degraded += 1
            done.append((pw, None))
        record_serve_batch(len(items), degraded=degraded)
        self._journal_batch(items, 0.0, degraded=degraded)
        for pw, err in done:
            pw.finish(error=err)

    # ------------------------------------------------------------- misc
    def _journal_batch(self, items, batch_ms, degraded, route_info=None) -> None:
        if self.journal is None:
            return
        self.journal.emit(
            "serve_batch",
            occupancy=len(items),
            kernel=route_info.kernel if route_info else (items[0].kernel if items else None),
            route=route_info.route if route_info else None,
            overlap_ms=route_info.overlap_ms if route_info else 0.0,
            dispatch_ms=round(batch_ms, 3),
            degraded=degraded,
            warmup=False,  # JAX's field: warmup never reaches the batcher here
            requests=[pw.request.request_id for pw in items],
            tenants=sorted({pw.request.tenant for pw in items}),
        )
