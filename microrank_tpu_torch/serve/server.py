"""The online RCA service: the asyncio HTTP frontend and the service
facade (counterpart of ``microrank_tpu/serve/server.py``).

``cli serve`` wires it up: fit the SLO baseline from a normal-period
dump, stage named abnormal dumps, then answer ``POST /rank`` requests,
each one a detection window, with ranked suspects. Concurrent requests
coalesce into stacked rank programs on the card (``serve.batcher``),
admission control bounds the queue (``serve.admission``), and SIGTERM
drains every admitted request before the process exits.

A request's host half follows ``cli run``'s table lane: the window's
rows (a staged dump cut by ``graph.table_ops.window_span_range``, or the
inline records through ``protocol.spans_to_table``), ``admit_table``,
the C++ detector (``detect_window_partition``) and the C++ build
(``prepare_window_graph``, with the column identity when the request
asks for ``explain``).

Routes:

* ``POST /rank``        rank one window (``serve.protocol``);
* ``GET /healthz``      liveness, drain state, queue depth (JSON);
* ``GET /metrics``      Prometheus text exposition;
* ``GET /metrics.json`` the JSON snapshot.

The frontend is stdlib asyncio (a small HTTP/1.1 parser over
``asyncio.start_server``); handlers await the scheduler's response
futures through ``asyncio.wrap_future`` and never block on the card.
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..config import MicroRankConfig
from ..pipeline.results import WindowResult
from .admission import AdmissionController
from .protocol import (
    NAT_US,
    AdmissionError,
    DeadlineExceeded,
    ProtocolError,
    RankRequest,
    error_body,
    parse_datetime_us,
    parse_rank_request,
    response_body,
    spans_to_table,
    timestamp_str,
)
from .scheduler import BatchScheduler


class ServiceOverloaded(Exception):
    """Admission queue full: HTTP 429 with Retry-After."""

    status = 429


class ServiceDraining(Exception):
    """Shutdown in progress: HTTP 503 with Retry-After."""

    status = 503


def window_rows(table, start_us: int, end_us: int):
    """The rows of a time-sorted ``table`` inside [start_us, end_us]
    (start >= start_us and end <= end_us, JAX's ``window_spans``) as a
    table of their own: the candidate range by
    ``graph.table_ops.window_span_range``, ``parent_row`` renumbered to
    the kept rows (a parent outside them is none)."""
    from ..graph.table_ops import window_span_range

    lo, hi = window_span_range(table, start_us, end_us)
    keep = np.flatnonzero((table.start_us[lo:hi] >= start_us) & (table.end_us[lo:hi] <= end_us))
    pos = np.full(hi - lo, -1, dtype=np.int64)
    pos[keep] = np.arange(keep.size, dtype=np.int64)
    rows = keep + lo
    parent = table.parent_row[rows]
    inside = (parent >= lo) & (parent < hi)
    new_parent = np.where(inside, pos[np.clip(parent - lo, 0, max(hi - lo - 1, 0))], -1)
    return table._replace(
        trace_id=table.trace_id[rows], svc_op=table.svc_op[rows], pod_op=table.pod_op[rows],
        duration_us=table.duration_us[rows], start_us=table.start_us[rows],
        end_us=table.end_us[rows], parent_row=new_parent.astype(np.int64),
    )


class ServeService:
    """Service facade: baseline, datasets, admission, scheduler."""

    def __init__(self, config: MicroRankConfig, out_dir=None, sched=None):
        from ..dispatch import CompileCacheProbe, DispatchRouter, configure_compile_cache

        self.config = config
        self.serve = config.serve
        # Co-deploy: a sched.DeviceScheduler shared with the stream lane;
        # the batch scheduler then parks built windows in its store.
        self.sched = sched
        self.log = logging.getLogger("microrank_tpu_torch.serve")
        self.admission = AdmissionController(self.serve.max_queue_depth,
                                             self.serve.retry_after_seconds)
        self.journal = None
        self.out_dir = Path(out_dir) if out_dir is not None else None
        if self.out_dir is not None and config.runtime.telemetry:
            from ..obs import JOURNAL_NAME, RunJournal

            self.journal = RunJournal(self.out_dir / JOURNAL_NAME)
        self.build_pool = None
        if self.serve.build_workers > 0:
            from ..stream.pool import BuildWorkerPool

            self.build_pool = BuildWorkerPool(self.serve.build_workers, name="mr-serve-build")
        # The warmup manifest's directory and the kernel-library probe;
        # the router every batch ranks through.
        self.cache_dir = configure_compile_cache(config.runtime)
        self.cache_probe = CompileCacheProbe(self.cache_dir)
        self.router = DispatchRouter(config)
        # Flight recorder: a degraded dispatch and the SIGTERM drain dump
        # the span ring, the journal and the metrics to out_dir/flight/.
        self.flight = None
        if self.out_dir is not None:
            from ..obs.flight import FlightRecorder

            self.flight = FlightRecorder(self.out_dir, config.obs, journal=self.journal)
        self.scheduler = BatchScheduler(self, journal=self.journal, build_pool=self.build_pool,
                                        router=self.router, flight=self.flight, sched=sched)
        # Retry-After priced by the measured per-window dispatch cost.
        self.scheduler.batcher.cost_observer = self.admission.observe_window_cost
        # Each dispatched (kernel, occupancy, leaf shapes) lands in the
        # warmup manifest.
        self.scheduler.batcher.cache_dir = self.cache_dir
        self.datasets: Dict[str, object] = {}
        self.slo_vocab = None
        self.baseline = None
        self._thresh = None
        self.policy_resolution = None   # set by fit_baseline
        self.draining = False
        self._stopped = False
        self.warmup_seconds = None

    # ------------------------------------------------------------- setup
    def fit_baseline(self, normal_table) -> None:
        """The SLO baseline from a normal-period ``SpanTable`` (admitted
        first, as the table lane admits its normal dump), then the tuned
        policy on lane "serve", profiled by the table's counts."""
        from ..detect.detector import _thresholds
        from ..graph.table_ops import compute_slo_from_table
        from ..ingest import admit_table
        from ..scenarios.policy import apply_tuned_policy

        normal_table, _ = admit_table(normal_table, self.config.ingest, source="serve:normal")
        self.slo_vocab, self.baseline = compute_slo_from_table(
            normal_table, stat=self.config.detector.slo_stat)
        self.config, self.policy_resolution = apply_tuned_policy(
            self.config, lane="serve",
            counts=(int(normal_table.n_spans), len(self.slo_vocab), None))
        self.router.config = self.config
        self.scheduler.batcher.config = self.config
        self._thresh = _thresholds(self.baseline, self.config.detector)
        self.log.info("fitted SLO baseline: %d operations", len(self.slo_vocab))

    def add_dataset(self, name: str, table) -> None:
        """Stage an abnormal dump (a ``SpanTable``); requests address it
        by name."""
        from ..native import sort_table_by_time

        self.datasets[name] = sort_table_by_time(table)
        self.log.info("staged dataset %r: %d spans", name, table.n_spans)

    def start(self) -> None:
        from ..chaos import configure_chaos, set_chaos_journal
        from ..ingest import configure_quarantine
        from ..obs.metrics import ensure_catalog
        from ..obs.spans import configure_tracer
        from ..utils.guards import claim_device_owner

        if self.baseline is None:
            raise RuntimeError("call fit_baseline() before start()")
        ensure_catalog()
        configure_tracer(self.config.obs)  # a fresh span ring per service
        configure_chaos(self.config)       # the fault plan armed, or cleared
        set_chaos_journal(self.journal)    # fault_injected -> the journal
        # Dead-letter store beside the service's outputs.
        configure_quarantine(self.config.ingest, default_dir=self.out_dir)
        # Warmup runs on this thread before the scheduler exists (which
        # claims the card when it starts); co-deployed, the
        # DeviceScheduler owns the card and warmup runs there.
        if self.sched is None:
            claim_device_owner("serve-warmup")
        if self.serve.fallback and not self.scheduler.batcher.fallback():
            self.log.info("no numpy_ref fallback on %s: a batch whose dispatch fails twice "
                          "answers 500", self.router.device)
        if self.journal is not None:
            self.journal.run_start(
                pipeline="serve", kernel=self.config.runtime.kernel,
                pad_policy=self.config.runtime.pad_policy,
                max_batch_windows=self.serve.max_batch_windows,
                max_wait_ms=self.serve.max_wait_ms,
                max_queue_depth=self.serve.max_queue_depth,
            )
            if self.policy_resolution is not None:
                self.journal.emit("policy", **self.policy_resolution.journal())
        if self.serve.warmup:
            occs = self.serve.warmup_occupancies
            bad = [o for o in occs if int(o) < 1 or int(o) > self.serve.max_batch_windows]
            if not occs or bad:
                raise ValueError(
                    f"warmup_occupancies {tuple(occs)} invalid: every entry must be in "
                    f"[1, max_batch_windows={self.serve.max_batch_windows}]"
                )
            if self.sched is not None:
                from ..sched import LANE_SERVE

                self.sched.run_on(LANE_SERVE, "serve", self.warmup)
            else:
                self.warmup()
        self.scheduler.start()

    def warmup(self) -> None:
        """Dispatch the stacked program once a configured occupancy
        (``warmup_occupancies``) over a small synthetic window, and the
        occupancies and shapes a previous process recorded in the
        warmup manifest, before traffic. A failed dispatch raises: the
        service does not start (JAX's warmup degrades instead)."""
        from ..dispatch import (
            manifest_occupancies,
            record_manifest_entry,
            warm_manifest_shapes,
            warm_occupancies,
        )
        from ..obs.metrics import record_compile_cache

        t0 = time.monotonic()
        occupancies = sorted({int(o) for o in self.serve.warmup_occupancies})
        recorded = [o for o in manifest_occupancies(self.cache_dir, "serve")
                    if 1 <= o <= self.serve.max_batch_windows]
        if recorded:
            # Warm restart: replay a previous serve process's manifest.
            record_compile_cache("warm_start")
            occupancies = sorted(set(occupancies) | set(recorded))
        kernel = warm_occupancies(self.router, self.config, occupancies, probe=self.cache_probe)
        if kernel is None:
            return
        record_manifest_entry(self.cache_dir, "serve", kernel, occupancies)
        shaped = 0
        if self.config.sched.shape_warmup:
            shaped = warm_manifest_shapes(self.router, self.config, self.cache_dir, "serve",
                                          probe=self.cache_probe)
        self.warmup_seconds = time.monotonic() - t0
        self.log.info(
            "warmup: stacked rank program dispatched (occupancies %s, kernel %s, %d recorded "
            "shapes, kernel libraries %d loaded / %d built) in %.1fs",
            occupancies, kernel, shaped, self.cache_probe.hits, self.cache_probe.misses,
            self.warmup_seconds,
        )

    # ----------------------------------------------------------- request
    def submit(self, request: RankRequest):
        """Admission-checked entry: the response future, or
        ServiceOverloaded / ServiceDraining."""
        from ..obs.metrics import record_serve_request

        if self.draining:
            record_serve_request("rejected")
            raise ServiceDraining("service is draining")
        if not self.admission.try_admit():
            record_serve_request("rejected")
            raise ServiceOverloaded("request queue is full")
        return self.scheduler.submit(request, on_done=self._on_done)

    def _on_done(self, pw, error) -> None:
        """Completion hook of every admitted request, on every path:
        release the admission slot, record the outcome and latency,
        journal the window."""
        from ..obs.metrics import record_serve_request

        self.admission.release()
        if pw is None:  # expired in queue, or abandoned by a non-draining stop
            record_serve_request("expired" if isinstance(error, DeadlineExceeded) else "failed")
            return
        result = pw.result
        total_s = time.monotonic() - pw.enqueued
        if error is not None:
            if isinstance(error, ProtocolError):
                outcome = "invalid"
            elif isinstance(error, DeadlineExceeded):
                outcome = "expired"
            else:
                outcome = "failed"
        elif result.ranking:
            outcome = "ranked"
        elif result.skipped_reason:
            outcome = "skipped"
        else:
            outcome = "clean"
        record_serve_request(outcome, total_s)
        if self.journal is not None and error is None:
            self.journal.window(result)

    def build_pending(self, request, fut, enqueued, on_done):
        """The host half of one request (on the build pool): the window's
        rows, admission, detection, the C++ build. Returns a
        PendingWindow to coalesce, or None when the request resolved
        here (clean window, degenerate partition, bad payload)."""
        from ..graph.table_ops import detect_window_partition, prepare_window_graph
        from ..ingest import admit_table
        from ..obs.metrics import serve_stage_seconds
        from ..obs.spans import get_tracer
        from .batcher import PendingWindow

        tracer = get_tracer()
        queue_s = time.monotonic() - enqueued
        serve_stage_seconds().observe(queue_s, stage="queue")
        result = WindowResult(start="", end="", anomaly=False,
                              request_id=request.request_id, tenant=request.tenant)
        result.timings["queue_ms"] = round(queue_s * 1e3, 3)
        pw = PendingWindow(
            request=request, result=result, table=None, normal_ids=[], abnormal_ids=[],
            graph=None, op_names=[], kernel="", future=fut, enqueued=enqueued,
            on_done=on_done,
            # The root span: the request trace the scheduler attached,
            # backdated by the queue time; a caller traceparent links it.
            ctx=tracer.current_context(),
            t0_us=int((time.time() - queue_s) * 1e6),
            parent_span=(request.traceparent[1]
                         if getattr(request, "traceparent", None) else None),
        )
        t0 = time.monotonic()
        try:
            with tracer.span("parse", service="serve"):
                table = self._window_table(request)
            result.timings["parse_ms"] = round((time.monotonic() - t0) * 1e3, 3)
            if self.config.ingest.enabled:
                # Span admission over the request's rows: a payload with
                # no clean row answers 422 with the per-reason counts;
                # otherwise the clean subset ranks.
                t_adm = time.monotonic()
                n_input = table.n_spans
                with tracer.span("admit", service="serve"):
                    table, rejected = admit_table(
                        table, self.config.ingest, source=f"serve:{request.request_id}",
                        reject_unparsed=True)
                result.timings["admit_ms"] = round((time.monotonic() - t_adm) * 1e3, 3)
                result.ingest_rejected = n_input - table.n_spans
                result.degraded_input = table.n_spans < n_input
                if rejected and self.journal is not None:
                    self.journal.emit("ingest", stage="serve", request_id=request.request_id,
                                      tenant=request.tenant, rejected=rejected)
                if table.n_spans == 0:
                    raise AdmissionError(rejected)
            w0, w1 = int(table.start_us.min()), int(table.end_us.max())
            result.start, result.end = timestamp_str(w0), timestamp_str(w1)
            t_det = time.monotonic()
            with tracer.span("detect", service="serve"):
                mask, nrm, abn, _ = detect_window_partition(
                    table, w0, w1, self.slo_vocab, self.baseline, self.config.detector,
                    thresh=self._thresh)
            result.timings["detect_ms"] = round((time.monotonic() - t_det) * 1e3, 3)
            flag = len(abn) >= self.config.detector.min_abnormal_traces
            result.anomaly = bool(flag)
            result.n_normal, result.n_abnormal = len(nrm), len(abn)
            result.n_traces = len(nrm) + len(abn)
            if not flag:
                pw.finish()
                return None
            if not len(nrm) or not len(abn):
                result.skipped_reason = "degenerate_partition"
                pw.finish()
                return None
            with tracer.span("build", service="serve"):
                graph, names, kernel, pw.explain_ctx = prepare_window_graph(
                    table, mask, nrm, abn, self.config,
                    explain=bool(getattr(request, "explain", False)))
        except Exception as e:  # noqa: BLE001 - answered as the request's error
            pw.finish(error=e)
            return None
        build_s = time.monotonic() - t0
        serve_stage_seconds().observe(build_s, stage="build")
        # JAX's build_ms: the whole host half from parse on.
        result.timings["build_ms"] = round(build_s * 1e3, 3)
        result.kernel = kernel
        pw.table = table
        pw.normal_ids, pw.abnormal_ids = list(nrm), list(abn)
        pw.graph, pw.op_names, pw.kernel = graph, names, kernel
        pw.built = time.monotonic()
        return pw

    def _window_table(self, request: RankRequest):
        if request.spans is not None:
            return spans_to_table(request.spans)
        table = self.datasets.get(request.dataset)
        if table is None:
            raise ProtocolError(
                f"unknown dataset {request.dataset!r}; staged: {sorted(self.datasets)}")
        if request.start is None or request.end is None:
            # As JAX's window_spans, a missing bound takes the whole dump.
            out = table
        else:
            start, end = parse_datetime_us(request.start), parse_datetime_us(request.end)
            if NAT_US in (start, end):
                raise ProtocolError(
                    f"unparseable window bounds [{request.start}, {request.end}]")
            out = window_rows(table, start, end)
        if out.n_spans == 0:
            raise ProtocolError(
                f"dataset {request.dataset!r} has no spans in [{request.start}, {request.end}]")
        return out

    # ---------------------------------------------------------- shutdown
    def begin_drain(self) -> None:
        """Stop admitting; everything admitted is still answered."""
        self.draining = True
        self.admission.close()

    def shutdown(self, drain: bool = True, timeout=None) -> None:
        if self._stopped:
            return
        self._stopped = True
        self.begin_drain()
        if timeout is None:
            timeout = self.serve.drain_seconds
        if self.scheduler.is_alive() or self.scheduler.queued():
            self.scheduler.stop(drain=drain, timeout=timeout)
            if self.sched is not None and drain:
                # Parked serve windows run on the DeviceScheduler's
                # thread: wait for its store to empty.
                self.sched.kick(force=True)
                self.sched.wait_idle(timeout=timeout or 30.0)
        elif not self.scheduler.is_alive():
            # Never started (direct-drive tests): flush parked work.
            self.scheduler._stopping = True
            self.scheduler.batcher.dispatch_ready(
                self.scheduler.batcher.take_ready(force=True))
            if self.sched is not None:
                self.sched.kick(force=True)
                self.sched.wait_idle(timeout=timeout or 30.0)
        if self.build_pool is not None:
            self.build_pool.shutdown()
        if self.journal is not None:
            self.journal.run_end(dispatches=self.scheduler.batcher.dispatches)
        if self.flight is not None:
            # The drain's last flight dump: the ring, the fsync'd journal
            # and the final metrics.
            self.flight.dump("sigterm")
        if self.out_dir is not None and self.config.runtime.telemetry:
            from ..obs.metrics import ensure_catalog
            from ..obs.registry import get_registry

            ensure_catalog()
            get_registry().write_snapshot(self.out_dir)


# ---------------------------------------------------------------- HTTP


class HttpFrontend:
    """Minimal asyncio HTTP/1.1 frontend over the service."""

    def __init__(self, service: ServeService, host="127.0.0.1", port=0):
        self.service = service
        self.host = host
        self.port = int(port)
        self._server: Optional[asyncio.AbstractServer] = None
        self._active = 0
        self._idle = asyncio.Event()
        self._idle.set()

    async def start(self) -> int:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def drain_and_close(self, timeout: float) -> None:
        """Stop accepting, then wait (bounded) for in-flight handlers."""
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        try:
            await asyncio.wait_for(self._idle.wait(), timeout=timeout)
        except asyncio.TimeoutError:
            self.service.log.warning(
                "drain timeout: %d request(s) still in flight",
                self._active,
            )

    # ---------------------------------------------------------- handling
    async def _handle(self, reader, writer) -> None:
        self._active += 1
        self._idle.clear()
        try:
            req = await self._read_request(reader)
            if req is None:
                return
            method, path, body, headers = req
            out = await self._route(method, path, body, headers)
            status, ctype, payload = out[:3]
            extra = out[3] if len(out) > 3 else None
            await self._respond(writer, status, ctype, payload, extra)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, Exception):
                pass
            self._active -= 1
            if self._active == 0:
                self._idle.set()

    @staticmethod
    async def _read_request(reader):
        line = await reader.readline()
        if not line:
            return None
        try:
            method, path, _ = line.decode("latin-1").split(None, 2)
        except ValueError:
            return None
        headers = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            name, _, value = h.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()
        n = int(headers.get("content-length") or 0)
        body = await reader.readexactly(n) if n else b""
        return method.upper(), path.split("?")[0], body, headers

    async def _route(self, method, path, body, headers=None):
        svc = self.service
        if method == "POST" and path == "/rank":
            return await self._rank(body, headers or {})
        if method == "GET" and path == "/healthz":
            payload = json.dumps(
                {
                    "status": "draining" if svc.draining else "ok",
                    "queue_depth": svc.admission.depth,
                    "dispatches": svc.scheduler.batcher.dispatches,
                }
            ).encode()
            return 200, "application/json", payload
        if method == "GET" and path == "/metrics":
            from ..obs.registry import get_registry
            from ..obs.server import PROM_CONTENT_TYPE

            return 200, PROM_CONTENT_TYPE, get_registry().to_prometheus().encode()
        if method == "GET" and path == "/metrics.json":
            from ..obs.registry import get_registry

            return (
                200,
                "application/json",
                json.dumps(get_registry().to_json()).encode(),
            )
        return 404, "application/json", error_body("no such route")

    async def _rank(self, body, headers):
        svc = self.service
        retry = {"retry_after": svc.admission.retry_after()}
        try:
            # W3C trace context: the request's self-tracing spans join
            # the CALLER's distributed trace (serve.protocol).
            request = parse_rank_request(
                body, traceparent=headers.get("traceparent")
            )
        except ProtocolError as e:
            return 400, "application/json", error_body(str(e))
        try:
            fut = svc.submit(request)
        except (ServiceOverloaded, ServiceDraining) as e:
            return e.status, "application/json", error_body(str(e), **retry)
        try:
            result = await asyncio.wait_for(
                asyncio.wrap_future(fut),
                timeout=svc.serve.request_timeout_seconds,
            )
        except asyncio.TimeoutError:
            return (
                504,
                "application/json",
                error_body(
                    "request timed out in the service; its batch will "
                    "still complete and be journaled",
                    request_id=request.request_id,
                ),
            )
        except ProtocolError as e:
            # AdmissionError (status 422) carries the per-reason
            # rejection counts so the caller learns what was hostile.
            extra = {"request_id": request.request_id}
            rejected = getattr(e, "rejected", None)
            if rejected:
                extra["rejected"] = rejected
            return (
                getattr(e, "status", 400),
                "application/json",
                error_body(str(e), **extra),
            )
        except Exception as e:
            from .protocol import DeadlineExceeded

            if isinstance(e, DeadlineExceeded):
                # The service expired the request at its caller-supplied
                # deadline_ms before staging it — same status as the
                # frontend's own wait timeout, but no work was wasted.
                return (
                    504,
                    "application/json",
                    error_body(str(e), request_id=request.request_id),
                )
            return (
                500,
                "application/json",
                error_body(str(e), request_id=request.request_id),
            )
        # Server-Timing: the request's own stage durations land in the
        # caller's tracing next to the traceparent-joined spans.
        from .protocol import server_timing_header

        timing = server_timing_header(result.timings)
        extra = {"Server-Timing": timing} if timing else None
        return 200, "application/json", response_body(result), extra

    async def _respond(
        self, writer, status, ctype, payload, extra_headers=None
    ) -> None:
        reason = {
            200: "OK", 400: "Bad Request", 404: "Not Found",
            422: "Unprocessable Entity", 429: "Too Many Requests",
            500: "Internal Server Error", 503: "Service Unavailable",
            504: "Gateway Timeout",
        }.get(status, "OK")
        head = [
            f"HTTP/1.1 {status} {reason}",
            f"Content-Type: {ctype}",
            f"Content-Length: {len(payload)}",
            "Connection: close",
        ]
        if status in (429, 503):
            # Dynamic backpressure: queue depth x measured per-window
            # cost (admission EWMA), floored at the configured constant.
            retry = max(
                1, int(round(self.service.admission.retry_after()))
            )
            head.append(f"Retry-After: {retry}")
        for name, value in (extra_headers or {}).items():
            head.append(f"{name}: {value}")
        writer.write(
            ("\r\n".join(head) + "\r\n\r\n").encode() + payload
        )
        await writer.drain()


class ServeHandle:
    """Run the HTTP frontend on a background thread (tests, embedding).

    ``cli serve`` uses ``run_serve`` (foreground loop + signal
    handlers) instead; this wrapper exists so a test can start a fully
    wired service, speak real HTTP to it, and stop it deterministically.
    """

    def __init__(self, service: ServeService, host="127.0.0.1", port=0):
        self.service = service
        self.frontend = HttpFrontend(service, host, port)
        self.port: Optional[int] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._stop_evt: Optional[asyncio.Event] = None

    def start(self) -> int:
        started = threading.Event()

        async def _main():
            self._loop = asyncio.get_running_loop()
            self._stop_evt = asyncio.Event()
            self.port = await self.frontend.start()
            started.set()
            await self._stop_evt.wait()
            await self.frontend.drain_and_close(
                self.service.serve.drain_seconds
            )

        self._thread = threading.Thread(
            target=lambda: asyncio.run(_main()),
            name="mr-serve-http",
            daemon=True,
        )
        self._thread.start()
        if not started.wait(timeout=30):
            raise RuntimeError("HTTP frontend failed to start")
        return self.port

    def stop(self, drain: bool = True) -> None:
        self.service.begin_drain()
        if self._loop is not None and self._stop_evt is not None:
            self._loop.call_soon_threadsafe(self._stop_evt.set)
        if self._thread is not None:
            self._thread.join(timeout=self.service.serve.drain_seconds + 30)
        self.service.shutdown(drain=drain)


def run_serve(service: ServeService, host: str, port: int) -> int:
    """Foreground serve loop (``cli serve``): start the frontend, block
    until SIGTERM/SIGINT, then drain — in-flight batches complete, the
    metrics snapshot and journal land in the output directory."""
    import signal

    log = service.log

    async def _amain():
        frontend = HttpFrontend(service, host, port)
        bound = await frontend.start()
        loop = asyncio.get_running_loop()
        stop = asyncio.Event()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop.set)
        log.info(
            "serving RCA on http://%s:%d (POST /rank; /healthz, "
            "/metrics); max_batch=%d max_wait=%.0fms queue<=%d",
            host, bound, service.serve.max_batch_windows,
            service.serve.max_wait_ms, service.serve.max_queue_depth,
        )
        await stop.wait()
        log.info("signal received: draining in-flight requests")
        service.begin_drain()
        await frontend.drain_and_close(service.serve.drain_seconds)

    asyncio.run(_amain())
    service.shutdown(drain=True)
    log.info(
        "drained; %d batch dispatches served",
        service.scheduler.batcher.dispatches,
    )
    return 0
