"""The continuous RCA engine (``cli stream``; counterpart of
``microrank_tpu/stream/engine.py``).

An unbounded span source feeds the event-time windower
(``stream.window``); every closed window is admitted (``admit_table``
over its rows), detected by the C++ detector against the online SLO
baseline (``stream.baseline``), and only abnormal windows pay for the
C++ graph build and a rank program on the card: the dispatch counter
staying below the window counter is the gate working.

Overlap: abnormal windows' host builds run on the build pool
(``stream.pool``) while this thread, the only one issuing work to the
card, ranks the previous window; healthy windows drain the pipeline
first, so the incident lifecycle (``stream.incidents``) sees windows
strictly in order.

Dispatch goes through the router (``dispatch.DispatchRouter``):
abnormal windows queued behind the head that share its bucket coalesce
into one stacked program (a contiguous prefix of the queue), and the
next window's staging is issued behind the current program.
``RuntimeConfig.warm_start`` ranks each window through the warm
program (K19) from the previous ranked window's mapped state while an
incident is open; ``fused_pair`` does the same through the router's
fused program (one blob with the init, nine outputs in one copy);
``device_checks`` ranks one window at a time through the checked
program (K14).

Baseline poisoning guard: baselines update only on healthy windows and
freeze while an incident is open; the warm state is dropped when the
last incident resolves.

Co-deploy (``sched``, a ``sched.DeviceScheduler`` shared with serve):
every touch of the card (the warm restart, each dispatch and fetch,
the explained program) runs as a thunk on the scheduler's thread
(``_on_device``), on the incident lane while an incident is open (it
preempts serve) and on the serve lane otherwise; this thread keeps the
windowing, the builds and the incident lifecycle. Solo, the engine's
own thread owns the card.

Warm restart: each (kernel, occupancy, leaf shapes) the engine
dispatched lands in the warmup manifest (``dispatch.cache``) when the
run ends; a later engine over the same manifest dispatches those
occupancies and shapes once before its first window
(``dispatch.warmup``).

Incidents: with an ``out_dir`` the flight recorder (``obs.flight``)
dumps the span ring to ``out_dir/flight/<stamp>-incident/`` when a new
incident opens. With ``ExplainConfig.enabled`` the window that opened
it is ranked once more through the explained program (K15) on this
thread, and its bundle is written under ``out_dir/explain/<start>/``
and into that flight dump (linked from its ``manifest.json``),
published to the store ``/explainz`` serves, mirrored into the journal,
and its path rides the ``incident_open`` event (JAX's
``engine.py:1310-1369``, :1408-1418).

Crash-only (``chaos/``): the engine's host state (the baseline's
moments and P^2 markers, the incident tracker, the windower's watermark
and open buffers, the source cursor) checkpoints atomically to
``out_dir/state.ckpt`` at every drained window boundary and at the
drain; ``resume=True`` (``cli stream --resume``) restores it, so a
restarted run opens no incident twice and loses no window. A rejected
checkpoint is rejected whole: the engine cold-starts. No device tensor
rides the checkpoint: a resumed warm start starts its first window cold.

Faults (``--chaos PLAN.json``): the build runs under ``BUILD_POLICY``
on the pool (the ``build`` seam inside), every dispatch under
``STREAM_DISPATCH_POLICY`` (the ``dispatch`` seam before the program,
the ``fetch`` seam after it: a ``nan`` there fails the attempt). A
retry runs on the same device; a window whose attempts run out (or
whose breaker is open) is skipped, counted and logged at ERROR, never
ranked elsewhere.

Warehouse (``warehouse/``, ``WarehouseConfig.enabled`` with an
``out_dir``): every finalized window (its admitted table, its host graph
as a rank blob when ranked, its detection context) goes to the hot
tier before the baseline absorbs it; the checkpoint flushes it to warm
segments first, and skips its own write when the seal crashed, so a
resume re-seals the same windows under the same names.

Not ported here: the source-boundary pre-admission (the C++ loader
never yields a row without a parsed time), and the incremental delta
build (ROADMAP.md, port queue item 11).
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Deque, List, Optional

import numpy as np

from ..config import MicroRankConfig
from ..pipeline.results import ResultSink, WindowResult
from ..pipeline.table_runner import StageTimings, assert_finite_scores
from .baseline import OnlineBaseline
from .incidents import IncidentTracker, JsonlIncidentSink, WebhookIncidentSink
from .pool import BuildWorkerPool
from .window import ClosedWindow, StreamWindower

INCIDENT_LOG_NAME = "incidents.jsonl"
# The run's append-only result logs: a checkpoint records their sizes and
# a resume cuts them back to those, so the windows replayed after a kill
# are written once (the journal keeps both processes' records).
OUTPUT_LOGS = ("windows.jsonl", "result.csv", INCIDENT_LOG_NAME)
# A window whose admitted share of rows falls below this is refused
# whole (JAX's IngestConfig.min_admission_ratio default).
MIN_ADMISSION_RATIO = 0.5

log = logging.getLogger("microrank_tpu_torch.stream")


@dataclass
class _PendingRank:
    """One abnormal window: build submitted, rank pending."""

    closed: ClosedWindow
    result: WindowResult
    future: object              # -> (graph, op_names, kernel, ectx)
    trace: object = None        # _WindowTrace
    table: object = None        # the admitted window table


@dataclass
class _WindowTrace:
    """A window's root span context and its processing start."""

    ctx: object
    start_us: int
    perf0: float


@dataclass
class StreamSummary:
    windows: int = 0
    ranked: int = 0
    clean: int = 0
    empty: int = 0
    skipped: int = 0
    warmup: int = 0
    spans: int = 0
    dispatches: int = 0
    late_spans: int = 0
    incidents_opened: int = 0
    incidents_resolved: int = 0
    results: List[WindowResult] = field(default_factory=list)


class _JournalIncidentSink:
    """Mirror incident transitions into the run journal."""

    def __init__(self, journal):
        self.journal = journal

    def emit(self, event: dict) -> None:
        self.journal.emit(event["event"], **{k: v for k, v in event.items() if k != "event"})


class StreamEngine:
    """Drive one span source through windowing, gated RCA, incidents."""

    def __init__(self, config: MicroRankConfig, source, out_dir=None, normal_table=None,
                 incident_sinks: Optional[List] = None, device=None, sched=None,
                 resume: bool = False):
        from ..dispatch import DispatchRouter
        from ..scenarios.policy import apply_tuned_policy
        from ..utils.device import resolve_device

        sc = config.stream
        # Co-deploy: the DeviceScheduler that owns the card (None: this
        # engine's thread owns it).
        self.sched = sched
        self.source = source
        self.device = resolve_device(config.runtime.device if device is None else device)
        self.out_dir = Path(out_dir) if out_dir is not None else None
        if normal_table is None:
            normal_table = getattr(source, "normal", None)
        self._normal_table = normal_table   # the cold reset re-seeds from it
        # Tuned-policy resolution (scenarios.policy), profiled by the
        # seed table's counts as the table lane profiles its normal dump.
        counts = None
        if normal_table is not None:
            counts = (int(normal_table.n_spans), len(normal_table.svc_op_names), None)
        self.config, self.policy_resolution = apply_tuned_policy(config, lane="stream",
                                                                 counts=counts)
        config = self.config
        self.windower = self._make_windower()
        self.baseline = self._make_baseline()
        self.pool = BuildWorkerPool(sc.build_workers, name="mr-stream-build")
        self.journal = None
        self.sink = None
        if self.out_dir is not None:
            self.sink = ResultSink(self.out_dir, overwrite_csv=config.compat.overwrite_results)
            if config.runtime.telemetry:
                from ..obs import JOURNAL_NAME, RunJournal

                self.journal = RunJournal(self.out_dir / JOURNAL_NAME)
        sinks = list(incident_sinks or [])
        if self.out_dir is not None:
            sinks.append(JsonlIncidentSink(self.out_dir / INCIDENT_LOG_NAME))
            if self.journal is not None:
                sinks.append(_JournalIncidentSink(self.journal))
        if sc.webhook_url:
            sinks.append(WebhookIncidentSink(sc.webhook_url, timeout=sc.webhook_timeout_seconds,
                                             max_attempts=sc.webhook_retry_max,
                                             max_queue=sc.webhook_queue))
        self.tracker = IncidentTracker(
            top_k=sc.fingerprint_top_k, resolve_after=sc.resolve_after_windows,
            cooldown_windows=sc.cooldown_windows, jaccard=sc.fingerprint_jaccard,
            score_drift=sc.fingerprint_score_drift, sinks=sinks,
        )
        self.router = DispatchRouter(config, device=self.device)
        self._pending: Deque[_PendingRank] = deque()
        # kernel -> occupancies dispatched, and the (kernel, occupancy,
        # leaf shapes) signatures: the warmup manifest's entries, written
        # when the run ends.
        self._warmed: dict = {}
        self._shape_sigs: set = set()
        self._cache_dir = None
        self._cache_probe = None
        self._stop_requested = False
        # Warm-start seam: the previous ranked window's converged state
        # (rank_backends.warm.WarmState), threaded into the next
        # window's rank while an incident is open; dropped when none is.
        self._warm_state = None
        self.summary = StreamSummary()
        # Rank provenance: the latest incident bundle, held until the
        # flight dump it is written into.
        self._last_bundle = None
        if config.explain.enabled:
            from ..explain import get_explain_store

            get_explain_store().configure(config.explain.store_windows)
        # Flight recorder: the span ring, the journal's events and a
        # metrics snapshot dumped when an incident opens (rate-limited).
        self.flight = None
        if self.out_dir is not None:
            from ..obs.flight import FlightRecorder

            self.flight = FlightRecorder(self.out_dir, config.obs, journal=self.journal)
        # The trace warehouse: fed at finalize, flushed at the drained
        # boundary that writes the checkpoint, segment data first.
        self.warehouse = None
        if config.warehouse.enabled and self.out_dir is not None:
            from ..warehouse import TraceWarehouse

            self.warehouse = TraceWarehouse(self.out_dir, config.warehouse,
                                            truth=getattr(source, "fault_pod_ops", None),
                                            journal=self.journal)
        from ..chaos import CHECKPOINT_NAME

        self._ckpt_path = (self.out_dir / CHECKPOINT_NAME
                           if self.out_dir is not None and sc.checkpoint else None)
        # True while a coalesced group finalizes: its later windows left
        # the windower and the queue already, so the boundary is not
        # drained until the last one is finalized (JAX checkpoints there
        # and a resume loses the rest of the group).
        self._holding = False
        self.resumed = False
        if resume:
            self._restore_checkpoint()

    def _make_windower(self) -> StreamWindower:
        sc = self.config.stream
        return StreamWindower(
            width_us=int(sc.window_minutes * 60e6),
            slide_us=None if sc.slide_minutes is None else int(sc.slide_minutes * 60e6),
            lateness_us=int(sc.allowed_lateness_seconds * 1e6),
        )

    def _make_baseline(self) -> OnlineBaseline:
        sc = self.config.stream
        baseline = OnlineBaseline(decay=sc.baseline_decay,
                                  slo_stat=self.config.detector.slo_stat,
                                  min_windows=sc.min_healthy_windows)
        if self._normal_table is not None:
            baseline.seed(self._normal_table)
        return baseline

    # ------------------------------------------------------ durability
    def _restore_checkpoint(self) -> None:
        """``resume``: load and verify state.ckpt and overwrite the fresh
        components with the killed run's state. Any defect (a corrupt
        file, a version or checksum mismatch, another window geometry or
        SLO statistic, a cursor of another source) rejects the whole
        checkpoint: every component is rebuilt cold (``_cold_reset``)."""
        from ..chaos import CheckpointError, load_checkpoint
        from ..obs.metrics import record_checkpoint

        if self._ckpt_path is None or not self._ckpt_path.exists():
            if self._ckpt_path is not None:
                log.info("--resume: no checkpoint at %s; starting fresh", self._ckpt_path)
            return
        try:
            payload = load_checkpoint(self._ckpt_path)
            self.baseline.restore(payload["baseline"])
            self.tracker.restore(payload["tracker"])
            self.windower.restore(payload["windower"])
            src_state = payload.get("source")
            if src_state is not None and hasattr(self.source, "restore_state"):
                self.source.restore_state(src_state)
            for k, v in payload.get("summary", {}).items():
                if hasattr(self.summary, k) and k != "results":
                    setattr(self.summary, k, v)
            if self.warehouse is not None:
                self.warehouse.restore_cursor(payload.get("warehouse"))
            self._truncate_outputs(payload.get("outputs"))
        except (CheckpointError, KeyError, TypeError, ValueError) as e:
            record_checkpoint("rejected")
            self._cold_reset()
            log.warning("--resume: checkpoint rejected (%s); cold start", e)
            return
        self.resumed = True
        record_checkpoint("restore")
        log.info("resumed from %s: %d windows done, %d open incident(s), watermark at window "
                 "%d", self._ckpt_path, self.summary.windows,
                 len(self.tracker.open_incidents()), self.windower._next)

    def _output_sizes(self) -> dict:
        sizes = {}
        for name in OUTPUT_LOGS:
            path = self.out_dir / name
            sizes[name] = path.stat().st_size if path.exists() else 0
        return sizes

    def _truncate_outputs(self, sizes) -> None:
        """Cut the result logs back to their checkpointed sizes: the
        lines a killed run wrote past its last checkpoint belong to the
        windows this run replays (an external sink, stdout or a webhook,
        saw them once already: at least once there)."""
        if not sizes or self.out_dir is None:
            return
        for name, size in sizes.items():
            if name not in OUTPUT_LOGS:
                continue
            path = self.out_dir / name
            if not path.exists() or path.stat().st_size <= int(size):
                continue
            if int(size) == 0:
                path.unlink()   # not there at the checkpoint: its writer starts it anew
            else:
                with open(path, "r+b") as f:
                    f.truncate(int(size))
            log.info("--resume: %s cut back to its checkpointed %d bytes", name, int(size))

    def _cold_reset(self) -> None:
        """Discard every partly restored component: a fresh windower and
        (re-seeded) baseline, the lifecycle and the source cursor back to
        zero, the warehouse's hot tier empty."""
        self.windower = self._make_windower()
        self.baseline = self._make_baseline()
        self.tracker.reset()
        reset_cursor = getattr(self.source, "reset_cursor", None)
        if callable(reset_cursor):
            reset_cursor()
        if self.warehouse is not None:
            self.warehouse.reset_hot()
        self.summary = StreamSummary()

    def _checkpoint(self) -> None:
        """Write state.ckpt, only at a drained boundary (no pending
        ranks: every window the watermark sealed is finalized). The
        warehouse flushes first; if its seal crashed, the checkpoint is
        skipped too, so a resume replays those windows and re-seals them
        under the same names."""
        if self._pending or self._holding:
            return
        from ..chaos import InjectedFault, save_checkpoint
        from ..obs.metrics import record_checkpoint

        if self.warehouse is not None:
            try:
                self.warehouse.flush()
            except InjectedFault:
                record_checkpoint("crash_injected")
                log.warning("chaos: warehouse seal crashed between segment flush and "
                            "manifest; checkpoint skipped: the previous one stands and a "
                            "resume re-seals")
                return
            except OSError as e:
                log.warning("warehouse flush failed (%s); checkpoint skipped so the hot "
                            "windows stay replayable", e)
                return
        if self._ckpt_path is None:
            return
        t0 = time.perf_counter()
        ckpt_fn = getattr(self.source, "checkpoint_state", None)
        payload = {
            "baseline": self.baseline.to_state(),
            "tracker": self.tracker.to_state(),
            "windower": self.windower.to_state(),
            "source": ckpt_fn() if callable(ckpt_fn) else None,
            "summary": {k: getattr(self.summary, k) for k in (
                "windows", "ranked", "clean", "empty", "skipped", "warmup", "spans",
                "dispatches", "late_spans", "incidents_opened", "incidents_resolved")},
        }
        if self.warehouse is not None:
            payload["warehouse"] = self.warehouse.cursor_state()
        payload["outputs"] = self._output_sizes()
        try:
            save_checkpoint(self._ckpt_path, payload)
            record_checkpoint("write")
        except InjectedFault:
            # Killed between tmp and rename: the previous checkpoint stands.
            record_checkpoint("crash_injected")
            log.warning("chaos: checkpoint write crashed between tmp and rename; previous "
                        "checkpoint stands")
        except OSError as e:
            log.warning("checkpoint write failed: %s", e)
        from ..obs.metrics import stage_seconds

        stage_seconds().observe(time.perf_counter() - t0, stage="checkpoint")

    def queue_depth(self) -> int:
        return len(self._pending)

    def request_stop(self) -> None:
        """Drain and exit (serve's SIGTERM path when co-deployed): the
        run stops consuming the source at the next batch boundary (a
        tailing source ends at its next poll) and the pending windows
        rank."""
        self._stop_requested = True
        stop = getattr(self.source, "stop", None)
        if callable(stop):
            stop()

    def run(self) -> StreamSummary:
        from ..chaos import configure_chaos, set_chaos_journal
        from ..ingest import configure_quarantine
        from ..obs.metrics import ensure_catalog
        from ..obs.spans import configure_tracer
        from ..utils.guards import claim_device_owner

        ensure_catalog()
        configure_tracer(self.config.obs)  # a fresh span ring per run
        configure_chaos(self.config)       # the fault plan armed, or cleared
        set_chaos_journal(self.journal)    # fault_injected -> the journal
        configure_quarantine(self.config.ingest, default_dir=self.out_dir)
        if self.sched is None:
            claim_device_owner("stream-engine")
        self._warm_start()
        sc = self.config.stream
        run_t0 = time.monotonic()
        if self.journal is not None:
            self.journal.run_start(
                pipeline="stream", kernel=self.config.runtime.kernel,
                pad_policy=self.config.runtime.pad_policy, window_minutes=sc.window_minutes,
                slide_minutes=sc.slide_minutes, lateness_seconds=sc.allowed_lateness_seconds,
                seeded=self.baseline.seeded, resumed=self.resumed,
            )
            self.journal.emit("policy", **self.policy_resolution.journal())
        try:
            done = False
            for batch in self.source:
                if self._stop_requested:
                    done = True
                    break
                self.windower.push(batch)
                # Popped one at a time: a stop leaves the closed windows it
                # did not process in the windower (and the checkpoint).
                for w in iter(self.windower.pop_closed, None):
                    self._process(w)
                    if self._max_reached() or self._stop_requested:
                        done = True
                        break
                if done:
                    break
            if not done:
                for w in iter(self.windower.pop_flushed, None):
                    self._process(w)
                    if self._max_reached():
                        break
            self._drain_all()
        finally:
            self.pool.shutdown()
            self._record_manifest()
            self.summary.late_spans = self.windower.dropped_late
            # The drain's (or the clean end's) durable state: a resume
            # continues from here. Pending ranks left by an exception
            # make it a no-op: the last boundary's checkpoint stands.
            self._checkpoint()
            if self._stop_requested and self.journal is not None:
                self.journal.emit("sigterm_drain", resumable=True)
            self._flush_webhooks()
            if self.journal is not None:
                elapsed = max(1e-9, time.monotonic() - run_t0)
                self.journal.run_end(
                    windows=self.summary.windows, ranked=self.summary.ranked,
                    dispatches=self.summary.dispatches, spans=self.summary.spans,
                    spans_per_second=round(self.summary.spans / elapsed, 2),
                    late_spans=self.summary.late_spans,
                    incidents_opened=self.summary.incidents_opened,
                    incidents_resolved=self.summary.incidents_resolved,
                )
            set_chaos_journal(None)
            if self.out_dir is not None and self.config.runtime.telemetry:
                from ..obs.registry import get_registry

                get_registry().write_snapshot(self.out_dir)
        return self.summary

    def _on_device(self, fn, lane=None):
        """Run a thunk that touches the card where the card lives: inline
        when this engine owns it, else on the DeviceScheduler's thread,
        on the incident lane while an incident is open (ahead of serve),
        else on the serve lane."""
        if self.sched is None:
            return fn()
        from ..sched import LANE_INCIDENT, LANE_SERVE

        if lane is None:
            lane = LANE_INCIDENT if self.tracker.open_incidents() else LANE_SERVE
        return self.sched.run_on(lane, self.config.sched.stream_tenant, fn)

    def _warm_start(self) -> None:
        """The manifest's directory and probe; on a warm restart (a
        previous stream process left its manifest), dispatch the recorded
        occupancies and shapes once before the first window."""
        from ..dispatch import (
            CompileCacheProbe,
            configure_compile_cache,
            manifest_occupancies,
            warm_manifest_shapes,
            warm_occupancies,
        )

        if not self.config.dispatch.warmup_manifest:
            return
        self._cache_dir = configure_compile_cache(self.config.runtime)
        self._cache_probe = CompileCacheProbe(self._cache_dir)
        if self.config.runtime.device_checks:
            return
        occs = manifest_occupancies(self._cache_dir, "stream")
        if not occs:
            return
        from ..obs.metrics import record_compile_cache

        record_compile_cache("warm_start")
        t0 = time.monotonic()
        self._on_device(lambda: warm_occupancies(self.router, self.config, occs,
                                                 probe=self._cache_probe))
        shaped = 0
        if self.config.sched.shape_warmup:
            shaped = self._on_device(lambda: warm_manifest_shapes(
                self.router, self.config, self._cache_dir, "stream", probe=self._cache_probe))
        log.info("warm restart: %d manifest occupancies and %d recorded shapes dispatched in "
                 "%.2fs (kernel libraries %d loaded / %d built)", len(occs), shaped,
                 time.monotonic() - t0, self._cache_probe.hits, self._cache_probe.misses)

    def _record_manifest(self) -> None:
        from ..dispatch import record_manifest_entry

        if not self.config.dispatch.warmup_manifest:
            return
        shapes_by_kernel: dict = {}
        if self.config.sched.shape_warmup:
            for kernel, occ, leaves in sorted(self._shape_sigs):
                shapes_by_kernel.setdefault(kernel, []).append(
                    {"occupancy": occ, "leaves": [list(s) for s in leaves]})
        for kernel, occs in self._warmed.items():
            record_manifest_entry(self._cache_dir, "stream", kernel, sorted(occs),
                                  shapes=shapes_by_kernel.get(kernel),
                                  max_shapes=self.config.sched.max_shapes)

    def _flush_webhooks(self) -> None:
        for sink in self.tracker.sinks:
            flush = getattr(sink, "flush", None)
            if callable(flush):
                try:
                    flush()
                except Exception:  # noqa: BLE001 - the drain must complete
                    pass

    def _max_reached(self) -> bool:
        mw = self.config.stream.max_windows
        return bool(mw) and self.summary.windows >= mw

    # ---------------------------------------------------------- windows
    def _process(self, closed: ClosedWindow) -> None:
        from ..ingest import admit_table
        from ..obs.spans import get_tracer

        tracer = get_tracer()
        trace = _WindowTrace(ctx=tracer.new_trace(f"win-{closed.start}"),
                             start_us=int(time.time() * 1e6), perf0=time.monotonic())
        self.summary.windows += 1
        self.summary.spans += closed.n_spans
        result = WindowResult(start=closed.start, end=closed.end, anomaly=False)
        if closed.n_spans == 0:
            self._drain_all()
            result.skipped_reason = "empty_window"
            self._finalize(result, "empty", trace=trace)
            return
        table = closed.table
        if self.config.ingest.enabled:
            timings0 = StageTimings(ctx=trace.ctx)
            with timings0.stage("admit"):
                table, rejected = admit_table(table, self.config.ingest, source="stream")
            n_rejected = sum(rejected.values())
            result.ingest_rejected = n_rejected
            result.degraded_input = n_rejected > 0
            result.timings.update(timings0.as_dict())
            if n_rejected and self.journal is not None:
                self.journal.emit("ingest", stage="window", window_start=result.start,
                                  rejected=rejected)
            if table.n_spans / max(closed.n_spans, 1) < MIN_ADMISSION_RATIO:
                self._drain_all()
                log.warning("window %s: admission ratio %.2f below %.2f — refusing the window "
                            "whole", result.start, table.n_spans / closed.n_spans,
                            MIN_ADMISSION_RATIO)
                result.skipped_reason = "low_admission"
                self._finalize(result, "skipped", trace=trace)
                return
            if table.n_spans == 0:
                self._drain_all()
                result.skipped_reason = "empty_window"
                self._finalize(result, "empty", trace=trace)
                return
        if not self.baseline.ready:
            # Cold start: feed the baseline, don't detect yet.
            self._drain_all()
            self.baseline.update(table)
            result.n_traces = len(np.unique(table.trace_id))
            result.skipped_reason = "baseline_warmup"
            self._finalize(result, "warmup", table=table, trace=trace)
            return
        from ..graph.table_ops import detect_window_partition

        timings = StageTimings(ctx=trace.ctx)
        with timings.stage("detect"):
            vocab, slo = self.baseline.snapshot()
            mask, nrm, abn, _, rng = detect_window_partition(
                table, int(table.start_us.min()), int(table.end_us.max()), vocab, slo,
                self.config.detector, with_range=True)
        result.timings.update(timings.as_dict())
        flag = len(abn) >= self.config.detector.min_abnormal_traces
        result.anomaly = bool(flag)
        result.n_normal, result.n_abnormal = len(nrm), len(abn)
        result.n_traces = len(nrm) + len(abn)
        if not flag:
            self._drain_all()
            self._finalize(result, "clean", table=table, trace=trace)
            return
        if not len(nrm) or not len(abn):
            self._drain_all()
            result.skipped_reason = "degenerate_partition"
            self._finalize(result, "skipped", trace=trace)
            return
        # Gate open: the host build on the pool, the rank on this thread
        # once it lands (build N+1 overlaps rank N).
        with tracer.attach(trace.ctx):
            fut = self.pool.submit(self._prepare, table, mask, nrm, abn, rng)
        self._pending.append(_PendingRank(closed, result, fut, trace, table=table))
        while len(self._pending) >= max(1, self.config.stream.pipeline_windows):
            self._rank_head()

    # ---------------------------------------------------------- ranking
    def _warm(self) -> bool:
        rt = self.config.runtime
        return bool((rt.warm_start or rt.fused_pair) and not rt.device_checks)

    def _prepare(self, table, mask, nrm, abn, rng):
        """The build-pool unit under ``BUILD_POLICY``: a build failure
        (the ``build`` seam's too) retries on the worker before it can
        skip the window."""
        from ..chaos import BUILD_POLICY, retry_call

        return retry_call("build", lambda: self._prepare_impl(table, mask, nrm, abn, rng),
                          policy=BUILD_POLICY)

    def _prepare_impl(self, table, mask, nrm, abn, rng):
        """One build attempt: the C++ build of the window (with the
        column identity when a warm program maps its state or an
        incident's bundle names traces), the kernel resolved, the fields
        it never reads stripped (``graph.table_ops.prepare_window_graph``).
        Returns (host graph, op names, kernel, ExplainContext or None,
        (dedup ratio, build ms))."""
        from ..chaos import maybe_inject
        from ..graph.build import kind_dedup_ratio
        from ..graph.table_ops import prepare_window_graph
        from ..obs.spans import get_tracer

        maybe_inject("build")
        t0 = time.perf_counter()
        columns = self._warm() or self.config.explain.enabled
        with get_tracer().span("build", service="pipeline"):
            graph, op_names, kernel, ectx = prepare_window_graph(
                table, mask, nrm, abn, self.config, row_range=rng, explain=columns)
        build_ms = (time.perf_counter() - t0) * 1e3
        return graph, op_names, kernel, ectx, (kind_dedup_ratio(graph), build_ms)

    def _drain_all(self) -> None:
        while self._pending:
            self._rank_head()

    def _rank_head(self) -> None:
        head = self._pending.popleft()
        try:
            graph, op_names, kernel, ectx, built = head.future.result()
        except Exception as e:  # noqa: BLE001 - a bad window must not kill
            # the engine; the window records the failure and the stream
            # moves on.
            log.error("window %s: graph build failed: %s", head.result.start, e)
            head.result.skipped_reason = f"build_failed: {e}"
            self._finalize(head.result, "skipped", trace=head.trace)
            return
        rt = self.config.runtime
        warm = self._warm() and ectx is not None
        group = [(head, graph, op_names, ectx, built)]
        if not rt.device_checks and not warm:
            group.extend(self._coalesce_burst(graph, kernel))
        for p, _, _, _, (ratio, build_ms) in group:
            p.result.queue_depth = len(self._pending)
            p.result.kind_dedup = ratio
            p.result.timings["build"] = round(build_ms, 3)
        try:
            if warm:
                self._dispatch_rank_warm(head, graph, op_names, kernel, ectx)
            elif rt.device_checks and len(group) == 1:
                self._dispatch_rank(head.result, graph, op_names, kernel, trace=head.trace)
            else:
                self._dispatch_group(group, kernel)
        except Exception as e:  # noqa: BLE001 - the same containment rule
            # Exhausted retries or an open breaker: skipped, counted and
            # logged; never ranked on another path.
            with self._hold_checkpoint():
                for p, *_ in group:
                    log.error("window %s: rank failed: %s", p.result.start, e)
                    p.result.skipped_reason = f"rank_failed: {e}"
                    p.result.ranking = []
                    self._finalize(p.result, "skipped", trace=p.trace)
            return
        with self._hold_checkpoint():
            for p, g, names, ec, _ in group:
                self._finalize(p.result, "ranked", table=p.table, trace=p.trace,
                               explain_src=(g, names, p.result.kernel or kernel, ec))

    @contextlib.contextmanager
    def _hold_checkpoint(self):
        """No checkpoint until a group's every window is finalized; then
        one."""
        self._holding = True
        try:
            yield
        finally:
            self._holding = False
        self._checkpoint()

    def _coalesce_burst(self, head_graph, kernel: str):
        """Pending windows whose builds land in the head's bucket
        coalesce into its dispatch: a contiguous prefix of the queue, so
        the incident lifecycle still sees windows in order. Waiting on
        the next build costs nothing: that window ranks next anyway."""
        from ..dispatch import bucket_key

        extra = []
        cap = max(1, int(self.config.dispatch.coalesce_windows))
        key = bucket_key(head_graph, kernel)
        while self._pending and len(extra) + 1 < cap:
            nxt = self._pending[0]
            try:
                g2, n2, k2, e2, b2 = nxt.future.result()
            except Exception:  # noqa: BLE001 - surfaces on its own turn
                break
            if bucket_key(g2, k2) != key:
                break
            self._pending.popleft()
            extra.append((nxt, g2, n2, e2, b2))
        return extra

    def _ranking(self, result, op_names, idx, scores, n, context):
        names = [op_names[int(i)] for i in idx[:n]]
        vals = [float(s) for s in scores[:n]]
        if self.config.runtime.validate_numerics:
            assert_finite_scores(vals, context)
        result.ranking = list(zip(names, vals))

    def _convergence(self, result, kernel, residuals, n_it):
        from ..obs.metrics import record_convergence

        res = np.asarray(residuals, dtype=np.float64)
        n_it = int(n_it)
        final = float(res[:, n_it - 1].max()) if n_it else float("nan")
        record_convergence(kernel, n_it, final)
        result.apply_convergence({"iterations": n_it, "final_residual": final})

    def _count_dispatch(self) -> None:
        from ..obs.metrics import record_stream_dispatch

        record_stream_dispatch()
        self.summary.dispatches += 1

    def _dispatch_group(self, group, kernel: str) -> None:
        """One router dispatch for a coalesced same-bucket group; the
        next pending window's staging is issued behind it when its build
        has landed."""
        from ..chaos import STREAM_DISPATCH_POLICY, InjectedFault, maybe_inject, retry_call
        from ..obs.spans import get_tracer

        conv = bool(self.config.runtime.convergence_trace)
        graphs = [g for _, g, *_ in group]
        next_batch = None
        if self.config.dispatch.double_buffer and self._pending:
            nxt = self._pending[0]
            if nxt.future.done():
                try:
                    g2, _, k2, _, _ = nxt.future.result()
                    next_batch = ([g2], k2)
                except Exception:  # noqa: BLE001 - handled on its turn
                    pass
        head_trace = group[0][0].trace
        t0 = time.monotonic()
        first = len(group) not in self._warmed.get(kernel, ())

        def _attempt():
            # The ``dispatch`` seam before the program, the ``fetch`` seam
            # after it (a ``nan`` fails this attempt; the retry ranks the
            # batch again on the card).
            maybe_inject("dispatch")
            out = self.router.rank_batch(graphs, kernel, conv_trace=conv,
                                         next_batch=next_batch)
            if maybe_inject("fetch") is not None:
                raise InjectedFault("fetch", "nan")
            return out

        def _ranked():
            # The attach rides inside the thunk, so the dispatch spans land
            # on the head window's trace on whichever thread runs it.
            with get_tracer().attach(head_trace.ctx if head_trace is not None else None):
                out = retry_call("stream_dispatch", _attempt, policy=STREAM_DISPATCH_POLICY)
            if first and self._cache_probe is not None:
                # The first dispatch at this (kernel, occupancy): did it
                # build a kernel library or load one?
                self._cache_probe.observe()
            return out

        outs, info = self._on_device(_ranked)
        self._count_dispatch()
        if self.config.sched.shape_warmup and self.config.dispatch.warmup_manifest:
            from ..dispatch import bucket_key

            self._shape_sigs.add((info.kernel, len(group),
                                  bucket_key(graphs[0], info.kernel)[1:]))
        self._warmed.setdefault(info.kernel, set()).add(len(group))
        batch_ms = (time.monotonic() - t0) * 1e3
        for b, (p, _, op_names, _, _) in enumerate(group):
            self._ranking(p.result, op_names, outs[0][b], outs[1][b], int(outs[2][b]),
                          "stream window")
            p.result.kernel = info.kernel
            p.result.route = info.route
            p.result.batch_windows = len(group)
            p.result.timings["rank_ms"] = round(batch_ms / len(group), 3)
            if conv:
                self._convergence(p.result, info.kernel, outs[3][b], outs[4][b])

    def _dispatch_rank(self, result, graph, op_names, kernel, trace=None) -> None:
        """One window through the checked program (K14), which has no
        stacked twin."""
        from ..chaos import STREAM_DISPATCH_POLICY, InjectedFault, maybe_inject, retry_call
        from ..obs.spans import get_tracer
        from ..rank_backends.blob import stage_rank_window
        from ..rank_backends.torch_cuda import pack_rank_outputs, unpack_rank_outputs

        tracer = get_tracer()
        rt = self.config.runtime
        conv = bool(rt.convergence_trace)
        t0 = time.monotonic()

        def _attempt():
            maybe_inject("dispatch")
            with tracer.span("device_dispatch", service="stream", kernel=kernel, checked=True):
                outs, staged = stage_rank_window(
                    graph, self.config.pagerank, self.config.spectrum, kernel,
                    self.device, rt.blob_staging, checked=True, conv_trace=conv)
                packed = pack_rank_outputs(outs, staged, checked=True)
            with tracer.span("result_fetch", service="stream"):
                out = unpack_rank_outputs(packed)
            if maybe_inject("fetch") is not None:
                raise InjectedFault("fetch", "nan")
            return out

        def _ranked():
            with tracer.attach(trace.ctx if trace is not None else None):
                return retry_call("stream_dispatch", _attempt, policy=STREAM_DISPATCH_POLICY)

        out = self._on_device(_ranked)
        self._count_dispatch()
        self._ranking(result, op_names, out[0], out[1], int(out[2]), "stream window")
        result.kernel = kernel
        result.timings["rank_ms"] = round((time.monotonic() - t0) * 1e3, 3)
        if conv:
            self._convergence(result, kernel, out[3], out[4])

    def _dispatch_rank_warm(self, head, graph, op_names, kernel, ectx) -> None:
        """One window through the warm program (K19), started from the
        previous ranked window's mapped state while an incident is open;
        this window's state is kept for the next. ``fused_pair``: the
        router's fused program, its graph and init one blob; else, as
        JAX's warm dispatch, the graph copied leaf by leaf."""
        from ..chaos import STREAM_DISPATCH_POLICY, InjectedFault, maybe_inject, retry_call
        from ..obs.spans import get_tracer
        from ..rank_backends.blob import stage_rank_window_warm
        from ..rank_backends.torch_cuda import pack_rank_outputs, unpack_rank_outputs
        from ..rank_backends.warm import capture_warm_state, map_warm_state

        tracer = get_tracer()
        rt = self.config.runtime
        result = head.result
        init = None
        if self._warm_state is not None and self.tracker.open_incidents():
            init = map_warm_state(self._warm_state, op_names, ectx, graph)
        t0 = time.monotonic()
        fused = bool(rt.fused_pair)

        def _attempt():
            maybe_inject("dispatch")
            if fused:
                out = self.router.rank_fused(graph, kernel, init)[0]
            else:
                with tracer.span("device_dispatch", service="stream", kernel=kernel,
                                 warm=init is not None):
                    packed = pack_rank_outputs(*stage_rank_window_warm(
                        graph, init, self.config.pagerank, self.config.spectrum, kernel,
                        self.device, blob=False))
                with tracer.span("result_fetch", service="stream"):
                    out = unpack_rank_outputs(packed)
            if maybe_inject("fetch") is not None:
                raise InjectedFault("fetch", "nan")
            return out

        def _ranked():
            with tracer.attach(head.trace.ctx if head.trace is not None else None):
                return retry_call("stream_dispatch", _attempt, policy=STREAM_DISPATCH_POLICY)

        # Warm programs seed only while an incident is open: the hot lane.
        from ..sched import LANE_INCIDENT

        out = self._on_device(_ranked, lane=LANE_INCIDENT)
        self._count_dispatch()
        self._ranking(result, op_names, out[0], out[1], int(out[2]), "stream window (warm)")
        result.kernel = kernel
        if fused:
            result.route = "fused" if init is not None else "fused_cold"
        else:
            result.route = "warm" if init is not None else "warm_cold"
        result.batch_windows = 1
        result.timings["rank_ms"] = round((time.monotonic() - t0) * 1e3, 3)
        self._convergence(result, kernel, out[3], out[4])
        self._warm_state = capture_warm_state(op_names, ectx, out[5:9])

    def _explain_incident(self, result, explain_src) -> dict:
        """The incident-opening window's explain bundle, on this thread
        (the one issuing work to the card): one explained program over
        the window's host graph, the bundle written under
        out_dir/explain/, published to the /explainz store and mirrored
        into the journal. Returns the open event's extra fields."""
        from ..explain import build_bundle, get_explain_store
        from ..obs.metrics import record_explain
        from ..obs.spans import get_tracer
        from ..rank_backends.blob import stage_rank_window
        from ..rank_backends.torch_cuda import pack_rank_outputs, unpack_rank_outputs

        graph, op_names, kernel, ectx = explain_src
        ex = self.config.explain
        def _explained():
            with get_tracer().span("explain", service="stream", kernel=kernel):
                outs, staged = stage_rank_window(
                    graph, self.config.pagerank, self.config.spectrum, kernel, self.device,
                    self.config.runtime.blob_staging, explain=ex)
                return unpack_rank_outputs(pack_rank_outputs(outs, staged))

        # An explained program runs only when an incident opens: hot lane.
        from ..sched import LANE_INCIDENT

        outs = self._on_device(_explained, lane=LANE_INCIDENT)
        bundle = build_bundle(outs, op_names, ectx, method=self.config.spectrum.method,
                              kernel=kernel, window={"start": result.start, "end": result.end},
                              trigger="incident")
        record_explain("incident")
        get_explain_store().publish(str(result.start), bundle.data)
        path = None
        if self.out_dir is not None:
            stem = str(result.start).replace(" ", "T").replace(":", "")
            path = bundle.write(self.out_dir / "explain" / stem)
        if self.journal is not None and ex.journal:
            self.journal.emit("explain", bundle=str(path) if path else None,
                              **bundle.journal_record())
        # Held until the flight dump this incident triggers, so that the
        # bundle lands in the dump and its manifest links it.
        self._last_bundle = bundle
        return {"explain_bundle": str(path)} if path else {}

    def _link_bundle(self, dump_dir) -> None:
        """Name the explain bundle in the flight dump's manifest."""
        import json

        from ..explain.bundle import BUNDLE_JSON

        man = Path(dump_dir) / "manifest.json"
        try:
            data = json.loads(man.read_text())
            data["explain_bundle"] = BUNDLE_JSON
            man.write_text(json.dumps(data, indent=2))
        except (OSError, ValueError) as e:
            log.warning("could not link the explain bundle in %s: %s", man, e)

    # ---------------------------------------------------------- results
    def _finalize(self, result, outcome: str, table=None, trace=None,
                  explain_src=None) -> None:
        from ..obs.metrics import record_stream_window
        from ..obs.spans import get_tracer

        tracer = get_tracer()
        ctx = trace.ctx if trace is not None else None
        record_stream_window(outcome)
        setattr(self.summary, outcome, getattr(self.summary, outcome) + 1)
        opened_before = self.tracker.opened
        if outcome == "ranked":
            on_open = None
            ex = self.config.explain
            if explain_src is not None and ex.enabled and ex.on_incident:
                def on_open(inc):
                    return self._explain_incident(result, explain_src)
            with tracer.span("incident", service="stream", ctx=ctx):
                inc = self.tracker.observe_ranked(result.start, result.ranking, on_open=on_open)
            if inc is not None:
                self.summary.incidents_opened = self.tracker.opened
                log.info("window %s: anomaly -> %s (%d windows), top-1 %s", result.start,
                         inc.incident_id, inc.windows,
                         result.ranking[0][0] if result.ranking else "-")
            if self.tracker.opened > opened_before and self.flight is not None:
                # A new incident: dump how the pipeline got here while
                # the ring still holds it, with its bundle beside.
                dump_dir = self.flight.dump("incident")
                if dump_dir is not None and self._last_bundle is not None:
                    self._last_bundle.write(dump_dir)
                    self._link_bundle(dump_dir)
            self._last_bundle = None
        elif outcome != "warmup" and result.skipped_reason == "low_admission":
            # A window refused whole is evidence-free: it neither opens
            # nor resolves an incident.
            pass
        elif outcome != "warmup":
            with tracer.span("incident", service="stream", ctx=ctx):
                resolved = self.tracker.observe_healthy(result.start)
            self.summary.incidents_resolved = self.tracker.resolved
            for inc in resolved:
                log.info("window %s: %s resolved after %d windows", result.start,
                         inc.incident_id, inc.windows)
        # Baselines absorb healthy traffic only while no incident is open.
        if self.tracker.has_open:
            self.baseline.freeze()
        else:
            self.baseline.thaw()
            self._warm_state = None
        # The warehouse sees the window before the baseline absorbs it:
        # its snapshot is the context this window's verdict came from.
        if self.warehouse is not None:
            self._warehouse_observe(result, outcome, table, explain_src)
        if outcome == "clean" and table is not None:
            self.baseline.update(table)   # a no-op while frozen
        self.summary.results.append(result)
        if self.sink is not None:
            self.sink.emit(result)
        if self.journal is not None:
            self.journal.window(result)
        if trace is not None:
            tracer.record_span("window", ctx=trace.ctx, start_us=trace.start_us,
                               dur_us=int((time.monotonic() - trace.perf0) * 1e6),
                               service="stream", outcome=outcome)
        # The durable boundary: this window's effects are on disk; a no-op
        # while ranks are pending (the burst's drain writes it).
        self._checkpoint()

    def _warehouse_observe(self, result, outcome, table, explain_src) -> None:
        """One sealed window to the warehouse's hot tier; a storage defect
        never stops the stream."""
        try:
            graph = op_names = kernel = None
            if explain_src is not None:
                graph, op_names, kernel, _ = explain_src
            snapshot = self.baseline.snapshot() if self.baseline.ready else None
            self.warehouse.observe(result, outcome, table=table, graph=graph,
                                   op_names=op_names, kernel=kernel, snapshot=snapshot)
        except Exception as e:  # noqa: BLE001 - the containment rule
            log.warning("warehouse observe failed: %s", e)


def run_stream(config: MicroRankConfig, source, out_dir=None, normal_table=None,
               on_result=None, device=None, sched=None, resume: bool = False) -> StreamSummary:
    """Build and drive a StreamEngine to completion (the CLI's entry)."""
    engine = StreamEngine(config, source, out_dir=out_dir, normal_table=normal_table,
                          device=device, sched=sched, resume=resume)
    summary = engine.run()
    if on_result is not None:
        for r in summary.results:
            on_result(r)
    return summary
