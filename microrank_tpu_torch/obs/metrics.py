"""The metric set of the port's lanes and the recording helpers their
hot paths call (counterpart of ``microrank_tpu/obs/metrics.py``).

Each metric is declared once (name, help, labels, buckets), with the
JAX package's name, help text, label names and buckets, so a snapshot
of either package reads the same. This module holds the subset the
ported lanes record: the table lane's window loop, its staging, the
convergence trace, ingest admission and its dead-letter store, the
span tracer, the tuned policy, follow mode, the host sentinel, and the
stream lane's series (``microrank_stream_*``, its incidents, the
dispatch router's routes and the build pool), the flight recorder's
dumps, the explain bundles, serve's requests and batches, the device
scheduler's series, the warmup manifest's events (the compile-cache
counter's, whose hit and miss count kernel libraries here), the shape
warmup's, the chaos series (fault injections, retries, breakers,
checkpoints) and the trace warehouse's. The JAX package's other
metrics (fleet, the jit counters, the profiler, the sanitizers) come
with their lanes (ROADMAP.md, port queue items 11 and 12).

Naming: ``microrank_<noun>_<unit>`` with ``_total`` on counters, the
Prometheus convention.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .registry import Counter, Gauge, Histogram, get_registry

# Iteration-count buckets: the reference runs exactly 25; tol runs vary.
ITER_BUCKETS = (1, 2, 4, 8, 12, 16, 20, 25, 32, 50, 100, 200)
# Residuals decay geometrically from O(1); log-spaced down to f32 noise.
RESIDUAL_BUCKETS = tuple(10.0 ** -e for e in range(12, -1, -1))


def stage_seconds() -> Histogram:
    return get_registry().histogram(
        "microrank_stage_seconds",
        "Wall-clock of each pipeline stage (StageTimings feed)",
        labelnames=("stage",),
    )


def windows_total() -> Counter:
    return get_registry().counter(
        "microrank_windows_total",
        "Detection windows processed, by outcome",
        labelnames=("outcome",),  # ranked | clean | skipped
    )


def rank_iterations() -> Histogram:
    return get_registry().histogram(
        "microrank_rank_iterations",
        "Power-iteration steps per ranked window (device-side trace)",
        labelnames=("kernel",),
        buckets=ITER_BUCKETS,
    )


def rank_final_residual() -> Histogram:
    return get_registry().histogram(
        "microrank_rank_final_residual",
        "Final L-inf power-iteration residual per ranked window "
        "(max over both partitions)",
        labelnames=("kernel",),
        buckets=RESIDUAL_BUCKETS,
    )


def staged_bytes() -> Counter:
    return get_registry().counter(
        "microrank_staged_bytes_total",
        "Host->device bytes staged for rank programs",
        labelnames=("path",),  # blob | tree | sharded
    )


def staged_pad_bytes() -> Counter:
    return get_registry().counter(
        "microrank_staged_pad_bytes_total",
        "Padding-waste bytes inside staged graphs, audited per staged "
        "leaf against its exact live extents (pad_policy overhead: "
        "padded minus true bytes)",
        labelnames=("path",),
    )


def staging_transfers() -> Counter:
    return get_registry().counter(
        "microrank_staging_transfers_total",
        "Host->device staging transfers issued",
        labelnames=("path",),
    )


def pipeline_inflight() -> Gauge:
    return get_registry().gauge(
        "microrank_pipeline_inflight",
        "Rank dispatches currently in flight (windows, or groups on the "
        "chunked lane)",
        labelnames=("lane",),  # window | chunk
    )


def follow_polls() -> Counter:
    return get_registry().counter(
        "microrank_follow_polls_total", "Follow-mode file polls"
    )


def follow_parse_failures() -> Counter:
    return get_registry().counter(
        "microrank_follow_parse_failures_total",
        "Follow-mode ingest parse failures (torn tail lines retried)",
    )


def follow_rotations() -> Counter:
    return get_registry().counter(
        "microrank_follow_rotations_total",
        "Follow-mode file rotations/truncations detected "
        "(size < last seen size)",
    )


def kind_dedup_gauge() -> Gauge:
    return get_registry().gauge(
        "microrank_kind_dedup_ratio",
        "Trace-kind dedup factor of the most recent built window (true "
        "traces / distinct kind columns, both partitions; 1.0 on an "
        "uncollapsed build) — the measured signal behind the "
        "kernel='kind' auto-select threshold "
        "(RuntimeConfig.kind_dedup_threshold)",
    )


def policy_events() -> Counter:
    return get_registry().counter(
        "microrank_policy_events_total",
        "Tuned-policy resolutions (scenarios.policy): applied when a "
        "persisted policy.json supplied at least one field, override "
        "when explicit config won every tuned field, default when no "
        "policy file exists, rejected when a stale/mismatched policy "
        "was refused WHOLE (cold start on built-in defaults), disabled "
        "under tuned_policy=off; one sample per lane startup",
        labelnames=("lane", "outcome"),
    )


def ingest_rejected() -> Counter:
    return get_registry().counter(
        "microrank_ingest_rejected_total",
        "Span rows refused by admission (ingest/), by reason — every "
        "counted row also lands exactly once in the dead-letter store "
        "(quarantine.jsonl) with the same reason",
        labelnames=("reason",),  # ingest.quarantine.REASONS
    )


def ingest_admitted() -> Counter:
    return get_registry().counter(
        "microrank_ingest_admitted_total",
        "Span rows admitted past the ingest validation ladder "
        "(the clean subset detect/build actually sees)",
    )


def ingest_quarantine_dropped() -> Counter:
    return get_registry().counter(
        "microrank_ingest_quarantine_dropped_total",
        "Dead-letter records dropped because quarantine.jsonl reached "
        "its byte cap (IngestConfig.quarantine_max_bytes) — hostile "
        "data must not become a disk-filling attack",
    )


def spans_recorded() -> Counter:
    return get_registry().counter(
        "microrank_spans_recorded_total",
        "Pipeline self-tracing spans recorded into the bounded ring "
        "(obs.spans; the flight recorder dumps the ring on incident "
        "open / degraded dispatch / SIGTERM)",
    )


def host_load_gauge() -> Gauge:
    return get_registry().gauge(
        "microrank_host_norm_load",
        "1-minute load average / CPU count at the last sample",
    )


def host_steal_gauge() -> Gauge:
    return get_registry().gauge(
        "microrank_host_steal_ratio",
        "CPU steal fraction over the last sample interval",
    )


def stream_windows() -> Counter:
    return get_registry().counter(
        "microrank_stream_windows_total",
        "Streaming windows closed at the watermark, by outcome",
        # ranked | clean | empty | skipped | warmup
        labelnames=("outcome",),
    )


def stream_dispatches() -> Counter:
    return get_registry().counter(
        "microrank_stream_dispatches_total",
        "Anomaly-GATED device rank dispatches in streaming mode (the "
        "detector runs on every window; graph build + device rank only "
        "on abnormal ones — this staying below the window counter IS "
        "the gate working)",
    )


def stream_late_spans() -> Counter:
    return get_registry().counter(
        "microrank_stream_late_spans_total",
        "Spans dropped for arriving past the watermark (older than "
        "every window they belong to, beyond allowed lateness)",
    )


def stream_incidents() -> Counter:
    return get_registry().counter(
        "microrank_stream_incidents_total",
        "Incident lifecycle transitions",
        labelnames=("transition",),  # open | update | resolve | suppressed
    )


def stream_open_incidents() -> Gauge:
    return get_registry().gauge(
        "microrank_stream_open_incidents",
        "Incidents currently open in the streaming engine",
    )


def dispatch_routes() -> Counter:
    return get_registry().counter(
        "microrank_dispatch_route_total",
        "Device dispatches issued by the adaptive router, by route "
        "(vmapped = single-device batched program, sharded = mesh "
        "shard_map program)",
        labelnames=("route",),  # vmapped | sharded
    )


def dispatch_windows() -> Histogram:
    return get_registry().histogram(
        "microrank_dispatch_windows",
        "Windows per router dispatch, by route (stream burst coalescing "
        "and serve micro-batching both land here; mass at 1 under "
        "bursty load means buckets never match)",
        labelnames=("route",),
        buckets=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32),
    )


def dispatch_overlap_seconds() -> Counter:
    return get_registry().counter(
        "microrank_dispatch_overlap_seconds_total",
        "Staging seconds (host blob pack + H2D transfer) the router "
        "overlapped with an in-flight device dispatch — staging time "
        "taken OFF the critical path by double-buffering",
    )


def build_pool_inflight() -> Gauge:
    return get_registry().gauge(
        "microrank_build_pool_inflight",
        "Host graph builds currently running on build-pool workers "
        "(stream engine + serve scheduler share the pool seam)",
    )


def build_pool_builds() -> Counter:
    return get_registry().counter(
        "microrank_build_pool_builds_total",
        "Host graph builds completed on build-pool workers",
    )


def webhook_dropped() -> Counter:
    return get_registry().counter(
        "microrank_webhook_dropped_total",
        "Incident webhook events dropped after exhausting the sink's "
        "bounded retry queue (max attempts reached or queue overflow)",
    )


def flight_dumps() -> Counter:
    return get_registry().counter(
        "microrank_flight_dumps_total",
        "Flight-recorder dumps written to out_dir/flight/, by trigger "
        '(reason="suppressed" counts dumps the min-interval rate limit '
        "swallowed)",
        labelnames=("reason",),  # incident | suppressed
    )


def explain_bundles() -> Counter:
    return get_registry().counter(
        "microrank_explain_bundles_total",
        "Explain bundles materialized (rank provenance: per-suspect "
        "counter decomposition + contributing traces), by trigger",
        labelnames=("trigger",),  # incident
    )


def serve_requests() -> Counter:
    return get_registry().counter(
        "microrank_serve_requests_total",
        "RCA service requests, by outcome",
        # ranked | clean | skipped | rejected | failed
        labelnames=("outcome",),
    )


def serve_queue_depth() -> Gauge:
    return get_registry().gauge(
        "microrank_serve_queue_depth",
        "Requests admitted and not yet answered (admission-control "
        "depth; 429s start past ServeConfig.max_queue_depth)",
    )


def serve_batch_windows() -> Histogram:
    return get_registry().histogram(
        "microrank_serve_batch_windows",
        "Windows coalesced per device dispatch (micro-batch occupancy; "
        "a mass at 1 under concurrent load means buckets never match — "
        "check pad_policy and max_wait_ms)",
        buckets=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32),
    )


def serve_last_batch_gauge() -> Gauge:
    return get_registry().gauge(
        "microrank_serve_last_batch_windows",
        "Occupancy of the most recent non-warmup device dispatch",
    )


def serve_degraded() -> Counter:
    return get_registry().counter(
        "microrank_serve_degraded_total",
        "Requests answered by the numpy_ref fallback after a failed "
        "device dispatch (responses carry degraded=true)",
    )


def serve_stage_seconds() -> Histogram:
    return get_registry().histogram(
        "microrank_serve_stage_seconds",
        "Wall-clock of each request stage in the RCA service",
        labelnames=("stage",),  # queue | build | rank | total
    )


def compile_cache_events() -> Counter:
    return get_registry().counter(
        "microrank_compile_cache_events_total",
        "Persistent-compile-cache events: hit/miss per observed "
        "compile (cache dir entry count unchanged/grew), warm_start "
        "when a warmup manifest from a previous process was found and "
        "replayed, manifest_write per manifest update",
        labelnames=("event",),  # hit | miss | warm_start | manifest_write
    )


def sched_dispatches() -> Counter:
    return get_registry().counter(
        "microrank_sched_dispatch_windows_total",
        "Windows dispatched by the unified device scheduler, by "
        "priority lane and tenant — the fair-share observable: "
        "per-tenant rates under sustained contention converge to "
        "SchedConfig.tenant_weights",
        labelnames=("lane", "tenant"),
    )


def sched_parked() -> Gauge:
    return get_registry().gauge(
        "microrank_sched_parked_windows",
        "Entries currently parked in the shared window store, by lane "
        "(incident | serve | backfill)",
        labelnames=("lane",),
    )


def sched_expired() -> Counter:
    return get_registry().counter(
        "microrank_sched_expired_total",
        "Parked entries whose deadline lapsed before dequeue — the "
        "scheduler answered them (504) instead of burning device time "
        "on an abandoned request",
    )


def sched_throttled() -> Counter:
    return get_registry().counter(
        "microrank_sched_throttled_total",
        "Batches dispatched while their tenant's token bucket was "
        "empty (quotas are soft: the batch still ran because nothing "
        "in-quota was ready — work-conserving by design)",
        labelnames=("tenant",),
    )


def sched_wait_seconds() -> Histogram:
    return get_registry().histogram(
        "microrank_sched_wait_seconds",
        "Seconds a batch's oldest entry sat parked before dispatch, "
        "by lane — incident staying at the low buckets while backfill "
        "absorbs the queueing IS the priority policy working",
        labelnames=("lane",),
        buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                 1.0, 2.5, 5.0),
    )


def warm_shapes() -> Counter:
    return get_registry().counter(
        "microrank_warm_shapes_total",
        "Shape-faithful warmup replays of recorded production pad "
        "buckets at startup (warmed = program traced/reloaded, "
        "skipped = recorded signature no longer matches this build, "
        "failed = dispatch raised)",
        labelnames=("outcome",),  # warmed | skipped | failed
    )



def retry_attempts() -> Counter:
    return get_registry().counter(
        "microrank_retry_attempts_total",
        "Retry attempts (second and later tries) through the unified "
        "retry policy (chaos.retry), by seam — a healthy seam exposes "
        "this at zero",
        labelnames=("seam",),
    )


def retry_exhausted() -> Counter:
    return get_registry().counter(
        "microrank_retry_exhausted_total",
        "Retried calls that gave up after the policy's max attempts, "
        "by seam (the caller's containment/degradation path took over)",
        labelnames=("seam",),
    )


def breaker_state() -> Gauge:
    return get_registry().gauge(
        "microrank_breaker_state",
        "Circuit breaker state per retried seam: 0=closed, 1=open "
        "(fast-failing), 2=half-open (probing)",
        labelnames=("seam",),
    )


def fault_injections() -> Counter:
    return get_registry().counter(
        "microrank_fault_injections_total",
        "Faults injected by the chaos harness (chaos.faults: a seeded "
        "FaultPlan or a legacy inject_* knob), by seam and kind — "
        "nonzero only when chaos is armed",
        labelnames=("seam", "kind"),
    )


def checkpoint_events() -> Counter:
    return get_registry().counter(
        "microrank_checkpoint_events_total",
        "Engine state-checkpoint events: write per durable state.ckpt, "
        "restore on a successful --resume, rejected when a corrupt/"
        "incompatible checkpoint was refused (cold start), "
        "crash_injected when the chaos seam killed a write between tmp "
        "and rename (the previous checkpoint survives)",
        labelnames=("event",),  # write | restore | rejected | crash_injected
    )


def warehouse_segments() -> Counter:
    return get_registry().counter(
        "microrank_warehouse_segments_total",
        "Warehouse segments sealed, by tier (warm = one window per "
        "segment at flush, cold = compacted multi-window)",
        labelnames=("tier",),
    )


def warehouse_windows() -> Counter:
    return get_registry().counter(
        "microrank_warehouse_windows_total",
        "Window records sealed into warehouse segments, by tier "
        "(a window counts once per tier it transits)",
        labelnames=("tier",),
    )


def warehouse_spans() -> Counter:
    return get_registry().counter(
        "microrank_warehouse_spans_total",
        "Span rows sealed into WARM warehouse segments (the at-rest "
        "copy of every admitted span; compaction does not re-count)",
    )


def warehouse_bytes() -> Counter:
    return get_registry().counter(
        "microrank_warehouse_bytes_total",
        "Compressed segment bytes written, by tier — against "
        "ingest-side volume this is the at-rest compression observable",
        labelnames=("tier",),
    )


def warehouse_replays() -> Counter:
    return get_registry().counter(
        "microrank_warehouse_replays_total",
        "Time-travel replay verdicts per stored window: match = the "
        "re-ranked top-k tie-aware-agrees with the stored verdict",
        labelnames=("verdict",),  # match | mismatch
    )


def ensure_catalog() -> None:
    """Register this package's whole metric set in the current registry
    (no samples added), so a scrape or ``cli stats`` shows every metric
    the ported lanes can record, a counter at zero included."""
    for ctor in (
        stage_seconds, windows_total, rank_iterations,
        rank_final_residual, staged_bytes, staged_pad_bytes,
        staging_transfers, pipeline_inflight,
        follow_polls, follow_parse_failures, follow_rotations,
        kind_dedup_gauge, policy_events, spans_recorded,
        ingest_rejected, ingest_admitted, ingest_quarantine_dropped,
        host_load_gauge, host_steal_gauge,
        stream_windows, stream_dispatches, stream_late_spans,
        stream_incidents, stream_open_incidents,
        dispatch_routes, dispatch_windows, dispatch_overlap_seconds,
        build_pool_inflight, build_pool_builds, webhook_dropped,
        flight_dumps, explain_bundles,
        serve_requests, serve_queue_depth, serve_batch_windows,
        serve_last_batch_gauge, serve_degraded, serve_stage_seconds,
        compile_cache_events, sched_dispatches, sched_parked, sched_expired,
        sched_throttled, sched_wait_seconds, warm_shapes,
        retry_attempts, retry_exhausted, breaker_state, fault_injections,
        checkpoint_events, warehouse_segments, warehouse_windows,
        warehouse_spans, warehouse_bytes, warehouse_replays,
    ):
        ctor()


# ---------------------------------------------------------------------------
# Recording helpers


def record_window_outcome(outcome: str) -> None:
    windows_total().inc(outcome=outcome)


def record_convergence(
    kernel: str, n_iters: int, final_residual: float
) -> None:
    """Per-window convergence telemetry (host side, after the fetch)."""
    rank_iterations().observe(float(n_iters), kernel=kernel)
    if np.isfinite(final_residual):
        rank_final_residual().observe(float(final_residual), kernel=kernel)


def record_stream_window(outcome: str) -> None:
    stream_windows().inc(outcome=outcome)


def record_stream_dispatch() -> None:
    stream_dispatches().inc()


def record_incident(transition: str, open_now: int = None) -> None:
    stream_incidents().inc(transition=transition)
    if open_now is not None:
        stream_open_incidents().set(float(open_now))


def record_dispatch_route(route: str, windows: int, overlap_seconds: float = 0.0) -> None:
    """One router dispatch: route taken, windows it carried, staging
    seconds double-buffered behind it."""
    dispatch_routes().inc(route=route)
    dispatch_windows().observe(float(windows), route=route)
    if overlap_seconds > 0:
        dispatch_overlap_seconds().inc(float(overlap_seconds))


def record_build_pool(inflight: int = None, build_seconds: float = None) -> None:
    if inflight is not None:
        build_pool_inflight().set(float(inflight))
    if build_seconds is not None:
        build_pool_builds().inc()
        stage_seconds().observe(float(build_seconds), stage="build_pool")


def record_webhook_dropped(n: int = 1) -> None:
    webhook_dropped().inc(float(n))


def record_kind_dedup(ratio: float) -> None:
    """Per-window dedup-factor telemetry (host side, at graph build)."""
    kind_dedup_gauge().set(float(ratio))


def record_policy_event(outcome: str, lane: str) -> None:
    policy_events().inc(lane=lane, outcome=outcome)


def record_ingest_rejected(reason: str, n: int = 1) -> None:
    ingest_rejected().inc(float(n), reason=reason)


def record_ingest_admitted(n: int) -> None:
    if n > 0:
        ingest_admitted().inc(float(n))


def record_quarantine_dropped(n: int = 1) -> None:
    ingest_quarantine_dropped().inc(float(n))


def record_staging(
    path: str, n_bytes: int, n_transfers: int, pad_bytes: int = 0
) -> None:
    staged_bytes().inc(float(n_bytes), path=path)
    staging_transfers().inc(float(n_transfers), path=path)
    if pad_bytes > 0:
        staged_pad_bytes().inc(float(pad_bytes), path=path)


def graph_staging_audit(graph) -> Tuple[int, int]:
    """(total_bytes, pad_bytes) of a host WindowGraph, audited leaf by
    leaf against exact live extents: what the staging ships against
    what the window needed. Each vector leaf's true size is its clipped
    live extent, indptr leaves count their ``live + 1`` offsets, and the
    2-D bitmaps account both axes (padded op rows beyond ``n_ops`` and
    padded byte columns beyond ``ceil(live / 8)``). Leaves ``host_subset``
    stripped for the kernel have zero bytes and add nothing. (The JAX
    package's audit, on this package's fields.)"""
    scalars = {"n_ops", "n_traces", "n_inc", "n_ss", "n_cols"}
    total = 0
    pad = 0
    for part in (graph.normal, graph.abnormal):
        t_live = np.where(
            np.asarray(part.n_cols) >= 0, part.n_cols, part.n_traces
        )
        n_inc = np.atleast_1d(np.asarray(part.n_inc)).astype(np.int64)
        n_ss = np.atleast_1d(np.asarray(part.n_ss)).astype(np.int64)
        n_ops = np.atleast_1d(np.asarray(part.n_ops)).astype(np.int64)
        t_live = np.atleast_1d(np.asarray(t_live)).astype(np.int64)
        vec_live = {
            "inc_op": n_inc, "inc_trace": n_inc, "sr_val": n_inc,
            "rs_val": n_inc, "inc_trace_opmajor": n_inc,
            "sr_val_opmajor": n_inc,
            "ss_child": n_ss, "ss_parent": n_ss, "ss_val": n_ss,
            "inv_tracelen": t_live, "kind": t_live, "tracelen": t_live,
            "inv_cov_dup": n_ops, "inv_outdeg": n_ops,
            "cov_unique": n_ops, "op_present": n_ops,
            "inc_indptr_op": n_ops + 1,
            "inc_indptr_trace": t_live + 1,
            "ss_indptr": n_ops + 1,
        }
        bit_live = {
            "cov_bits": (n_ops, -(-t_live // 8)),
            "ss_bits": (n_ops, -(-n_ops // 8)),
        }
        pc_fields = {"pc_trace", "pc_sr_val", "pc_ell_op", "pc_ell_rs"}
        for f in part._fields:
            arr = np.asarray(getattr(part, f))
            total += arr.nbytes
            if f in scalars or arr.nbytes == 0:
                continue
            if f == "pc_blk_indptr":
                continue  # small dense offset table: all live
            if f in pc_fields:
                # Binned tables / ELL slabs: every live incidence entry
                # appears exactly once per view, so the live cell count
                # per window is n_inc; the rest is bin-skew padding.
                per_win = arr.shape[-2] * arr.shape[-1]
                b = arr.size // per_win
                if len(n_inc) in (1, b):
                    live_tot = int(
                        np.clip(
                            np.broadcast_to(n_inc, (b,)), 0, per_win
                        ).sum()
                    )
                    pad += arr.nbytes - live_tot * arr.itemsize
                continue
            if f in bit_live:
                rows_live, cols_live = bit_live[f]
                rows_pad, cols_pad = arr.shape[-2], arr.shape[-1]
                b = arr.size // (rows_pad * cols_pad)
                if len(rows_live) not in (1, b):
                    continue  # unrecognized stacking: skip, stay honest
                rl = np.broadcast_to(
                    np.clip(rows_live, 0, rows_pad), (b,)
                )
                cl = np.broadcast_to(
                    np.clip(cols_live, 0, cols_pad), (b,)
                )
                pad += arr.nbytes - int((rl * cl).sum()) * arr.itemsize
            else:
                live = vec_live.get(f)
                if live is None or arr.ndim == 0:
                    continue
                last = arr.shape[-1]
                rows = arr.size // last
                if len(live) not in (1, rows):
                    continue
                lv = np.broadcast_to(np.clip(live, 0, last), (rows,))
                pad += (rows * last - int(lv.sum())) * arr.itemsize
    return total, pad


def snapshot_to_result_fields(registry=None) -> Dict[str, float]:
    """Small flat dict of headline telemetry (the journal's ``run_end``
    ``telemetry``), with the JAX package's keys for the metrics this
    package records: ``staged_bytes``, the dispatch routes and their
    overlap. (The JAX package also reports its jit cache, whose counters
    are not ported.)"""
    reg = registry or get_registry()
    out: Dict[str, float] = {}
    staged = reg.get("microrank_staged_bytes_total")
    if staged is not None:
        out["staged_bytes"] = sum(s["value"] for s in staged.samples())
    routes = reg.get("microrank_dispatch_route_total")
    if routes is not None:
        for s in routes.samples():
            out[f"route_{s['labels'].get('route', '?')}"] = s["value"]
    overlap = reg.get("microrank_dispatch_overlap_seconds_total")
    if overlap is not None:
        total = sum(s["value"] for s in overlap.samples())
        if total:
            out["overlap_ms"] = round(total * 1e3, 1)
    return out


def record_flight_dump(reason: str) -> None:
    flight_dumps().inc(reason=reason)


def record_explain(trigger: str) -> None:
    explain_bundles().inc(trigger=trigger)


def record_serve_request(outcome: str, total_seconds: float = None) -> None:
    serve_requests().inc(outcome=outcome)
    if total_seconds is not None:
        serve_stage_seconds().observe(float(total_seconds), stage="total")


def record_serve_batch(occupancy: int, degraded: int = 0) -> None:
    serve_batch_windows().observe(float(occupancy))
    serve_last_batch_gauge().set(float(occupancy))
    if degraded:
        serve_degraded().inc(float(degraded))


def record_compile_cache(event: str, n: int = 1) -> None:
    if n > 0:
        compile_cache_events().inc(float(n), event=event)


def record_sched_dispatch(lane: str, tenant: str, windows: int) -> None:
    sched_dispatches().inc(float(windows), lane=lane, tenant=tenant)


def record_sched_parked(lane: str, depth: int) -> None:
    sched_parked().set(float(depth), lane=lane)


def record_sched_expired(n: int = 1) -> None:
    if n > 0:
        sched_expired().inc(float(n))


def record_sched_throttled(tenant: str) -> None:
    sched_throttled().inc(tenant=tenant)


def record_sched_wait(lane: str, seconds: float) -> None:
    sched_wait_seconds().observe(float(seconds), lane=lane)


def record_warm_shape(outcome: str) -> None:
    warm_shapes().inc(outcome=outcome)


def record_retry(seam: str) -> None:
    retry_attempts().inc(seam=seam)


def record_retry_exhausted(seam: str) -> None:
    retry_exhausted().inc(seam=seam)


def record_breaker_state(seam: str, state: float) -> None:
    breaker_state().set(float(state), seam=seam)


def record_fault_injection(seam: str, kind: str) -> None:
    fault_injections().inc(seam=seam, kind=kind)


def record_checkpoint(event: str) -> None:
    checkpoint_events().inc(event=event)


def record_warehouse_seal(tier: str, windows: int, spans: int, nbytes: int) -> None:
    warehouse_segments().inc(tier=tier)
    warehouse_windows().inc(float(windows), tier=tier)
    if tier == "warm":
        warehouse_spans().inc(float(spans))
    warehouse_bytes().inc(float(nbytes), tier=tier)


def record_warehouse_replay(verdict: str, n: int = 1) -> None:
    warehouse_replays().inc(float(n), verdict=verdict)
