"""Typed configuration for the PyTorch port (counterpart of
``microrank_tpu/config.py``).

The knobs of the ported lanes are carried over: the detector, PageRank
and spectrum settings, window arithmetic, the reference-compat flags,
the runtime fields that shape the graph build, the rank program and the
window loop's pipelining, the ingest admission budgets and dead-letter
store, the span tracer, the tuned-policy switch, the in-program device
checks, the dispatch router, the stream engine, explain, serve and the
device scheduler. Field names
and defaults match the JAX package so a reader can hold the two side by
side. Every kernel the JAX package's ``RuntimeConfig.kernel`` names is
ported; an unknown name raises ``ValueError``.

``MicroRankConfig.to_dict`` / ``from_dict`` are the JAX package's
(``dataclasses.asdict``; lists back to tuples), and ``from_dict`` loads
a JAX config dict: a field the port lacks (``JAX_ONLY_FIELDS``) is taken
at JAX's default and refused at any other value, naming the item that
brings it (ROADMAP.md, port queue).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

# The kernels, in the JAX CLI's order of ``--kernel`` choices: every
# kernel the JAX package runs.
KERNELS = (
    "auto", "kind", "packed", "packed_bf16", "packed_blocked",
    "pcsr", "csr", "coo", "dense", "dense_bf16", "pallas",
)
# kernel="kind" coverage-pair precisions, as in the JAX package.
KIND_PRECISIONS = ("f32", "bf16", "int8")
# Result fetch strategies of the window loop (RuntimeConfig.fetch_mode).
FETCH_MODES = ("stream", "bulk")
# Ranking backends (RuntimeConfig.backend): "numpy_ref" is the float64
# oracle (rank_backends.NumpyRefBackend) that serve degrades to; the
# offline lanes (cli run, cli eval) do not take it yet.
BACKENDS = ("torch", "numpy_ref")


@dataclass(frozen=True)
class DetectorConfig:
    """SLO-deviation anomaly detector (reference: anormaly_detector.py:44-84)."""

    k_sigma: float = 3.0
    slack_ms: float = 0.0
    # A window is flagged anomalous iff >= min_abnormal_traces traces
    # exceed their expected duration.
    min_abnormal_traces: int = 1
    # Central statistic of the SLO baseline: "mean" or a percentile
    # "pNN" ("p90", "p99.9").
    slo_stat: str = "mean"
    # Error-status traces classify abnormal regardless of latency. The
    # native lane reads no statusCode column, so this only mirrors the
    # JAX field for config parity.
    error_status_abnormal: bool = True


@dataclass(frozen=True)
class PageRankConfig:
    """Personalized PageRank scorer (reference: pagerank.py:116-130)."""

    iterations: int = 25
    damping: float = 0.85
    call_weight: float = 0.01
    # "reference": the code's anomalous preference vector
    # (pagerank.py:75-85); "paper": Eq (7).
    preference: str = "reference"
    phi: float = 0.5
    # Max-normalize both ranking vectors every iteration
    # (pagerank.py:126-127).
    max_normalize_each_iter: bool = True
    # Optional convergence tolerance on the joint L-inf change of the
    # ranking vectors, capped at ``iterations``; None runs exactly
    # ``iterations`` steps like the reference.
    tol: Optional[float] = None
    # kernel="kind" precision of the coverage matvec pair (the kernel
    # reads the kind pattern as a bitmap either way; the call-graph
    # row-sum stays f32): "f32" (default), "bf16" (operands rounded to
    # bf16, f32 accumulation) or "int8" (each step quantizes every
    # operand vector to int8 with scale max|x| / 127 and sums in int32,
    # as the JAX package's quantize_i8).
    kind_precision: str = "f32"
    # kernel="packed_blocked": the most bytes of unpacked f32 coverage
    # matrix the plain version (ops/pattern.py, the CPU path) holds at
    # once; it unpacks one band of whole column tiles at a time. On the
    # card it bounds nothing: the kernel reads the bitmap and never
    # unpacks it.
    packed_block_bytes: int = 128 << 20

    def __post_init__(self):
        if self.kind_precision not in KIND_PRECISIONS:
            raise ValueError(
                f"unknown kind_precision {self.kind_precision!r} "
                f"(expected one of {KIND_PRECISIONS})"
            )


@dataclass(frozen=True)
class SpectrumConfig:
    """Weighted spectrum ranker (reference: online_rca.py:33-152)."""

    method: str = "dstar2"
    top_max: int = 5
    # The reference emits ``top_max + 6`` rows (online_rca.py:148).
    extra_rows: int = 6
    eps: float = 1e-7
    # Exactly tied scores order by ascending vocab index (= ascending op
    # name over the name-sorted vocab). "insertion" is oracle-only in
    # the JAX package and is not offered here.
    tiebreak: str = "name"

    @property
    def n_rows(self) -> int:
        return self.top_max + self.extra_rows


@dataclass(frozen=True)
class WindowConfig:
    """Sliding-window orchestration (reference: online_rca.py:155-216)."""

    detect_minutes: float = 5.0
    skip_minutes: float = 4.0


@dataclass(frozen=True)
class CompatConfig:
    """Flags reproducing documented reference quirks."""

    partition_swap: bool = False
    overwrite_results: bool = False


@dataclass(frozen=True)
class RuntimeConfig:
    """Execution knobs of the native lane."""

    # Power-iteration kernel, as in the JAX package:
    #   "kind" — the coverage pattern over the collapsed kind columns,
    #       read as a bitmap (K2, csrc/pattern_pair.cu), plus the
    #       call-graph row-sum over the edge list (K1);
    #   "packed" / "packed_bf16" — the coverage bitmap (K4,
    #       csrc/pattern_pair.cu) plus the call-graph term over the edge
    #       list (K1); f32 or bf16 operands, f32 accumulation;
    #   "packed_blocked" — "packed" in f32 on windows whose unpacked
    #       matrices exceed dense_budget_bytes (the kernel never unpacks);
    #   "pcsr" — all six SpMVs of a step in one launch of the pcsr
    #       kernel (csrc/coo_spmv.cu pcsr_step): K1's work items over
    #       the op side and the call edges, the trace side read from the
    #       partition-centric views' ELL slab;
    #   "csr" — the six SpMVs of a step through K1 in one launch, its
    #       work list read straight from the build's CSR views (aux
    #       "csr"; auto falls back to it on a window built with them);
    #   "coo" — the six SpMVs through K1 over the COO arrays, as pallas
    #       (auto's last resort);
    #   "dense" / "dense_bf16" — the densified transition matrices (f32,
    #       or bf16 operands with f32 accumulation) times the vectors, all
    #       six products of a step in one launch of csrc/dense_mv.cu;
    #   "pallas" — every SpMV through K1 (the port of the JAX package's
    #       one Pallas kernel, ops/pallas_spmv.py); never chosen by auto;
    #   "auto" (default) — kind when the build kind-collapsed the window
    #       and the measured dedup factor cleared kind_dedup_threshold;
    #       else, when both partitions' bitmaps fit a quarter of
    #       dense_budget_bytes, packed_bf16 (packed without prefer_bf16)
    #       if their unpacked matrices fit the budget and packed_blocked
    #       if not; else pcsr; on a window built with none of those views,
    #       csr with the CSR views, else coo.
    kernel: str = "auto"
    # Pad dynamic extents to buckets (graph.structures.pad_to).
    pad_policy: str = "pow2q"
    min_pad: int = 8
    # Kind-collapse the trace axis in the C++ build: "auto" | "on" | "off".
    collapse_kinds: str = "auto"
    # kernel="auto": window dedup factor (true traces / kind columns,
    # both partitions) at which a collapsed build constructs the kind
    # views, so that auto picks kernel="kind".
    kind_dedup_threshold: float = 4.0
    # Budget of the packed kernels' unpacked f32 matrices, summed over
    # both partitions (graph.build.resolve_aux applies it at build time,
    # choose_kernel at kernel choice).
    dense_budget_bytes: int = 2 << 30
    # kernel="auto" resolves the in-budget bitmap path to "packed_bf16"
    # instead of f32 "packed".
    prefer_bf16: bool = True
    # Carry the per-partition residual trace and n_iters out of the
    # rank program (always computed; this gates the WindowResult fields).
    convergence_trace: bool = True
    # Raise on non-finite fetched scores.
    validate_numerics: bool = True
    # Also check inside the rank program (K14, the JAX package's checkify
    # checks): the epilogue kernel sets a check word (non-finite live
    # scores, n_valid outside [0, k], non-finite live residuals) that
    # rides the window's one result copy; the fetch raises
    # DeviceCheckError on it. Forces synchronous dispatch; stacked groups
    # rank unchecked, with a warning, as in the JAX package.
    device_checks: bool = False
    # "cuda" (default) or "cpu". Entry points also take ``device=``,
    # which wins over this field.
    device: str = "cuda"
    # The ranking backend: "torch" (this package's device program) or
    # "numpy_ref", the numpy oracle (rank_backends.NumpyRefBackend,
    # serve's degradation path). Its wiring into cli run and the
    # accuracy harness is ROADMAP.md's port queue item 9: there it
    # raises NotImplementedError.
    backend: str = "torch"
    # Window-loop pipelining (TableRCA.run): rank programs allowed in
    # flight before the host blocks on the oldest. 2 overlaps window N's
    # device work with window N+1's detection and graph build; 1 is fully
    # synchronous per window.
    pipeline_depth: int = 2
    # Stage (H2D, layouts, rank-program issue, the start of the result
    # copy) on one worker thread, which on CUDA owns one stream of its
    # own, and join results on a second worker, so both overlap the main
    # thread's detection and C++ build (which release the GIL).
    async_dispatch: bool = True
    # "stream": join each window's result as soon as its turn comes
    # (lowest latency to the sink); "bulk": join up to
    # ``bulk_fetch_windows`` windows at once, all rankings assigned before
    # any is emitted. In bulk mode ``bulk_fetch_windows`` replaces
    # pipeline_depth as the in-flight bound, and the resume cursor
    # advances at each flush. Bulk is kept for parity with the JAX
    # package's config: on a local card no run has shown it ahead of
    # stream (PERF.md §6).
    fetch_mode: str = "stream"
    bulk_fetch_windows: int = 32
    # Micro-batched dispatch: accumulate up to this many anomalous
    # windows' graphs and rank them as ONE stacked rank program (one
    # launch of each kernel a power-iteration step for the whole group,
    # one copy of the group's results). Results still emit per window,
    # in order. Trade-off: the first window of a group waits for its
    # group-mates before ranking, so keep 1 (default) for the lowest
    # per-window latency. Ignored, with a warning, under
    # run(batch_windows=True) or device_checks. Every kernel runs a group
    # as one program (kind in every precision, packed, packed_bf16,
    # packed_blocked, pcsr, csr, coo, dense, dense_bf16, pallas).
    dispatch_batch_windows: int = 1
    # Stage each window's graph (or stacked group's) as ONE pinned buffer
    # sent in one copy and read on the card as typed views
    # (rank_backends.blob), as the JAX package does by default; False
    # copies it leaf by leaf (the "tree" path), each copy from pageable
    # memory waiting for the work queued before it on the stream.
    blob_staging: bool = True
    # The per-run journal (out_dir/journal.jsonl, obs.RunJournal) and
    # the metrics registry's snapshot, which the CLI writes beside the
    # results (out_dir/metrics.json, read back by ``cli stats``).
    telemetry: bool = True
    # Tuned-policy consultation (scenarios.policy): "auto" resolves the
    # spectrum method / kernel / pad_policy from a persisted policy.json
    # for every one of those fields still at its built-in default
    # (explicit config always wins); "off" never consults. As in the
    # JAX package, any value but "off" consults.
    tuned_policy: str = "auto"     # "auto" | "off"
    # Warm-start seam (K19, the stream lane): while an incident is open,
    # thread the previous ranked window's converged score / rv vectors
    # into the next overlapping window's iteration (mapped across the
    # window delta by op name and the kind columns' representative trace
    # ids, rank_backends.warm). Pays off with a convergence tol set
    # (pagerank.tol: iteration counts drop); without one the fixed
    # iterations run either way. Warm windows dispatch one at a time (no
    # coalescing), so keep this off for burst-heavy streams where
    # coalescing wins. (JAX's delta_build is not ported: ROADMAP.md.)
    warm_start: bool = False
    # Fused pair program: each abnormal window through the warm program
    # staged as one blob with its init, both solves and the epilogue in
    # one program, one copy of its nine outputs back
    # (dispatch.DispatchRouter.rank_fused). Implies the warm-start
    # threading; fused windows dispatch one at a time.
    fused_pair: bool = False
    # Directory of the warmup manifest (dispatch.cache): None resolves
    # MICRORANK_JIT_CACHE, else ~/.cache/microrank_tpu/jit, as in the
    # JAX package. The port compiles no programs at run time; the
    # directory holds the manifest of warmed shapes only.
    compile_cache_dir: Optional[str] = None

    def __post_init__(self):
        if self.kernel not in KERNELS:
            raise ValueError(
                f"unknown kernel {self.kernel!r} (expected one of {KERNELS})"
            )
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r} (expected one of {BACKENDS})"
            )
        if self.fetch_mode not in FETCH_MODES:
            raise ValueError(
                f"unknown fetch_mode {self.fetch_mode!r} (expected one of "
                f"{FETCH_MODES})"
            )


@dataclass(frozen=True)
class IngestConfig:
    """Span admission on the interned table (ingest.admit_table): the
    fields of the JAX package's IngestConfig that its ``admit_table``
    reads, with the same names and defaults."""

    # Off: tables pass through untouched.
    enabled: bool = True
    # Longer than an hour is a corrupt export, not a span (reason
    # duration_overflow); 0 disables the check.
    max_duration_us: int = 3_600_000_000
    # Spans of a trace past the cap reject in row order (reason
    # trace_too_long); 0 disables the budget.
    max_spans_per_trace: int = 4096
    # Refuse a stream window WHOLE when fewer than this fraction of its
    # spans survive admission: no baseline update, no incident
    # transition (the window records as skipped, reason low_admission).
    min_admission_ratio: float = 0.5
    # Dead-letter store: directory for quarantine.jsonl (None = the
    # run's out_dir) and its byte cap (records past it drop + count).
    quarantine_dir: Optional[str] = None
    quarantine_max_bytes: int = 16 << 20


@dataclass(frozen=True)
class ObsConfig:
    """Self-tracing (obs.spans) and the flight recorder (obs.flight): the
    fields of the JAX package's ObsConfig that the span tracer and the
    recorder's triggers (incident open, serve's degraded dispatch and
    SIGTERM drain) read, and the legacy stage-latency knob of the chaos
    hooks, with the same names and defaults. The profiler comes with its
    lane (ROADMAP.md, port queue item 11)."""

    # Span tracer on/off: each stage of a window records a span in a
    # bounded ring (a contextvar read and a locked deque append a span).
    spans: bool = True
    # Ring capacity in spans; the oldest fall off.
    span_ring: int = 8192
    # Rotate the run journal (obs.RunJournal) into journal.jsonl.<n>
    # parts once the next line would take it past this many bytes, an
    # fsync before each rename (0: never rotate); read_journal and ``cli
    # stats`` read the parts in order.
    journal_max_bytes: int = 0
    # Flight recorder: dump the ring (+ correlated journal events + a
    # metrics snapshot) to out_dir/flight/<stamp>-<reason>/ when a stream
    # incident opens. Dumps within ``flight_min_interval_seconds`` of the
    # previous one are suppressed (counted) so an incident storm cannot
    # fill the disk.
    flight: bool = True
    flight_min_interval_seconds: float = 30.0
    # Chaos knob (legacy, recorded through chaos.faults): sleep this long
    # inside every ``inject_every``-th span named ``inject_stage``
    # (0 disables).
    inject_stage: str = "build"
    inject_stage_sleep_ms: float = 0.0
    inject_every: int = 1


@dataclass(frozen=True)
class ExplainConfig:
    """Rank provenance (``explain/``, JAX's ``ExplainConfig``): every
    ranked score decomposes into the four spectrum counters, the
    per-formula term values, the normal-vs-abnormal PageRank mass split
    and the coverage columns (traces) that fed the suspect's mass. The
    explained program (K15) carries them out in the rank program's one
    result copy, and the host writes an ``ExplainBundle`` (JSON + table).

    Off by default: the normal rank programs run unchanged."""

    # Master switch: the stream engine builds a bundle when a new
    # incident opens.
    enabled: bool = False
    # J: contributing coverage columns (traces) kept per suspect, per
    # partition.
    top_traces: int = 5
    # Suspects explained per window: 0 = every rank row (top_max +
    # extra_rows), else min(this, rank rows).
    top_suspects: int = 0
    # Stream engine: build and write a bundle when a NEW incident opens
    # (next to the flight dump, linked from its manifest; the
    # incident_open event carries the path).
    on_incident: bool = True
    # Recent bundles kept in the store ``GET /explainz`` serves.
    store_windows: int = 32
    # Mirror a compact explain record into the run journal.
    journal: bool = True


@dataclass(frozen=True)
class DispatchConfig:
    """The dispatch router's knobs (``dispatch/router.py``, JAX's
    ``DispatchConfig``). The stream engine hands prepared window graphs
    to the router, which (a) coalesces same-bucket windows queued behind
    an in-flight dispatch into one stacked program (K18), (b)
    double-buffers staging so the next batch's copy to the card is
    issued behind the current batch's program. Size routing to a mesh
    comes with item 12 (a configured mesh raises)."""

    # Stream burst coalescing: same-bucket windows pending behind the
    # current dispatch coalesce into one stacked program, up to this
    # many (1 disables).
    coalesce_windows: int = 8
    # Double-buffered staging: stage the NEXT ready batch (blob pack and
    # its copy to the card) after issuing the current program and
    # before fetching its results.
    double_buffer: bool = True
    # Record the shapes serve and stream dispatched (kernel, occupancy,
    # leaf shapes) into a manifest (dispatch.cache) and replay it at
    # startup, so a restarted process has dispatched every shape it will
    # need before its first request.
    warmup_manifest: bool = True


@dataclass(frozen=True)
class ServeConfig:
    """Online RCA service knobs (``cli serve``, JAX's ``ServeConfig``):
    concurrent requests coalesce into stacked rank programs (K18),
    admission control bounds the queue, and a failed device dispatch
    degrades to the numpy_ref oracle, marked ``degraded``."""

    host: str = "127.0.0.1"
    port: int = 8377
    # Admission control: requests admitted (queued or in flight) at
    # once; past it the service answers 429 with a Retry-After.
    max_queue_depth: int = 64
    retry_after_seconds: float = 1.0
    # Micro-batching: a shape bucket dispatches once it holds
    # max_batch_windows requests, or once its oldest request has waited
    # max_wait_ms.
    max_batch_windows: int = 8
    max_wait_ms: float = 25.0
    # Seconds an HTTP caller waits before 504 (the request itself still
    # completes and is journaled).
    request_timeout_seconds: float = 60.0
    # Dispatch the stacked program at warmup_occupancies before traffic.
    warmup: bool = True
    # After a failed device dispatch (one retry), rank each batch member
    # on the numpy_ref oracle and mark it degraded; off, the batch's
    # requests fail with 500. Read only off the card: on a CUDA device a
    # failed batch always fails (500), never answered from the host.
    fallback: bool = True
    # SIGTERM drain bound for in-flight requests.
    drain_seconds: float = 10.0
    # Test knob: fail this many device dispatches (retries included)
    # with an injected error before behaving normally.
    inject_dispatch_failures: int = 0
    # Occupancies the startup warmup dispatches; each in
    # [1, max_batch_windows], checked at start.
    warmup_occupancies: Tuple[int, ...] = (1, 2)
    # Build-pool threads for the host half (admission, detection, the
    # C++ build); 0 builds on the scheduler thread.
    build_workers: int = 2


@dataclass(frozen=True)
class StreamConfig:
    """Continuous RCA engine knobs (``cli stream``, JAX's
    ``StreamConfig``): event-time windows closed at the watermark,
    detected against online SLO baselines, and only abnormal windows
    built and ranked on the card."""

    # Tumbling windows of ``window_minutes`` when slide_minutes is None,
    # sliding (overlapping) windows otherwise.
    window_minutes: float = 5.0
    slide_minutes: Optional[float] = None
    # Watermark lag: a window [s, s+w) closes once the max span start
    # seen passes s+w+lateness; spans older than the watermark are
    # dropped and counted (microrank_stream_late_spans_total).
    allowed_lateness_seconds: float = 30.0
    # Online SLO baseline: exponential-decay weight of one healthy
    # window in each op's mean/std and P^2 quantile state.
    baseline_decay: float = 0.1
    # Cold start (no normal seed): windows fed to the baseline before
    # detection arms.
    min_healthy_windows: int = 1
    # Incident lifecycle: healthy windows that resolve an open incident,
    # and the windows after a resolve during which the same fingerprint
    # is suppressed.
    resolve_after_windows: int = 2
    cooldown_windows: int = 2
    # Fingerprint: tie-aware top-k suspect set; windows whose
    # fingerprints match or overlap by >= fingerprint_jaccard dedup into
    # one incident; an update whose normalized scores moved by at least
    # fingerprint_score_drift (L-inf) is flagged drifted (<= 0 off).
    fingerprint_top_k: int = 5
    fingerprint_jaccard: float = 0.5
    fingerprint_score_drift: float = 0.25
    # Build worker pool threads, and abnormal windows in flight (build
    # submitted, rank pending).
    build_workers: int = 2
    pipeline_windows: int = 2
    # Optional incident webhook (best effort, bounded retry queue).
    webhook_url: Optional[str] = None
    webhook_timeout_seconds: float = 2.0
    webhook_retry_max: int = 4
    webhook_queue: int = 64
    # Crash-only durability: checkpoint the engine's host state (the
    # baseline, the incident tracker, the windower's watermark and open
    # buffers, the source cursor) to out_dir/state.ckpt at every drained
    # window boundary, so `cli stream --resume` continues the run.
    checkpoint: bool = True
    # Stop after this many closed windows (0: until the source ends).
    max_windows: int = 0


@dataclass(frozen=True)
class SchedConfig:
    """The device scheduler (``sched/``, JAX's ``SchedConfig``): serve
    and stream park their device work in one store, dequeued by lane
    (open incident > serve > backfill), weighted fair share across
    tenants and soft token-bucket quotas (work-conserving: a tenant out
    of tokens sorts behind, it is never starved)."""

    # (tenant, weight) pairs; unlisted tenants get default_weight.
    tenant_weights: Tuple[Tuple[str, float], ...] = ()
    default_weight: float = 1.0
    # (tenant, windows/second) refill rates; unlisted tenants are
    # unthrottled, rate 0 is a background tenant.
    tenant_rates: Tuple[Tuple[str, float], ...] = ()
    # Token bucket capacity (windows).
    burst: float = 8.0
    # Tenants the non-serve lanes charge their dispatches to.
    stream_tenant: str = "stream"
    backfill_tenant: str = "backfill"
    # Replay the manifest's recorded shapes at startup.
    shape_warmup: bool = True
    # At most this many recorded shapes per (pipeline, kernel).
    max_shapes: int = 8


@dataclass(frozen=True)
class ChaosConfig:
    """The fault-injection harness (``chaos/``, JAX's ``ChaosConfig``):
    one seeded, deterministic ``FaultPlan`` drives every seam (dispatch,
    build, fetch, source, webhook, checkpoint, warehouse seal, stages).
    The legacy knobs (``ServeConfig.inject_dispatch_failures``,
    ``ObsConfig.inject_stage_sleep_ms``) record through the same
    surface."""

    # Master switch (also set by ``--chaos PLAN.json``). Off: every seam
    # is a None check.
    enabled: bool = False
    # RNG seed of the probabilistic specs (prob < 1).
    seed: int = 0
    # A JSON fault plan: {"seed": N, "faults": [{spec}, ...]}.
    plan_path: Optional[str] = None
    # Inline fault specs (dicts: seam, kind, after, count, every, value,
    # prob), before the plan file's.
    faults: Tuple[Dict[str, Any], ...] = ()


@dataclass(frozen=True)
class WarehouseConfig:
    """The trace warehouse (``warehouse/``, JAX's ``WarehouseConfig``):
    the stream engine seals every closed window into a tiered store (hot
    in memory, warm one ``.npz`` segment a window, cold compacted
    multi-window segments), each with its own detection context, so any
    stored range re-ranks later (``cli replay --at``, ``cli scenarios
    --from-warehouse``)."""

    # Master switch: segments are sealed only when on and the run has an
    # output dir.
    enabled: bool = False
    # Segment root; None: <out_dir>/warehouse.
    dir: Optional[str] = None
    # Store each window's admitted span table (dictionary-encoded).
    store_spans: bool = True
    # Store the ranked windows' packed rank blob, layout and op names:
    # replay is a blob load and a dispatch, no parse and no build.
    store_blobs: bool = True
    # Compact the oldest warm segments into one cold segment once this
    # many exist (0 disables).
    compact_after: int = 16
    # Drop the oldest cold segments past this count (0: unbounded).
    retention_segments: int = 0


# The JAX package's config fields the port lacks: (section, field) ->
# (JAX's default, what brings it). A config dict may carry each at that
# default (a JAX ``to_dict`` does); ``from_dict`` refuses any other
# value, naming the item. A None item: no counterpart on the card, either
# value is taken (XLA's donation of the staged buffer).
_ITEM_9 = "item 9 (the pandas lane's admission ladder)"
_ITEM_11_PROFILER = "item 11 (the profiler)"
_ITEM_11_STREAM = "item 11 (the stream slice's remainder: --delta-build)"
_ITEM_11_FLEET = "item 11 (the fleet slice)"
_ITEM_12 = "item 12 (the mesh)"
_ANALYSIS = "analysis/ (mrlint, mrsan; not queued)"
JAX_ONLY_FIELDS: Dict[Tuple[str, str], Tuple[Any, Optional[str]]] = {
    ("pagerank", "compensated_psum"): (False, _ITEM_12),
    ("pagerank", "sparse_allreduce"): (False, _ITEM_12),
    ("pagerank", "sparse_allreduce_cap"): (0, _ITEM_12),
    ("runtime", "mesh_shape"): (None, _ITEM_12),
    ("runtime", "mesh_axes"): (("shard",), _ITEM_12),
    ("runtime", "dtype"): ("float32", "a dtype the port ranks in (float32 only)"),
    ("runtime", "sanitizers"): (False, _ANALYSIS),
    ("runtime", "delta_build"): (False, _ITEM_11_STREAM),
    ("runtime", "delta_max_changed"): (0.5, _ITEM_11_STREAM),
    ("dispatch", "sharded_bytes_threshold"): (64 << 20, _ITEM_12),
    ("dispatch", "shard_on_full_occupancy"): (True, _ITEM_12),
    ("dispatch", "donate_staging"): (True, None),
    ("obs", "profile_every_n"): (0, _ITEM_11_PROFILER),
    ("obs", "profile_dir"): (None, _ITEM_11_PROFILER),
    ("ingest", "orphan_policy"): ("stitch", _ITEM_9),
    ("ingest", "max_skew_seconds"): (300.0, _ITEM_9),
    ("ingest", "skew_reject_seconds"): (3600.0, _ITEM_9),
    ("ingest", "forward_skew_seconds"): (30.0, _ITEM_9),
    ("ingest", "max_ops_per_window"): (20000, _ITEM_9),
    ("ingest", "max_new_ops_per_window"): (32, _ITEM_9),
    ("ingest", "parse_retry_max"): (3, _ITEM_9),
}
# The JAX package's config sections the port lacks, at JAX's defaults:
# the fleet (fleet/) and the stage watchdog (obs/watchdog.py), both the
# fleet slice's.
JAX_ONLY_SECTIONS: Dict[str, Tuple[Dict[str, Any], str]] = {
    "fleet": ({
        "partitions": 0, "partition_by": "trace", "heartbeat_seconds": 1.0,
        "lease_seconds": 5.0, "host": "127.0.0.1", "port": 0, "report_timeout_seconds": 2.0,
        "report_queue": 256, "restart_dead_workers": True, "restart_delay_seconds": 0.0,
        "max_restarts": 1, "metrics_in_heartbeat": True, "delta_max_bytes": 262144,
        "host_series_grace": 2, "max_clock_skew_seconds": 5.0,
    }, _ITEM_11_FLEET),
    "watchdog": ({
        "enabled": True, "eval_seconds": 1.0, "fast_windows": 5, "slow_windows": 60,
        "burn_threshold": 1.0, "stage_budget_ms": 500.0, "stage_budgets": (),
        "stage_error_budget": 0.1, "error_budget": 0.1, "watermark_lag_budget_seconds": 600.0,
        "queue_depth_budget": 8.0, "min_samples": 3, "resolve_after_evals": 3,
        "cooldown_evals": 5, "host_attribution_factor": 2.0,
    }, _ITEM_11_FLEET),
}


def _tupled(value):
    """A JSON list as the config holds it: lists (and lists of pairs)
    back to tuples, dicts (a chaos fault spec) as dicts."""
    if isinstance(value, (list, tuple)):
        return tuple(_tupled(v) for v in value)
    return dict(value) if isinstance(value, dict) else value


def _refuse_unported(section: str, field_name: str, value, default, item) -> None:
    if item is not None and _tupled(value) != _tupled(default):
        raise NotImplementedError(
            f"config {section}.{field_name} = {value!r}: the port takes only JAX's default "
            f"{default!r}; another value comes with {item} (ROADMAP.md, port queue)")


@dataclass(frozen=True)
class MicroRankConfig:
    detector: DetectorConfig = field(default_factory=DetectorConfig)
    pagerank: PageRankConfig = field(default_factory=PageRankConfig)
    spectrum: SpectrumConfig = field(default_factory=SpectrumConfig)
    window: WindowConfig = field(default_factory=WindowConfig)
    compat: CompatConfig = field(default_factory=CompatConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    ingest: IngestConfig = field(default_factory=IngestConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)
    dispatch: DispatchConfig = field(default_factory=DispatchConfig)
    stream: StreamConfig = field(default_factory=StreamConfig)
    explain: ExplainConfig = field(default_factory=ExplainConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    sched: SchedConfig = field(default_factory=SchedConfig)
    chaos: ChaosConfig = field(default_factory=ChaosConfig)
    warehouse: WarehouseConfig = field(default_factory=WarehouseConfig)

    def replace(self, **kwargs: Any) -> "MicroRankConfig":
        return dataclasses.replace(self, **kwargs)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MicroRankConfig":
        """The config of a dict of sections (``to_dict``'s, or the JAX
        package's): each section's known fields, tuples from lists, JAX's
        ``runtime.backend`` "jax" as this package's "torch"; a field the
        port lacks (``JAX_ONLY_FIELDS``, ``JAX_ONLY_SECTIONS``) at JAX's
        default, else ``NotImplementedError`` naming its item. Other
        unknown keys are dropped, as JAX's ``from_dict`` drops them."""
        for name, (defaults, item) in JAX_ONLY_SECTIONS.items():
            for key, value in (d.get(name) or {}).items():
                if key in defaults:
                    _refuse_unported(name, key, value, defaults[key], item)
        sections = {}
        for f in dataclasses.fields(cls):
            typ = f.default_factory
            sub = dict(d.get(f.name) or {})
            for key, value in sub.items():
                if (f.name, key) in JAX_ONLY_FIELDS:
                    _refuse_unported(f.name, key, value, *JAX_ONLY_FIELDS[(f.name, key)])
            if f.name == "runtime" and sub.get("backend") == "jax":
                sub["backend"] = "torch"
            base = typ()
            known = {g.name for g in dataclasses.fields(typ)}
            sections[f.name] = typ(**{
                k: _tupled(v) if isinstance(getattr(base, k), tuple) else v
                for k, v in sub.items() if k in known})
        return cls(**sections)
