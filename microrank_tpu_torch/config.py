"""Typed configuration for the PyTorch port (counterpart of
``microrank_tpu/config.py``).

Only the knobs the native ``run`` lane reads are carried over: the
detector, PageRank and spectrum settings, window arithmetic, the
reference-compat flags, the runtime fields that shape the graph build,
the rank program and the window loop's pipelining, the ingest
admission budgets and dead-letter store, the span tracer, the
tuned-policy switch and the in-program device checks. Field names
and defaults match the JAX package so a reader can hold the two side by
side. Every kernel the JAX package's ``RuntimeConfig.kernel`` names is
ported; an unknown name raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional

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
# Ranking backends (RuntimeConfig.backend); "numpy_ref" is named so that
# a caller asking for it is told it is not ported.
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
    # "numpy_ref", the JAX package's numpy oracle backend, which is not
    # ported (ROADMAP.md, port queue item 9): the accuracy harness
    # raises NotImplementedError on it.
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
    # Dead-letter store: directory for quarantine.jsonl (None = the
    # run's out_dir) and its byte cap (records past it drop + count).
    quarantine_dir: Optional[str] = None
    quarantine_max_bytes: int = 16 << 20


@dataclass(frozen=True)
class ObsConfig:
    """Self-tracing (obs.spans) and the flight recorder (obs.flight): the
    fields of the JAX package's ObsConfig that the span tracer and the
    recorder's incident-open trigger read, with the same names and
    defaults. The profiler and the chaos hooks come with their lanes
    (ROADMAP.md, port queue item 11)."""

    # Span tracer on/off: each stage of a window records a span in a
    # bounded ring (a contextvar read and a locked deque append a span).
    spans: bool = True
    # Ring capacity in spans; the oldest fall off.
    span_ring: int = 8192
    # Flight recorder: dump the ring (+ correlated journal events + a
    # metrics snapshot) to out_dir/flight/<stamp>-<reason>/ when a stream
    # incident opens. Dumps within ``flight_min_interval_seconds`` of the
    # previous one are suppressed (counted) so an incident storm cannot
    # fill the disk.
    flight: bool = True
    flight_min_interval_seconds: float = 30.0


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
    # Stop after this many closed windows (0: until the source ends).
    max_windows: int = 0


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

    def replace(self, **kwargs: Any) -> "MicroRankConfig":
        return dataclasses.replace(self, **kwargs)
