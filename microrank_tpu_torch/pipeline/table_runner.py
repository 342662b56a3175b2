"""The native-ingest lane over a SpanTable (counterpart of
``microrank_tpu/pipeline/table_runner.py``, single-device window loop).

Same orchestration as the JAX lane: the reference's window arithmetic
(online_rca.py:155-216 — windows of ``detect_minutes``, advanced by an
extra ``skip_minutes`` after an anomalous window), fused C++ detection,
the C++ graph build with in-build kind collapse, and one rank program
per anomalous window on the device, fetched in one copy.

``run`` pipelines the loop as the JAX lane does by default: up to
``pipeline_depth`` rank programs in flight, the dispatch on a stage
worker thread that owns one CUDA stream, joins on a fetch worker (or in
bulk, ``fetch_mode="bulk"``), results emitted strictly in window order,
a resume cursor saved per emitted window and a per-run journal
(``obs.RunJournal``) beside the results.

Ingest admission (``ingest.admit_table``) runs where the JAX lane runs
it: on the normal table before the SLO fit, and on the table under
suspicion before detection, whose rejected rows ``run`` writes to the
dead-letter store ``out_dir/quarantine.jsonl`` (``ingest.quarantine``;
``IngestConfig.quarantine_dir`` overrides the directory).
``fit_baseline`` then resolves the tuned policy
(``scenarios.policy.apply_tuned_policy``). The loop records the JAX
lane's registry metrics at its places: stage seconds, windows by
outcome, the kind dedup factor, staged bytes, the convergence
histograms, the in-flight gauge and the spans recorded
(``obs.metrics``); the CLI writes the snapshot beside the results.
Each run arms a fresh span tracer (``obs.spans``, ``config.obs``): a
window is one trace, ``win-<start>``, and each of its stages a span.

Staging is JAX's default blob staging (``runtime.blob_staging``,
``rank_backends.blob``): each window's graph, or each stacked group's,
packed into one pinned buffer, sent in one copy and read on the card as
typed views. On every route nothing from that copy to
the output copy waits on the device, so window n + 1's staging and
program issue while window n runs.

Stacked windows, as the JAX lane runs them on one device: the
micro-batched dispatch (``runtime.dispatch_batch_windows = K > 1``: up
to K anomalous windows' graphs stacked into one rank program, joined
per group or, under bulk, all groups at once) and the two-phase
``run(batch_windows=True)`` (detect every window, then build and rank
all anomalous ones in one stacked program). A stacked program is K18
(``rank_backends.torch_cuda`` on a ``parallel.stack_window_graphs``
graph): one launch of each kernel a power-iteration step for the group,
whatever kernel it resolves to (kind in every precision, packed,
packed_bf16, packed_blocked, pcsr, csr, coo, dense, dense_bf16,
pallas), so a group of windows past the dense budget ranks as one
program too.

``runtime.device_checks`` (K14) makes the JAX lane's decisions with its
warnings: each window's program is the checked one (its check word
rides the window's one result copy, and the fetch raises
``DeviceCheckError``); the dispatch runs synchronously; micro-batched
dispatch falls back to per-window dispatch; ``run(batch_windows=True)``
ranks its stacked program unchecked.

Not ported yet (ROADMAP.md "Port queue"): the mesh, and the flight
recorder that dumps the span ring.
"""

from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import MicroRankConfig
from ..graph.build import aux_for_kernel, kind_dedup_ratio
from ..graph.table_ops import (
    build_window_graph_from_table,
    compute_slo_from_table,
    detect_window_partition,
)
from ..ingest import admit_table, configure_quarantine
from ..obs import JOURNAL_NAME, RunJournal
from ..obs.metrics import (
    pipeline_inflight,
    record_convergence,
    record_kind_dedup,
    record_window_outcome,
    stage_seconds,
)
from ..obs.spans import configure_tracer, get_tracer
from ..utils.guards import authorize_device_thread, claim_device_owner
from ..parallel import stack_window_graphs
from ..rank_backends.blob import stage_rank_window, stage_rank_windows_batched
from ..rank_backends.torch_cuda import (
    choose_kernel,
    host_subset,
    pack_rank_outputs,
    unpack_rank_outputs,
)
from ..utils.device import resolve_device
from .checkpoint import WindowCursor, load_slo, save_slo
from .results import ResultSink, WindowResult

_US_PER_MIN = 60_000_000

log = logging.getLogger("microrank_tpu_torch.pipeline.table")


def _iso(us: int) -> str:
    return str(np.datetime64(int(us), "us"))


def _gauge_inflight(lane: str, n: int) -> None:
    pipeline_inflight().set(n, lane=lane)


class StageTimings:
    """Wall-clock milliseconds per named stage of one window; each stage
    also lands in the registry's ``microrank_stage_seconds`` histogram,
    in seconds, and is a span of the process tracer around the same
    region, as the JAX package's StageTimings records them. ``ctx`` (an
    ``obs.spans.SpanContext``) pins every stage to one trace, the
    window's, whatever thread finishes it."""

    def __init__(self, ctx=None):
        self._ms: Dict[str, float] = {}
        self.ctx = ctx

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        with get_tracer().span(name, ctx=self.ctx):
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                self._ms[name] = self._ms.get(name, 0.0) + dt * 1e3
                stage_seconds().observe(dt, stage=name)

    def as_dict(self) -> Dict[str, float]:
        return {k: round(v, 3) for k, v in self._ms.items()}


class NumericsError(ValueError):
    """A fetched ranking score is NaN or inf."""


def assert_finite_scores(scores, context: str) -> None:
    arr = np.asarray(scores, dtype=np.float64)
    bad = ~np.isfinite(arr)
    if bad.any():
        idx = np.flatnonzero(bad)[:5].tolist()
        raise NumericsError(
            f"non-finite ranking scores in {context}: positions {idx} of "
            f"{arr.size} (values {[float(arr[i]) for i in idx]})"
        )


class TableRCA:
    """Fit an SLO baseline on a normal-period table, then slide over an
    abnormal-period table and rank every anomalous window.

    ``device``: "cuda" or "cpu"; None takes ``config.runtime.device``
    (default "cuda"). Raises when CUDA is asked for and absent.
    """

    def __init__(self, config: MicroRankConfig = MicroRankConfig(), device=None):
        if config.spectrum.tiebreak != "name":
            raise ValueError(
                f"tiebreak={config.spectrum.tiebreak!r}: the device ranking "
                "breaks exact ties by ascending op name only"
            )
        self.config = config
        self.device = resolve_device(
            config.runtime.device if device is None else device
        )
        self.slo_vocab = None
        self.baseline = None
        self.policy_resolution = None  # set by fit_baseline
        self._thresh = None
        self._remap_cache = None  # (id(table), svc-op -> SLO vocab remap)

    def fit_baseline(self, normal_table, cache_path=None) -> None:
        """The SLO baseline from a normal-period table, or from
        ``cache_path`` (an npz, ``pipeline.checkpoint.save_slo``) when
        that file exists; a baseline computed here is saved there."""
        from ..detect.detector import _thresholds
        from ..scenarios.policy import apply_tuned_policy

        # A poisoned normal dump must not poison the SLO floor (its rows
        # go to whatever dead-letter store is current, as in JAX).
        normal_table, _ = admit_table(
            normal_table, self.config.ingest, source="table:normal"
        )
        if cache_path is not None and Path(cache_path).exists():
            self.slo_vocab, self.baseline = load_slo(cache_path)
        else:
            self.slo_vocab, self.baseline = compute_slo_from_table(
                normal_table, stat=self.config.detector.slo_stat
            )
            if cache_path is not None:
                save_slo(cache_path, self.slo_vocab, self.baseline)
        # Tuned-policy resolution, as the JAX lane makes it: the span
        # count and the fitted op cardinality; the trace-kind dedup is
        # not measured here, so the profile takes the "low" bucket.
        self.config, self.policy_resolution = apply_tuned_policy(
            self.config,
            lane="table",
            counts=(int(normal_table.n_spans), len(self.slo_vocab), None),
        )
        self._thresh = _thresholds(self.baseline, self.config.detector)
        self._remap_cache = None

    def _detect_window(self, table, w0: int, w1: int):
        """One window's detection through the fused C++ scan, with the
        SLO remap cached per table. Returns (mask, nrm, abn, n_window,
        row_range)."""
        # Keyed by id(): run() clears the cache on exit and the table
        # stays alive for the whole run.
        if self._remap_cache is None or self._remap_cache[0] != id(table):
            self._remap_cache = (
                id(table),
                np.ascontiguousarray(
                    self.slo_vocab.encode(table.svc_op_names), dtype=np.int32
                ),
            )
        return detect_window_partition(
            table,
            w0,
            w1,
            self.slo_vocab,
            self.baseline,
            self.config.detector,
            remap=self._remap_cache[1],
            thresh=self._thresh,
            with_range=True,
        )

    def prepare_rank(self, table, mask, nrm_codes, abn_codes, row_range=None):
        """Host half of a window rank: the C++ graph build with the views
        the kernel reads, and kernel="auto" resolved for this window.
        Returns (graph, op_names, kernel) for ``launch_rank``."""
        cfg = self.config
        graph, op_names, _, _ = build_window_graph_from_table(
            table,
            mask,
            nrm_codes,
            abn_codes,
            pad_policy=cfg.runtime.pad_policy,
            min_pad=cfg.runtime.min_pad,
            aux=aux_for_kernel(cfg.runtime.kernel),
            dense_budget_bytes=cfg.runtime.dense_budget_bytes,
            collapse=cfg.runtime.collapse_kinds,
            row_range=row_range,
            kind_dedup_threshold=cfg.runtime.kind_dedup_threshold,
        )
        kernel = cfg.runtime.kernel
        if kernel == "auto":
            kernel = choose_kernel(
                graph, cfg.runtime.dense_budget_bytes, cfg.runtime.prefer_bf16
            )
        record_kind_dedup(kind_dedup_ratio(graph))
        return graph, op_names, kernel

    def launch_rank(self, graph, op_names, kernel):
        """Device half: copy the fields the kernel reads to the device,
        build the kernels' per-window layouts, issue the rank program and
        start the copy of its packed outputs to the host, all on the
        current stream (in the async loop, the stage worker's own).
        Returns opaque handles for ``finalize_rank``."""
        return self.launch_program(graph, kernel), op_names

    def launch_program(self, graph, kernel):
        """The device half of one rank program, over one window's host
        graph or a stacked group's (``parallel.stack_window_graphs``):
        the fields the kernel reads staged on the device, the kernels'
        layouts, the program and the start of its outputs' one copy, all
        on the current stream. Staging is JAX's default: one pinned blob
        a window or group, one copy, typed views
        (``rank_backends.blob``); ``runtime.blob_staging=False`` copies
        leaf by leaf. A stacked group of B windows is one program on
        every route, packed_blocked's block budget divided by B as JAX's
        group launch divides it. Returns the packed outputs, holding the
        pinned blob until they are fetched."""
        cfg = self.config
        if graph.normal.kind.ndim == 2:
            outs, staged = stage_rank_windows_batched(
                host_subset(graph, kernel), cfg.pagerank, cfg.spectrum, kernel, self.device,
                cfg.runtime.blob_staging, conv_trace=True,
            )
            return pack_rank_outputs(outs, staged)
        # A window's program is the checked one under device_checks: its
        # check word rides the same copy, and the fetch raises on it.
        checked = bool(cfg.runtime.device_checks)
        outs, staged = stage_rank_window(
            host_subset(graph, kernel), cfg.pagerank, cfg.spectrum, kernel, self.device,
            cfg.runtime.blob_staging, checked=checked, conv_trace=True,
        )
        return pack_rank_outputs(outs, staged, checked=checked)

    def _ranking(self, op_names, outs, label):
        """(names, scores, conv-summary-or-None) of one window's fetched
        outputs (top_idx, top_scores, n_valid, residuals, n_iters)."""
        top_idx, top_scores, n_valid, residuals, n_iters = outs
        n = int(n_valid)
        names = [op_names[int(i)] for i in top_idx[:n]]
        scores = [float(x) for x in top_scores[:n]]
        if self.config.runtime.validate_numerics:
            assert_finite_scores(scores, label)
        conv = (
            self._conv_summary(residuals, n_iters)
            if self.config.runtime.convergence_trace
            else None
        )
        return names, scores, conv

    def _assign_rows(self, result, op_names, outs, b, label) -> None:
        """Window b's ranking (and convergence) from a stacked program's
        fetched outputs."""
        names, scores, conv = self._ranking(op_names, [x[b] for x in outs], label)
        result.ranking = list(zip(names, scores))
        self._apply_conv(result, conv)

    @staticmethod
    def _apply_conv(result, conv) -> None:
        """Fold a fetched convergence summary into the WindowResult and
        the per-kernel registry metrics."""
        result.apply_convergence(conv)
        if conv:
            record_convergence(
                result.kernel or "auto",
                conv["iterations"],
                conv["final_residual"]
                if conv["final_residual"] is not None
                else float("nan"),
            )

    @staticmethod
    def _conv_summary(residuals, n_iters):
        """{iterations, final_residual, residuals} from FETCHED arrays."""
        res = np.asarray(residuals, dtype=np.float64)
        n = int(n_iters)
        joint = res.max(axis=0)[:n]
        return {
            "iterations": n,
            "final_residual": float(joint[-1]) if n else None,
            "residuals": [float(x) for x in joint],
        }

    def finalize_rank_many(self, handles_list):
        """Wait for MANY dispatched ranks' result copies (each window's
        one device-to-host copy was started by ``launch_rank``) and
        unpack them. Returns [(names, scores, conv), ...] in input
        order; ``conv`` is the _conv_summary dict or None."""
        return [
            self._ranking(op_names, unpack_rank_outputs(packed), "TableRCA.rank_window")
            for packed, op_names in handles_list
        ]

    def finalize_rank(self, handles):
        """Wait for one dispatched rank's results. Returns (names,
        scores, conv-summary-or-None)."""
        return self.finalize_rank_many([handles])[0]

    def run(
        self,
        table,
        out_dir=None,
        sink: Optional[ResultSink] = None,
        batch_windows: bool = False,
        resume: bool = False,
        end_us: Optional[int] = None,
        complete_only: bool = False,
    ) -> List[WindowResult]:
        """Slide over the table; RCA every anomalous window.

        The loop is pipelined up to ``runtime.pipeline_depth`` rank
        programs deep: a window's rank is dispatched and only waited for
        once later windows' host work is done, so detection and the C++
        build overlap the device. With ``runtime.async_dispatch`` the
        dispatch (``launch_rank``) runs on a stage worker thread, which
        on CUDA issues on one stream of its own, and stream-mode joins on
        a fetch worker. ``runtime.fetch_mode="bulk"`` joins up to
        ``bulk_fetch_windows`` windows at once. Results reach the sink
        strictly in window order either way.

        ``end_us`` bounds the window loop (default: the table's last
        span end); ``complete_only`` skips a final window that would
        extend past that bound instead of ranking it partially.

        ``resume`` (needs ``out_dir``): restart from the persisted window
        cursor. The cursor records the NEXT window start and advances
        only when a window's result has been emitted, so a crash
        mid-pipeline re-runs the windows in flight instead of dropping
        them. A clean unbounded run clears it; a run bounded by
        ``end_us`` or ``complete_only`` leaves it at the next window.

        ``runtime.dispatch_batch_windows = K > 1``: anomalous windows
        gather in groups of K, each ranked by one stacked program
        (``launch_program``); ``pipeline_depth`` then bounds the
        groups in flight (stream) or ``bulk_fetch_windows`` the windows
        (bulk, where one join takes every group in flight). Results still
        reach the sink per window, in order, with ``chunk_fetch_ms`` /
        ``chunk_windows`` in their timings.

        ``batch_windows=True``: two phases, as the JAX lane's single
        device path. Detect every window first; then build every
        anomalous window's graph (at ``dense_budget_bytes`` shared by the
        batch) and rank them all in one stacked program, with the
        timings ``build`` and ``rank_batched`` shared by all; the sink
        receives every window at the end. ``dispatch_batch_windows`` is
        ignored there, with a warning.
        """
        cfg = self.config
        if self.baseline is None:
            raise RuntimeError("call fit_baseline() before run()")
        tracer = configure_tracer(cfg.obs)  # a fresh span ring per run
        claim_device_owner("table-runner")  # the stage worker is its delegate
        if cfg.ingest.enabled:
            # Rejected rows land in the dead-letter store beside the
            # results (or in IngestConfig.quarantine_dir).
            configure_quarantine(cfg.ingest, default_dir=out_dir)
            table, _ = admit_table(table, cfg.ingest, source="table")
        if sink is None and out_dir is not None:
            sink = ResultSink(out_dir, overwrite_csv=cfg.compat.overwrite_results)
        cursor = (
            WindowCursor(Path(out_dir) / "cursor.json")
            if out_dir is not None
            else None
        )
        journal = None
        if out_dir is not None and cfg.runtime.telemetry:
            journal = RunJournal(Path(out_dir) / JOURNAL_NAME)
            journal.run_start(
                pipeline="table",
                kernel=cfg.runtime.kernel,
                pad_policy=cfg.runtime.pad_policy,
                collapse_kinds=cfg.runtime.collapse_kinds,
                pipeline_depth=cfg.runtime.pipeline_depth,
                fetch_mode=cfg.runtime.fetch_mode,
                batch_windows=batch_windows,
                mesh=None,
            )
        if table.n_spans == 0:
            return []

        detect_us = int(cfg.window.detect_minutes * _US_PER_MIN)
        skip_us = int(cfg.window.skip_minutes * _US_PER_MIN)
        current = int(table.start_us.min())
        end = int(table.end_us.max())
        if end_us is not None:
            end = min(end, int(end_us))
        if resume and cursor is not None:
            saved = cursor.load()
            if saved is not None:
                current = int(np.datetime64(saved, "us").astype(np.int64))
                log.info("resuming window loop at %s", saved)

        if batch_windows and cfg.runtime.device_checks:
            log.warning(
                "device_checks applies to per-window dispatch only; "
                "run(batch_windows=True) without a mesh ranks without "
                "checkify instrumentation"
            )
        # The JAX lane also falls back to synchronous dispatch in a
        # multi-process mesh, which this package does not have.
        async_mode = bool(cfg.runtime.async_dispatch) and not batch_windows
        if async_mode and cfg.runtime.device_checks:
            log.warning(
                "device_checks forces synchronous dispatch (the "
                "in-program error check fetches device state per window)"
            )
            async_mode = False
        bulk = cfg.runtime.fetch_mode == "bulk" and not batch_windows
        # Rank programs in flight before the host joins; in bulk mode
        # the batch size replaces the depth.
        depth = max(1, int(
            cfg.runtime.bulk_fetch_windows if bulk else cfg.runtime.pipeline_depth
        ))
        # Micro-batched dispatch: groups of chunk_n windows, one stacked
        # program each. Of the JAX lane's reasons to ignore it (batch
        # windows, a mesh, several processes, device checks) the first
        # and the last exist here.
        chunk_n = max(1, int(cfg.runtime.dispatch_batch_windows))
        if chunk_n > 1:
            reason = None
            if batch_windows:
                reason = ("batch_windows=True already ranks every anomalous "
                          "window in one dispatch")
            elif cfg.runtime.device_checks:
                reason = "device_checks has no batched checkify variant"
            if reason is not None:
                log.warning(
                    "dispatch_batch_windows=%d ignored: %s; dispatching per window",
                    chunk_n, reason,
                )
                chunk_n = 1
        stage_pool = fetch_pool = None
        if async_mode:
            # One stage thread on one stream: the kernels' scratch (K1's
            # counters, the pattern pair's partials) must never be in
            # flight on two streams at once, and every tensor of a
            # window is allocated, used and freed on that stream.
            stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

            def init():
                # The owner's delegate (utils.guards), on its own stream.
                authorize_device_thread()
                if stream is not None:
                    torch.cuda.set_stream(stream)

            stage_pool = ThreadPoolExecutor(1, "mr-stage", init)
            if not bulk and chunk_n == 1:  # bulk and groups join on the main thread
                fetch_pool = ThreadPoolExecutor(1, "mr-fetch")

        results: List[WindowResult] = []
        pending = []  # (result, mask, nrm, abn, row_range): batch_windows' phase 2
        inflight = []  # (result or group items, handles-or-future, timings) dispatched
        finishing = []  # (result, finalize future, timings) async fetches
        chunk_pending = []  # (result, graph, op_names, kernel, timings) not yet dispatched
        emitted = 0  # results[:emitted] already sent to the sink
        next_cursor = {}  # id(result) -> post-advance window position (us)

        def _emit(r):
            sink.emit(r)
            if journal is not None:
                journal.window(r)
            # Not in batch mode: every window emits right before the
            # cursor is cleared.
            if cursor is not None and not batch_windows and id(r) in next_cursor:
                cursor.save(_iso(next_cursor[id(r)]))

        def _emit_ready():
            """Emit results in window order, stopping at the oldest
            window still in flight or in a group not yet dispatched (its
            ranking isn't final yet)."""
            nonlocal emitted
            if sink is None or batch_windows:
                return
            if finishing:
                stop = id(finishing[0][0])
            elif inflight:
                head = inflight[0][0]
                stop = id(head[0][0]) if isinstance(head, list) else id(head)
            elif chunk_pending:
                stop = id(chunk_pending[0][0])
            else:
                stop = None
            while emitted < len(results):
                r = results[emitted]
                if id(r) == stop:
                    break
                _emit(r)
                emitted += 1

        def _set_ranking(result, timings, names, scores, conv=None):
            result.ranking = list(zip(names, scores))
            result.timings = timings.as_dict()
            self._apply_conv(result, conv)
            _emit_ready()

        def _complete_one():
            """Join the oldest async fetch and emit its window."""
            result, fut, timings = finishing.pop(0)
            with timings.stage("rank_wait"):
                names, scores, conv = fut.result()
            _set_ranking(result, timings, names, scores, conv)

        def _finalize_one():
            result, handles, timings = inflight.pop(0)
            _gauge_inflight("window", len(inflight))
            if fetch_pool is not None:
                # handles is the stage future: chain its join with the
                # wait for its result copy on the fetch worker.
                fut = fetch_pool.submit(
                    lambda h=handles: self.finalize_rank(h.result())
                )
                finishing.append((result, fut, timings))
                if len(finishing) > depth:
                    _complete_one()
                return
            with timings.stage("rank_wait"):
                names, scores, conv = self.finalize_rank(handles)
            _set_ranking(result, timings, names, scores, conv)

        def _join_handles(handles):
            return handles.result() if stage_pool is not None else handles

        def _flush_bulk():
            """Join EVERY deferred window's results (fetch_mode="bulk").
            All rankings are assigned before anything is emitted:
            ``inflight`` stays populated until then, so no batch-mate
            reaches the sink half-finished. The join's wall time is
            reported per window as ``bulk_fetch_ms``, amortized evenly
            over the batch, with the batch size."""
            if not inflight:
                return
            items = inflight[:]
            handles = [_join_handles(h) for _, h, _ in items]
            t0 = time.perf_counter()
            ranked = self.finalize_rank_many(handles)
            wait_s = time.perf_counter() - t0
            for (result, _, timings), (names, scores, conv) in zip(
                items, ranked
            ):
                result.ranking = list(zip(names, scores))
                result.timings = {
                    **timings.as_dict(),
                    "bulk_fetch_ms": round(wait_s * 1e3 / len(items), 3),
                    "bulk_fetch_windows": len(items),
                }
                self._apply_conv(result, conv)
            inflight.clear()
            _gauge_inflight("window", 0)
            _emit_ready()

        def _launch_chunk(items):
            """One group's stacked program (on the stage worker in async
            mode: the graphs are already built). A group whose windows
            resolved to different kernels re-resolves on the stacked
            views, at the dense budget shared by its windows."""
            kernels = {k for _, _, _, k, _ in items}
            graphs = [g for _, g, _, _, _ in items]
            if len(kernels) == 1:
                kern = kernels.pop()
                stacked = stack_window_graphs([host_subset(g, kern) for g in graphs])
            else:
                stacked = stack_window_graphs(graphs)
                kern = choose_kernel(
                    stacked,
                    max(1, cfg.runtime.dense_budget_bytes // len(items)),
                    cfg.runtime.prefer_bf16,
                )
            return self.launch_program(stacked, kern)

        def _flush_chunk():
            if not chunk_pending:
                return
            items = chunk_pending[:]
            chunk_pending.clear()
            handles = (
                stage_pool.submit(_launch_chunk, items)
                if stage_pool is not None
                else _launch_chunk(items)
            )
            inflight.append((items, handles, None))
            _gauge_inflight("chunk", len(inflight))

        def _assign_chunk(items, outs, wait_ms_per_window):
            for b, (result, _, names, _, timings) in enumerate(items):
                self._assign_rows(result, names, outs, b, "TableRCA chunked window")
                result.timings = {
                    **timings.as_dict(),
                    "chunk_fetch_ms": round(wait_ms_per_window, 3),
                    "chunk_windows": len(items),
                }

        def _finalize_chunk_one():
            """Join the oldest dispatched group (its one copy)."""
            items, handles, _ = inflight.pop(0)
            _gauge_inflight("chunk", len(inflight))
            packed = _join_handles(handles)
            t0 = time.perf_counter()
            outs = unpack_rank_outputs(packed)
            wait_ms = (time.perf_counter() - t0) * 1e3
            _assign_chunk(items, outs, wait_ms / len(items))
            _emit_ready()

        def _flush_bulk_chunks():
            """Join EVERY dispatched group at once (fetch_mode="bulk")."""
            if not inflight:
                return
            entries = inflight[:]
            packs = [_join_handles(e[1]) for e in entries]
            t0 = time.perf_counter()
            fetched = [unpack_rank_outputs(p) for p in packs]
            wait_ms = (time.perf_counter() - t0) * 1e3
            n_total = sum(len(e[0]) for e in entries)
            for (items, _, _), outs in zip(entries, fetched):
                _assign_chunk(items, outs, wait_ms / n_total)
            inflight.clear()
            _gauge_inflight("chunk", 0)
            _emit_ready()

        if chunk_n > 1:
            join = _flush_bulk_chunks if bulk else _finalize_chunk_one
        else:
            join = _flush_bulk if bulk else _finalize_one
        try:
            while current + detect_us <= end if complete_only else current < end:
                w0, w1 = current, current + detect_us
                # One trace per window: the StageTimings ctx pins every
                # stage span to it, also those that complete later.
                timings = StageTimings(ctx=tracer.new_trace(f"win-{_iso(w0)}"))
                result = WindowResult(start=_iso(w0), end=_iso(w1), anomaly=False)
                ranked = False
                with timings.stage("detect"):
                    mask, nrm, abn, n_window, row_range = self._detect_window(
                        table, w0, w1
                    )
                if n_window == 0:
                    result.skipped_reason = "empty_window"
                else:
                    result.anomaly = len(abn) >= cfg.detector.min_abnormal_traces
                    result.n_normal, result.n_abnormal = len(nrm), len(abn)
                    result.n_traces = len(nrm) + len(abn)
                    if result.anomaly and (len(nrm) == 0 or len(abn) == 0):
                        result.skipped_reason = "degenerate_partition"
                    elif result.anomaly:
                        if cfg.compat.partition_swap:
                            nrm, abn = abn, nrm
                        ranked = True
                        if batch_windows:
                            pending.append((result, mask, nrm, abn, row_range))
                        elif chunk_n > 1:
                            with timings.stage("rank_dispatch"):
                                graph, op_names, kernel = self.prepare_rank(
                                    table, mask, nrm, abn, row_range
                                )
                            result.kernel = kernel
                            result.kind_dedup = kind_dedup_ratio(graph)
                            result.queue_depth = len(inflight)
                            chunk_pending.append((result, graph, op_names, kernel, timings))
                            if len(chunk_pending) >= chunk_n:
                                _flush_chunk()
                            # Groups in flight (stream) or windows (bulk).
                            in_flight = (
                                sum(len(e[0]) for e in inflight) if bulk else len(inflight)
                            )
                            if in_flight >= depth:
                                join()
                        else:
                            with timings.stage("rank_dispatch"):
                                prep = self.prepare_rank(table, mask, nrm, abn, row_range)
                                result.kernel = prep[2]
                                result.kind_dedup = kind_dedup_ratio(prep[0])
                                if stage_pool is not None:
                                    handles = stage_pool.submit(self.launch_rank, *prep)
                                else:
                                    handles = self.launch_rank(*prep)
                            result.queue_depth = len(inflight)
                            inflight.append((result, handles, timings))
                            _gauge_inflight("window", len(inflight))
                            if len(inflight) >= depth:
                                join()
                record_window_outcome(
                    "ranked" if ranked
                    else ("skipped" if result.skipped_reason else "clean")
                )
                results.append(result)
                if not ranked or batch_windows:
                    result.timings = timings.as_dict()
                if ranked:
                    current += skip_us
                current += detect_us
                next_cursor[id(result)] = current
                _emit_ready()

            if chunk_pending:
                _flush_chunk()  # the final partial group
            while inflight:
                join()
            while finishing:
                _complete_one()
            _emit_ready()
        finally:
            # Cancel what has not started and wait for what has: no
            # worker issues device work after run() returns or raises.
            for pool in (stage_pool, fetch_pool):
                if pool is not None:
                    pool.shutdown(wait=True, cancel_futures=True)
            self._remap_cache = None

        if batch_windows and pending:
            self._rank_pending(table, pending)
        if batch_windows and sink is not None:
            for r in results:
                _emit(r)
        if journal is not None:
            journal.run_end(
                windows=len(results),
                ranked=sum(1 for r in results if r.ranking),
            )
        if cursor is not None and end_us is None and not complete_only:
            # Bounded runs (a follower's polls) leave the cursor at the
            # next unranked window; the per-window saves advanced it.
            cursor.clear()
        return results

    def _rank_pending(self, table, pending) -> None:
        """Phase 2 of ``batch_windows``: every anomalous window's graph
        built at the dense budget shared by the batch (all of it resident
        at once), stacked, and ranked by one program with one copy of its
        outputs; ``build`` and ``rank_batched`` are shared timings."""
        cfg = self.config
        kernel = cfg.runtime.kernel
        op_names = list(table.pod_op_names)
        timings = StageTimings()
        budget = max(1, cfg.runtime.dense_budget_bytes // len(pending))
        graphs = []
        with timings.stage("build"):
            for result, mask, nrm, abn, row_range in pending:
                graph, _, _, _ = build_window_graph_from_table(
                    table, mask, nrm, abn,
                    pad_policy=cfg.runtime.pad_policy,
                    min_pad=cfg.runtime.min_pad,
                    aux=aux_for_kernel(kernel),
                    dense_budget_bytes=budget,
                    collapse=cfg.runtime.collapse_kinds,
                    row_range=row_range,
                    kind_dedup_threshold=cfg.runtime.kind_dedup_threshold,
                )
                result.kind_dedup = kind_dedup_ratio(graph)
                graphs.append(graph)
        with timings.stage("rank_batched"):
            stacked = stack_window_graphs(graphs)
            if kernel == "auto":
                kernel = choose_kernel(stacked, budget, cfg.runtime.prefer_bf16)
            outs = unpack_rank_outputs(self.launch_program(stacked, kernel))
        shared = timings.as_dict()
        for b, (result, _, _, _, _) in enumerate(pending):
            result.kernel = kernel
            self._assign_rows(result, op_names, outs, b, f"TableRCA batched window {b}")
            result.timings = {**result.timings, **shared}


def run_rca_native(
    normal_path,
    abnormal_path,
    config: MicroRankConfig = MicroRankConfig(),
    out_dir=None,
    device=None,
    resume: bool = False,
) -> List[WindowResult]:
    """CSV paths in, window results out, no pandas anywhere. ``device``
    as for TableRCA; ``resume`` as for ``TableRCA.run``."""
    from ..native import load_span_table

    rca = TableRCA(config, device=device)
    rca.fit_baseline(load_span_table(normal_path))
    return rca.run(load_span_table(abnormal_path), out_dir=out_dir, resume=resume)
