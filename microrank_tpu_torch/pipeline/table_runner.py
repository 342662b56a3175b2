"""The native-ingest lane over a SpanTable (counterpart of
``microrank_tpu/pipeline/table_runner.py``, synchronous per-window path).

Same orchestration as the JAX lane: the reference's window arithmetic
(online_rca.py:155-216 — windows of ``detect_minutes``, advanced by an
extra ``skip_minutes`` after an anomalous window), fused C++ detection,
the C++ graph build with in-build kind collapse, and one rank program
per anomalous window on the device, fetched in one copy.

Ingest admission (``ingest.admit_table``) runs where the JAX lane runs
it: on the normal table before the SLO fit, and on the table under
suspicion before detection.

Not ported yet (ROADMAP.md "Port queue"): the mesh, batch windows,
bulk fetch, the async staging pool, the quarantine store, the tuned
policy, the journal and the metrics registry.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np

from ..config import MicroRankConfig
from ..graph.build import aux_for_kernel, kind_dedup_ratio
from ..graph.table_ops import (
    build_window_graph_from_table,
    compute_slo_from_table,
    detect_window_partition,
)
from ..ingest import admit_table
from ..rank_backends.convert import graph_from_numpy
from ..rank_backends.torch_cuda import (
    choose_kernel,
    device_subset,
    fetch_rank_outputs,
    host_subset,
    rank_window_traced_core,
)
from ..utils.device import resolve_device
from .results import ResultSink, WindowResult

_US_PER_MIN = 60_000_000


def _iso(us: int) -> str:
    return str(np.datetime64(int(us), "us"))


class StageTimings:
    """Wall-clock milliseconds per named stage of one window."""

    def __init__(self):
        self._ms: Dict[str, float] = {}

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._ms[name] = self._ms.get(name, 0.0) + (
                time.perf_counter() - t0
            ) * 1e3

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
        self._thresh = None
        self._remap_cache = None  # (id(table), svc-op -> SLO vocab remap)

    def fit_baseline(self, normal_table) -> None:
        from ..detect.detector import _thresholds

        # A poisoned normal dump must not poison the SLO floor.
        normal_table, _ = admit_table(
            normal_table, self.config.ingest, source="table:normal"
        )
        self.slo_vocab, self.baseline = compute_slo_from_table(
            normal_table, stat=self.config.detector.slo_stat
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
        return graph, op_names, kernel

    def launch_rank(self, graph, op_names, kernel):
        """Device half: copy the fields the kernel reads to the device,
        build the kernels' per-window layouts and issue the rank program.
        Returns opaque handles (tensors still in flight) for
        ``finalize_rank``."""
        cfg = self.config
        dgraph = device_subset(
            graph_from_numpy(host_subset(graph, kernel), self.device),
            kernel,
            cfg.pagerank.packed_block_bytes,
        )
        outs = rank_window_traced_core(
            dgraph, cfg.pagerank, cfg.spectrum, kernel
        )
        return outs, op_names

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

    def finalize_rank(self, handles):
        """One device-to-host copy of a dispatched rank. Returns
        (names, scores, conv-summary-or-None)."""
        outs, op_names = handles
        top_idx, top_scores, n_valid, residuals, n_iters = fetch_rank_outputs(outs)
        names = [op_names[int(i)] for i in top_idx[:n_valid]]
        scores = [float(s) for s in top_scores[:n_valid]]
        if self.config.runtime.validate_numerics:
            assert_finite_scores(scores, "TableRCA.rank_window")
        conv = (
            self._conv_summary(residuals, n_iters)
            if self.config.runtime.convergence_trace
            else None
        )
        return names, scores, conv

    def run(
        self,
        table,
        out_dir=None,
        sink: Optional[ResultSink] = None,
    ) -> List[WindowResult]:
        """Slide over the table and RCA every anomalous window; results
        go to ``sink`` (a ResultSink in ``out_dir`` when given) in
        window order."""
        cfg = self.config
        if self.baseline is None:
            raise RuntimeError("call fit_baseline() before run()")
        table, _ = admit_table(table, cfg.ingest, source="table")
        if sink is None and out_dir is not None:
            sink = ResultSink(out_dir, overwrite_csv=cfg.compat.overwrite_results)
        if table.n_spans == 0:
            return []
        detect_us = int(cfg.window.detect_minutes * _US_PER_MIN)
        skip_us = int(cfg.window.skip_minutes * _US_PER_MIN)
        current = int(table.start_us.min())
        end = int(table.end_us.max())
        results: List[WindowResult] = []
        try:
            while current < end:
                ranked = self._window(table, current, current + detect_us, results)
                if sink is not None:
                    sink.emit(results[-1])
                if ranked:
                    current += skip_us
                current += detect_us
        finally:
            self._remap_cache = None
        return results

    def _window(self, table, w0: int, w1: int, results: List[WindowResult]) -> bool:
        """Detect, and rank if anomalous, one window; appends its
        WindowResult and returns whether it was ranked."""
        cfg = self.config
        timings = StageTimings()
        result = WindowResult(start=_iso(w0), end=_iso(w1), anomaly=False)
        results.append(result)
        with timings.stage("detect"):
            mask, nrm, abn, n_window, row_range = self._detect_window(table, w0, w1)
        ranked = False
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
                with timings.stage("rank_dispatch"):
                    prep = self.prepare_rank(table, mask, nrm, abn, row_range)
                    result.kernel = prep[2]
                    result.kind_dedup = kind_dedup_ratio(prep[0])
                    handles = self.launch_rank(*prep)
                with timings.stage("rank_wait"):
                    names, scores, conv = self.finalize_rank(handles)
                result.ranking = list(zip(names, scores))
                result.apply_convergence(conv)
        result.timings = timings.as_dict()
        return ranked


def run_rca_native(
    normal_path,
    abnormal_path,
    config: MicroRankConfig = MicroRankConfig(),
    out_dir=None,
    device=None,
) -> List[WindowResult]:
    """CSV paths in, window results out, no pandas anywhere. ``device``
    as for TableRCA."""
    from ..native import load_span_table

    rca = TableRCA(config, device=device)
    rca.fit_baseline(load_span_table(normal_path))
    return rca.run(load_span_table(abnormal_path), out_dir=out_dir)
