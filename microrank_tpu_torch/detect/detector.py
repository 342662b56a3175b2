"""Vectorized SLO-deviation anomaly detector, numpy
(counterpart of ``microrank_tpu/detect/detector.py``).

    expected[t] = sum over spans s in t of (mu + k*sigma)[op(s)]
    real[t]     = max over spans s in t of duration(s) / 1000
    abnormal[t] = real[t] > expected[t] + slack

Operations unseen in the SLO baseline contribute 0, and traces whose
max span duration is <= 0 are dropped. The native lane runs the fused
C++ scan (``native.detect_window_native``), which is numerically
identical; this is its readable reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..config import DetectorConfig
from ..graph.structures import DetectBatch, SloBaseline

US_PER_MS = 1000.0


class DetectResult(NamedTuple):
    """Per-trace verdicts on the window-local trace axis."""

    abnormal: np.ndarray     # bool[T]
    valid: np.ndarray        # bool[T] trace has positive duration
    flag: np.ndarray         # bool scalar: window is anomalous
    expected_ms: np.ndarray  # float32[T]
    real_ms: np.ndarray      # float32[T]


def _thresholds(baseline: SloBaseline, cfg: DetectorConfig) -> np.ndarray:
    return baseline.mean_ms + np.float32(cfg.k_sigma) * baseline.std_ms


def detect_numpy(
    batch: DetectBatch, baseline: SloBaseline, cfg: DetectorConfig
) -> DetectResult:
    n_traces = int(batch.n_traces)
    n_spans = int(batch.n_spans)
    op = batch.op[:n_spans]
    trace = batch.trace[:n_spans]
    dur = batch.duration_us[:n_spans].astype(np.float32)

    thresh = _thresholds(baseline, cfg)
    contrib = np.where(op >= 0, thresh[np.clip(op, 0, None)], np.float32(0.0))
    expected = np.bincount(trace, weights=contrib, minlength=n_traces).astype(
        np.float32
    )
    real_us = np.full(n_traces, -np.inf, dtype=np.float32)
    np.maximum.at(real_us, trace, dur)
    real = (real_us / np.float32(US_PER_MS)).astype(np.float32)

    valid = real > 0
    abnormal = valid & (real > expected + np.float32(cfg.slack_ms))
    flag = np.asarray(abnormal.sum() >= cfg.min_abnormal_traces)
    return DetectResult(abnormal, valid, flag, expected, real)
