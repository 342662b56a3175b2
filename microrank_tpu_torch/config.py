"""Typed configuration for the PyTorch port (counterpart of
``microrank_tpu/config.py``).

Only the knobs the native ``run`` lane reads are carried over: the
detector, PageRank and spectrum settings, window arithmetic, the
reference-compat flags, and the runtime fields that shape the graph
build and the rank program. Field names and defaults match the JAX
package so a reader can hold the two side by side; the one deliberate
difference is ``RuntimeConfig.kernel`` (see there).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional

# Kernels this package implements. The JAX package's other kernel
# families (``auto`` -> kind / packed_bf16, packed_blocked, pcsr, csr,
# coo, dense) are queued in ROADMAP.md ("Port queue", item 1 for the
# auto path, item 9 for the rest).
KERNELS = ("pallas",)


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

    # Power-iteration kernel. The JAX package defaults to "auto", which
    # resolves to the plain-XLA kind / packed_bf16 programs and never
    # reaches a Pallas kernel. This port's first slice carries the one
    # Pallas kernel the JAX package has (ops/pallas_spmv.py, the COO
    # segment sum) as a hand-written CUDA kernel, so its only kernel —
    # and therefore its default — is "pallas": the same per-window
    # program as ``cli run --kernel pallas``.
    kernel: str = "pallas"
    # Pad dynamic extents to buckets (graph.structures.pad_to).
    pad_policy: str = "pow2q"
    min_pad: int = 8
    # Kind-collapse the trace axis in the C++ build: "auto" | "on" | "off".
    collapse_kinds: str = "auto"
    # Mirrors of the JAX build-policy knobs; with kernel="pallas" the
    # build requests no auxiliary views, so these only travel through.
    kind_dedup_threshold: float = 4.0
    dense_budget_bytes: int = 2 << 30
    # Carry the per-partition residual trace and n_iters out of the
    # rank program (always computed; this gates the WindowResult fields).
    convergence_trace: bool = True
    # Raise on non-finite fetched scores.
    validate_numerics: bool = True
    # "cuda" (default) or "cpu". Entry points also take ``device=``,
    # which wins over this field.
    device: str = "cuda"

    def __post_init__(self):
        if self.kernel not in KERNELS:
            raise NotImplementedError(
                f"kernel={self.kernel!r} is not ported yet: this package "
                "implements kernel='pallas' only. The auto path "
                "(kind / packed_bf16) is ROADMAP.md 'Port queue' item 1; "
                "the other kernel families are item 9."
            )


@dataclass(frozen=True)
class MicroRankConfig:
    detector: DetectorConfig = field(default_factory=DetectorConfig)
    pagerank: PageRankConfig = field(default_factory=PageRankConfig)
    spectrum: SpectrumConfig = field(default_factory=SpectrumConfig)
    window: WindowConfig = field(default_factory=WindowConfig)
    compat: CompatConfig = field(default_factory=CompatConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)

    def replace(self, **kwargs: Any) -> "MicroRankConfig":
        return dataclasses.replace(self, **kwargs)
