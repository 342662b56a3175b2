"""Result records and sinks (counterpart of
``microrank_tpu/pipeline/results.py``; reference online_rca.py:202-214).

The sink appends one JSONL record per window (``windows.jsonl``) plus a
reference-shaped ``result.csv`` (``level,result,rank,confidence``, with a
``window_start`` column unless the compat overwrite quirk is on), in
the JAX package's format.
"""

from __future__ import annotations

import csv
import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple


@dataclass
class WindowResult:
    """Everything the pipeline learned about one detection window."""

    start: str
    end: str
    anomaly: bool
    n_traces: int = 0
    n_normal: int = 0
    n_abnormal: int = 0
    ranking: List[Tuple[str, float]] = field(default_factory=list)
    timings: Dict[str, float] = field(default_factory=dict)
    skipped_reason: Optional[str] = None
    # Device-side convergence trace of the rank program: steps run and
    # the final joint L-inf residual. None when the window wasn't ranked.
    rank_iterations: Optional[int] = None
    rank_residual: Optional[float] = None
    kernel: Optional[str] = None
    # Measured trace-kind dedup factor of the window's graph build.
    kind_dedup: Optional[float] = None

    def apply_convergence(self, conv: Optional[dict]) -> None:
        if conv:
            self.rank_iterations = conv.get("iterations")
            self.rank_residual = conv.get("final_residual")

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["ranking"] = [[n, float(s)] for n, s in self.ranking]
        return json.dumps(d)


class ResultSink:
    """Persists window results: JSONL (always append) + reference-shaped
    CSV."""

    def __init__(self, out_dir, overwrite_csv: bool = False):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.jsonl_path = self.out_dir / "windows.jsonl"
        self.csv_path = self.out_dir / "result.csv"
        self.overwrite_csv = overwrite_csv
        self._csv_initialized = False
        self.results: List[WindowResult] = []

    def emit(self, result: WindowResult) -> None:
        self.results.append(result)
        with open(self.jsonl_path, "a") as f:
            f.write(result.to_json() + "\n")
        if result.anomaly and result.ranking:
            self._write_csv(result)

    def _write_csv(self, result: WindowResult) -> None:
        if self.overwrite_csv:
            with open(self.csv_path, "w", newline="") as f:
                writer = csv.writer(f)
                writer.writerow(["level", "result", "rank", "confidence"])
                for rank, (service, score) in enumerate(result.ranking, 1):
                    writer.writerow(["span", service, rank, float(score)])
            return
        mode = "a" if self._csv_initialized or self.csv_path.exists() else "w"
        with open(self.csv_path, mode, newline="") as f:
            writer = csv.writer(f)
            if mode == "w":
                writer.writerow(
                    ["level", "result", "rank", "confidence", "window_start"]
                )
            for rank, (service, score) in enumerate(result.ranking, 1):
                writer.writerow(
                    ["span", service, rank, float(score), result.start]
                )
        self._csv_initialized = True
