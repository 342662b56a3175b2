"""Per-run JSONL journal: one machine-readable event per window
(counterpart of ``microrank_tpu/obs/journal.py``).

``windows.jsonl`` (pipeline.results) records WHAT was ranked; the
journal records HOW the run behaved: per-window timings, the device
convergence trace, the queue depth at dispatch and a host-contention
sample, so a replay slowed by host load flags itself. Events, with the
JAX package's names and keys:

* ``run_start``: the loop's configuration and a host sample;
* ``window``: one per emitted WindowResult: bounds, outcome, partition
  sizes, timings, rank_iterations / rank_residual, kernel, queue_depth,
  top-1 and a host sample;
* ``run_end``: window totals, a host sample and ``telemetry``, the
  headline fields of the metrics registry
  (``metrics.snapshot_to_result_fields``).

The writer appends under a lock (the async fetch worker and the main
thread may both reach it); every event carries ``ts`` (epoch seconds)
and ``schema``. With ``max_bytes`` (``ObsConfig.journal_max_bytes``,
``cli stream --journal-max-bytes``) the live file rotates into
``journal.jsonl.<n>`` parts as JAX's does: fsync, then the rename, then
a ``journal_rotated`` event opens the fresh file; ``read_journal``
reads the parts in order before the live file.
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Optional

from .host import ContentionSentinel

SCHEMA_VERSION = 1

JOURNAL_NAME = "journal.jsonl"


class RunJournal:
    """Append-only JSONL event writer for one pipeline run."""

    def __init__(self, path, sentinel=None, max_bytes: int = 0):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        # Size-based rotation (ObsConfig.journal_max_bytes): 0 = never.
        self.max_bytes = int(max_bytes or 0)
        self._rotations = len(journal_parts(self.path))
        self.sentinel = ContentionSentinel() if sentinel is None else sentinel

    def emit(self, event: str, **fields) -> None:
        rec = {"event": event, "ts": time.time(),
               "schema": SCHEMA_VERSION, **fields}
        line = json.dumps(rec) + "\n"
        with self._lock:
            self._maybe_rotate(len(line))
            with open(self.path, "a") as f:
                f.write(line)

    def _maybe_rotate(self, incoming: int) -> None:
        """Rotate the live file to ``journal.jsonl.<n>`` when the next
        line would take it past ``max_bytes``: fsync before the rename,
        so a part is durable under its final name (a crash can lose only
        lines still in the live file's page cache). The caller holds the
        lock."""
        if not self.max_bytes:
            return
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return
        if size + incoming <= self.max_bytes:
            return
        try:
            with open(self.path, "a") as f:
                f.flush()
                os.fsync(f.fileno())
            self._rotations += 1
            part = self.path.with_name(f"{self.path.name}.{self._rotations}")
            os.replace(self.path, part)
        except OSError:  # pragma: no cover - exotic filesystems
            return
        rot = {"event": "journal_rotated", "ts": time.time(), "schema": SCHEMA_VERSION,
               "part": part.name, "part_bytes": size, "rotation": self._rotations}
        with open(self.path, "a") as f:
            f.write(json.dumps(rot) + "\n")

    def run_start(self, **config_fields) -> None:
        self.emit("run_start", host=self.sentinel.sample(), **config_fields)

    def window(self, result, queue_depth: Optional[int] = None) -> None:
        """One emitted WindowResult -> one journal event."""
        outcome = (
            "ranked" if result.ranking
            else ("skipped" if result.skipped_reason else "clean")
        )
        self.emit(
            "window",
            start=result.start,
            end=result.end,
            anomaly=bool(result.anomaly),
            outcome=outcome,
            skipped_reason=result.skipped_reason,
            n_traces=result.n_traces,
            n_abnormal=result.n_abnormal,
            timings=result.timings,
            rank_iterations=result.rank_iterations,
            rank_residual=result.rank_residual,
            kernel=result.kernel,
            route=getattr(result, "route", None),
            kind_dedup=result.kind_dedup,
            ingest_rejected=getattr(result, "ingest_rejected", 0),
            degraded_input=bool(
                getattr(result, "degraded_input", False)
            ),
            queue_depth=(
                queue_depth if queue_depth is not None
                else result.queue_depth
            ),
            top1=(result.ranking[0][0] if result.ranking else None),
            host=self.sentinel.sample(),
        )

    def run_end(self, **fields) -> None:
        from .metrics import snapshot_to_result_fields

        self.emit(
            "run_end",
            host=self.sentinel.sample(),
            telemetry=snapshot_to_result_fields(),
            **fields,
        )
        # run_end is the record a post-mortem reads first: force it, and
        # everything before it, to disk.
        self.sync()

    def sync(self) -> None:
        """flush + fsync the journal file."""
        with self._lock:
            if not self.path.exists():
                return
            try:
                with open(self.path, "a") as f:
                    f.flush()
                    os.fsync(f.fileno())
            except OSError:  # pragma: no cover - exotic filesystems
                pass


def journal_parts(path) -> list:
    """A journal's rotated parts (``journal.jsonl.<n>``) in rotation
    order; the live file is not among them."""
    p = Path(path)
    parts = []
    for cand in p.parent.glob(p.name + ".*"):
        suffix = cand.name[len(p.name) + 1:]
        if suffix.isdigit():
            parts.append((int(suffix), cand))
    return [c for _, c in sorted(parts)]


def read_journal(path) -> list:
    """Parse a journal back into event dicts, in the order written: the
    rotated parts, oldest first, then the live file."""
    out = []
    p = Path(path)
    for part in [*journal_parts(p), p]:
        if part.exists():
            out += [json.loads(line) for line in part.read_text().splitlines() if line.strip()]
    return out
