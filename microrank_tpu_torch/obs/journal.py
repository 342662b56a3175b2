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
* ``run_end``: window totals. The JAX package adds a ``telemetry``
  snapshot of its metrics registry here; the registry is not ported
  (ROADMAP.md 'Port queue' item 5), so the key is absent.

The writer appends under a lock (the async fetch worker and the main
thread may both reach it); every event carries ``ts`` (epoch seconds)
and ``schema``. The JAX package's size-based rotation into
``journal.jsonl.<n>`` parts serves its stream engine, which is not
ported; a run here writes one file.
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

    def __init__(self, path, sentinel=None):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        self.sentinel = ContentionSentinel() if sentinel is None else sentinel

    def emit(self, event: str, **fields) -> None:
        rec = {"event": event, "ts": time.time(),
               "schema": SCHEMA_VERSION, **fields}
        line = json.dumps(rec) + "\n"
        with self._lock:
            with open(self.path, "a") as f:
                f.write(line)

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
        self.emit("run_end", host=self.sentinel.sample(), **fields)
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


def read_journal(path) -> list:
    """Parse a journal back into event dicts, in the order written."""
    p = Path(path)
    if not p.exists():
        return []
    return [json.loads(line) for line in p.read_text().splitlines() if line.strip()]
