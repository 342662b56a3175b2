"""Dead-letter store for rejected span rows: bounded, never a crash
(counterpart of ``microrank_tpu/ingest/quarantine.py``).

Every row that span admission (``ingest.admit_table``) refuses lands
here as one JSONL record holding the row's content, the rejection
reason (``REASONS``), the lane it came from and where in the source it
sat (``offset``, the row index). The store is bounded: past
``IngestConfig.quarantine_max_bytes`` new records are dropped and
counted (``microrank_ingest_quarantine_dropped_total``), decided line by
line in order, so hostile data cannot fill the disk through the store
that contains it. With no path configured (library use) records are
counted but not written; rejection is never silent either way, because
the per-reason counter fires at the admission seam.

The records, their field order, the byte cap and its decisions are the
JAX package's; a reason's records are written with one ``open`` and one
``writelines`` instead of one of each a row, each line formatted from
its strings.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

log = logging.getLogger("microrank_tpu_torch.ingest")

QUARANTINE_NAME = "quarantine.jsonl"

#: The rejection-reason taxonomy, the JAX package's strings. Every
#: quarantined row names exactly one of these.
REASONS = (
    "bad_timestamp",      # start/end would not coerce to a datetime
    "bad_duration",       # duration non-numeric or negative
    "duration_overflow",  # duration past IngestConfig.max_duration_us
    "missing_id",         # empty/null traceID or spanID
    "dup_span",           # duplicate (traceID, spanID) — first kept
    "orphan",             # parent span absent (orphan_policy="drop")
    "clock_skew",         # start beyond skew_reject_seconds of the window
    "trace_too_long",     # spans past max_spans_per_trace (truncated)
    "vocab_budget",       # op past max_ops_per_window (cardinality bomb)
    "unparseable_line",   # tail line that never parsed (byte offset kept)
    "low_admission",      # whole window below min_admission_ratio
)


class QuarantineStore:
    """Bounded JSONL dead-letter writer (thread-safe: one lock around
    the byte count and the counters)."""

    def __init__(self, path=None, max_bytes: int = 16 << 20):
        self.path = Path(path) if path is not None else None
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self.records = 0
        self.dropped = 0
        self._bytes = 0
        if self.path is not None and self.path.exists():
            self._bytes = self.path.stat().st_size

    def put_raw(self, payload, reason: str, source: str = "",
                offset: Optional[int] = None) -> int:
        """Quarantine one raw row, with the offset it occupied in its
        source. Returns the records written (0 or 1)."""
        return self.put_raws([payload], reason, source,
                             None if offset is None else [offset])

    def put_raws(self, payloads: Sequence, reason: str, source: str = "",
                 offsets: Optional[Sequence[int]] = None) -> int:
        """``put_raw`` of many rows of one reason, in order: the same
        records and the same keep-or-drop decisions as one call a row,
        written with one open. Each line is the JAX package's
        ``json.dumps`` of its record ({reason, source, ts, row: {raw},
        offset}, in that order), put together from its encoded strings:
        a rejected row costs a few microseconds, not a dict and an
        encoder pass. Returns the records written."""
        head = f'{{"reason": {json.dumps(reason)}, "source": {json.dumps(source)}, "ts": '
        lines = []
        for i, payload in enumerate(payloads):
            if isinstance(payload, bytes):
                payload = payload.decode("utf-8", errors="replace")
            raw = json.dumps(payload.rstrip("\n"))
            tail = "}" if offsets is None else f', "offset": {int(offsets[i])}}}'
            lines.append(f'{head}{time.time()!r}, "row": {{"raw": {raw}}}{tail}\n')
        return self._write(lines)

    def _write(self, lines) -> int:
        """Keep each JSONL line, in order, while the byte cap holds (a
        store without a path only counts them); append the kept ones in
        one write and count the dropped ones."""
        if not lines:
            return 0
        kept = []
        with self._lock:
            if self.path is None:
                # Unconfigured (library use): count only, no cap — the
                # records exist nowhere, so there is nothing to bound.
                self.records += len(lines)
                return len(lines)
            for line in lines:
                if self._bytes + len(line) > self.max_bytes:
                    self.dropped += 1
                    continue
                self._bytes += len(line)
                self.records += 1
                kept.append(line)
            dropped_now = len(lines) - len(kept)
        if kept:
            try:
                self.path.parent.mkdir(parents=True, exist_ok=True)
                with open(self.path, "a") as f:
                    f.writelines(kept)
            except OSError as e:  # disk trouble must not turn a rejection into a crash
                log.warning("quarantine write failed: %s", e)
        if dropped_now:
            from ..obs.metrics import record_quarantine_dropped

            record_quarantine_dropped(dropped_now)
            log.warning("quarantine full (%d bytes cap): dropped %d record(s)",
                        self.max_bytes, dropped_now)
        return len(kept)


_store: Optional[QuarantineStore] = None


def configure_quarantine(ingest_config, default_dir=None) -> QuarantineStore:
    """Install the process dead-letter store (each run entry calls this
    with its out_dir). ``IngestConfig.quarantine_dir`` overrides the run
    dir; neither set gives a counting-only store."""
    global _store
    qdir = getattr(ingest_config, "quarantine_dir", None) or default_dir
    path = Path(qdir) / QUARANTINE_NAME if qdir is not None else None
    max_bytes = getattr(ingest_config, "quarantine_max_bytes", 16 << 20)
    _store = QuarantineStore(path, max_bytes=max_bytes)
    return _store


def get_quarantine() -> QuarantineStore:
    """The process store; a counting-only one when none was configured
    (rejection must never crash or silently vanish)."""
    global _store
    if _store is None:
        _store = QuarantineStore(None)
    return _store
