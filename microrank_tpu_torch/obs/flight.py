"""Flight recorder: dump the span ring when something goes wrong
(counterpart of ``microrank_tpu/obs/flight.py``). Its triggers, JAX's:
``incident`` (the stream engine, a new incident), ``degraded`` (serve's
batcher, a dispatch that failed twice and answered from the numpy
oracle) and ``sigterm`` (serve's drain at shutdown).

A dump is one directory under ``out_dir/flight/``, JAX's layout:

* ``trace.json``    — Chrome / Perfetto trace-event JSON (threads are
  tracks, spans are slices);
* ``spans.csv``     — the same spans in MicroRank's own input schema
  (stage name -> operationName, subsystem -> serviceName / podName,
  trace context -> traceID / spanID / ParentSpanId), so ``cli run``
  over a healthy dump and this one ranks the pipeline's own slowest
  stage;
* ``events.jsonl``  — the journal events in the ring's time range (the
  journal is fsync'd first);
* ``metrics.json`` / ``metrics.prom`` — the registry snapshot;
* ``manifest.json`` — reason, time range, span and trace counts, drops
  (the stream engine adds ``explain_bundle`` when it writes the
  incident's bundle into the dump).

Dumps are rate-limited (``ObsConfig.flight_min_interval_seconds``); a
suppressed dump is counted.
"""

from __future__ import annotations

import csv
import json
import logging
import threading
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from .spans import Span, get_tracer

log = logging.getLogger("microrank_tpu_torch.obs.flight")

FLIGHT_DIR = "flight"
SPAN_COLUMNS = ["traceID", "spanID", "ParentSpanId", "operationName", "serviceName", "podName",
                "duration", "startTime", "endTime"]


def _iso_us(us: int) -> str:
    return str(np.datetime64(int(us), "us"))


def spans_to_rows(spans: List[Span]) -> List[dict]:
    """Ring spans as rows of the canonical span schema: ``startTime`` /
    ``endTime`` the trace's bounds over the dump (the loader's contract),
    ``duration`` the span's own (µs), ``podName`` the subsystem."""
    bounds = {}
    for s in spans:
        lo, hi = bounds.get(s.trace_id, (s.start_us, s.start_us + s.dur_us))
        bounds[s.trace_id] = (min(lo, s.start_us), max(hi, s.start_us + s.dur_us))
    rows = []
    for s in spans:
        lo, hi = bounds[s.trace_id]
        rows.append({
            "traceID": s.trace_id,
            "spanID": s.span_id,
            "ParentSpanId": s.parent_id or "",
            "operationName": s.name,
            "serviceName": s.service,
            "podName": s.service,
            "duration": int(s.dur_us),
            "startTime": _iso_us(lo),
            "endTime": _iso_us(hi),
        })
    return rows


def write_spans_csv(spans: List[Span], path) -> None:
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=SPAN_COLUMNS)
        w.writeheader()
        for row in spans_to_rows(spans):
            w.writerow(row)


def chrome_events(spans: List[Span]) -> List[dict]:
    """Chrome trace events of one process's spans ("X" complete events;
    one tid a recording thread, named by "M" metadata)."""
    pid = 1
    tids: dict = {}
    events = []
    for s in spans:
        tid = tids.setdefault(s.thread, len(tids) + 1)
        events.append({
            "name": s.name, "cat": s.service, "ph": "X", "ts": s.start_us,
            "dur": max(1, s.dur_us), "pid": pid, "tid": tid,
            "args": {"trace_id": s.trace_id, "span_id": s.span_id, "parent_id": s.parent_id,
                     **s.attrs},
        })
    meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid, "args": {"name": thread}}
            for thread, tid in tids.items()]
    return meta + events


def write_chrome_trace(spans: List[Span], path) -> None:
    Path(path).write_text(json.dumps({"traceEvents": chrome_events(spans),
                                      "displayTimeUnit": "ms"}))


class FlightRecorder:
    """Owns the dump directory, the rate limit and the journal handle to
    fsync and correlate. One a run (the stream engine's) or a service
    (serve's)."""

    def __init__(self, out_dir, obs_config, journal=None):
        self.base = Path(out_dir) / FLIGHT_DIR
        self.cfg = obs_config
        self.journal = journal
        self._lock = threading.Lock()
        self._last_mono: Optional[float] = None
        self.dumps = 0

    def dump(self, reason: str) -> Optional[Path]:
        """Write one flight dump; returns its directory, or None when the
        recorder is off or the rate limit suppressed it."""
        from .metrics import ensure_catalog, record_flight_dump
        from .registry import get_registry

        if not self.cfg.flight:
            return None
        with self._lock:
            now = time.monotonic()
            if (self._last_mono is not None and now - self._last_mono
                    < max(0.0, float(self.cfg.flight_min_interval_seconds))):
                record_flight_dump("suppressed")
                return None
            self._last_mono = now
            self.dumps += 1
            stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
            dump_dir = self.base / f"{stamp}-{self.dumps:02d}-{reason}"
        dump_dir.mkdir(parents=True, exist_ok=True)
        tracer = get_tracer()
        spans = tracer.snapshot()
        write_spans_csv(spans, dump_dir / "spans.csv")
        write_chrome_trace(spans, dump_dir / "trace.json")
        n_events = self._dump_journal(spans, dump_dir)
        ensure_catalog()
        get_registry().write_snapshot(dump_dir)
        t_lo = min((s.start_us for s in spans), default=0)
        t_hi = max((s.start_us + s.dur_us for s in spans), default=0)
        (dump_dir / "manifest.json").write_text(json.dumps({
            "reason": reason,
            "ts": time.time(),
            "spans": len(spans),
            "traces": len({s.trace_id for s in spans}),
            "spans_dropped": tracer.dropped,
            "ring_capacity": tracer.capacity,
            "t_min_us": t_lo,
            "t_max_us": t_hi,
            "journal_events": n_events,
        }, indent=2))
        record_flight_dump(reason)
        log.info("flight dump (%s): %d spans / %d traces -> %s", reason, len(spans),
                 len({s.trace_id for s in spans}), dump_dir)
        return dump_dir

    def _dump_journal(self, spans: List[Span], dump_dir: Path) -> int:
        """fsync the run journal, then copy the events in the ring's time
        range (2 s of slack either side) next to the spans."""
        if self.journal is None:
            return 0
        from .journal import read_journal

        self.journal.sync()
        if not spans:
            return 0
        t_lo = min(s.start_us for s in spans) / 1e6 - 2.0
        t_hi = max(s.start_us + s.dur_us for s in spans) / 1e6 + 2.0
        events = [e for e in read_journal(self.journal.path)
                  if t_lo <= float(e.get("ts", 0.0)) <= t_hi]
        with open(dump_dir / "events.jsonl", "w") as f:
            for e in events:
                f.write(json.dumps(e) + "\n")
        return len(events)
