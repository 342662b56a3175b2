"""Span sources for the streaming engine (counterpart of
``microrank_tpu/stream/sources.py``): each yields ``SpanBatch`` tables in
event-time order, with pacing.

* ``ReplaySource`` — a traces CSV (the C++ loader), a warehouse's
  stored span tables (``warehouse.load_warehouse_table``: no parse) or
  a ``SpanTable`` replayed in chunks of ``chunk_spans`` rows of its
  stable start-time order, slept between (fixed ``pace_seconds``, or
  event-time faithful at ``rate`` x real time).
* ``SyntheticSource`` — the port's timeline generator
  (``testing.generate_timeline``, the latency family) as a paced
  stream, the timeline built straight into a table
  (``testing.synthetic.spans_table``, what the loader reads from its
  CSV); exposes the ground truth and the baseline-seeding normal table.
* ``FileTailSource`` — tail a growing traces CSV, yielding only the rows
  appended since the last poll (``pipeline.follow.TailTracker``'s
  byte-offset ``read_appended``): torn final lines parse as a failure
  this poll and as data the next; rotation re-reads from scratch;
  ``idle_exit`` bounds consecutive no-progress polls; a slice that fails
  ``parse_retry_max`` times is re-parsed line by line and its poison
  lines dead-lettered. Each slice is parsed on its own, so a span whose
  parent was appended in an earlier slice has no parent row.

Resumable, as JAX's: each source's cursor rides the engine checkpoint
(``checkpoint_state`` / ``restore_state``; ``reset_cursor`` drops a
stashed one when the checkpoint is rejected whole). Chaos seams:
``source_stall`` (an extra stall), ``source_torn`` (a torn tail line:
the parse fails this poll, the data arrives whole the next) and
``source_rotation`` (a forced cursor reset). JAX's ``source_data``
seam (corrupted chunks) is not ported (ROADMAP.md, port queue item 9).
"""

from __future__ import annotations

import logging
import os
import tempfile
import time
from pathlib import Path
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np

from ..native import SpanTable, load_span_table, sort_table_by_time
from .window import SpanBatch

log = logging.getLogger("microrank_tpu_torch.stream.sources")


def table_rows(table: SpanTable, lo: int, hi: int) -> SpanTable:
    """Rows [lo, hi) of ``table`` as a table sharing its vocabularies;
    ``parent_row`` keeps the table's row ids (a batch's source ids)."""
    return table._replace(
        trace_id=table.trace_id[lo:hi], svc_op=table.svc_op[lo:hi],
        pod_op=table.pod_op[lo:hi], duration_us=table.duration_us[lo:hi],
        start_us=table.start_us[lo:hi], end_us=table.end_us[lo:hi],
        parent_row=table.parent_row[lo:hi],
    )


def _load_bytes(payload: bytes) -> SpanTable:
    """A CSV payload through the C++ loader (which reads a path)."""
    fd, name = tempfile.mkstemp(suffix=".csv", prefix="mr-tail-")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
        return load_span_table(name, cache=False)
    finally:
        os.unlink(name)


def load_table(path) -> SpanTable:
    """A traces CSV through the C++ loader, or a warehouse directory's
    stored span tables (no parse)."""
    if _is_warehouse_dir(path):
        from ..warehouse import load_warehouse_table

        return load_warehouse_table(path)
    return load_span_table(path, cache=False)


def _is_warehouse_dir(path) -> bool:
    """A directory holding (or containing) sealed warehouse segments:
    ReplaySource takes it wherever it takes a traces CSV."""
    try:
        p = Path(path)
    except TypeError:
        return False
    if not p.is_dir():
        return False
    from ..warehouse import MANIFEST_NAME, WAREHOUSE_DIR

    return ((p / MANIFEST_NAME).exists() or (p / WAREHOUSE_DIR / MANIFEST_NAME).exists()
            or any(p.glob("seg-*.npz")) or any(p.glob("cold-*.npz")))


class ReplaySource:
    """Replay a staged traces CSV, a warehouse directory or an in-memory
    ``SpanTable`` with pacing, in chunks of its stable start-time order.

    Resumable: the cursor is the count of rows already yielded in that
    order (a pure function of the data, so a restarted replay re-sorts
    identically); ``restore_state`` makes the next iteration skip them.
    """

    def __init__(
        self,
        path_or_table,
        chunk_spans: int = 5000,
        pace_seconds: float = 0.0,
        rate: Optional[float] = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        table = path_or_table if isinstance(path_or_table, SpanTable) else load_table(
            path_or_table)
        self.table = sort_table_by_time(table)
        self.chunk_spans = int(chunk_spans)
        self.pace_seconds = float(pace_seconds)
        self.rate = rate
        self.sleep = sleep
        self.sleeps: List[float] = []   # what pacing did (tests)
        self.rows_emitted = 0
        self._skip_rows = 0

    # ------------------------------------------------------- durability
    def checkpoint_state(self) -> dict:
        return {"type": "replay", "row": int(self.rows_emitted)}

    def restore_state(self, state: dict) -> None:
        if state.get("type") != "replay":
            raise ValueError(f"not a replay cursor: {state}")
        self._skip_rows = max(0, int(state.get("row", 0)))

    def reset_cursor(self) -> None:
        """Drop a stashed resume cursor (whole-checkpoint rejection)."""
        self._skip_rows = 0

    def __iter__(self) -> Iterator[SpanBatch]:
        from ..chaos.faults import maybe_inject

        t = self.table
        step = max(1, self.chunk_spans)
        skip = min(self._skip_rows, t.n_spans)
        if skip:
            # Rows before the cursor were windowed already (and live on in
            # the checkpointed windower buffers).
            log.info("replay resume: skipping %d already-emitted rows", skip)
        bounds = list(range(skip, t.n_spans, step))
        self.rows_emitted = skip
        for i, lo in enumerate(bounds):
            hi = min(lo + step, t.n_spans)
            # The cursor covers the chunk before the yield: the engine may
            # checkpoint while this generator is suspended here.
            self.rows_emitted = hi
            yield SpanBatch(table_rows(t, lo, hi), lo)
            if i == len(bounds) - 1:
                break
            maybe_inject("source_stall", sleep=self.sleep)
            if self.rate:
                # Event-time faithful: the gap to the next chunk,
                # compressed by ``rate``.
                gap_s = (int(t.start_us[hi]) - int(t.start_us[hi - 1])) / 1e6
                delay = max(0.0, gap_s / float(self.rate))
            else:
                delay = self.pace_seconds
            if delay > 0:
                self.sleeps.append(delay)
                self.sleep(delay)


class SyntheticSource:
    """Paced synthetic timeline with injected fault windows (the port's
    generator: latency faults only; JAX's error, cascade and drift
    families come with the scenario slice, ROADMAP.md item 11)."""

    def __init__(
        self,
        n_windows: int,
        faulted: Sequence[int],
        synth_config=None,
        chunk_spans: int = 4000,
        pace_seconds: float = 0.0,
        sleep: Callable[[float], None] = time.sleep,
        spans_per_window: Optional[int] = None,
    ):
        from ..testing import SyntheticConfig, generate_timeline, generate_timeline_with_spans
        from ..testing.synthetic import spans_table

        cfg = synth_config or SyntheticConfig()
        if spans_per_window:
            tl = generate_timeline_with_spans(cfg, int(spans_per_window), int(n_windows),
                                              list(faulted))
        else:
            tl = generate_timeline(cfg, int(n_windows), list(faulted))
        self.timeline = tl
        self.normal = spans_table(tl.normal, tl.n_operations)   # baseline seed
        self.fault_pod_op = tl.fault_pod_op
        self.fault_pod_ops = list(tl.fault_pod_ops)
        self.window_faulted = tl.window_faulted
        self._replay = ReplaySource(spans_table(tl.windows, tl.n_operations),
                                    chunk_spans=chunk_spans, pace_seconds=pace_seconds,
                                    sleep=sleep)

    @property
    def table(self) -> SpanTable:
        """The whole timeline as one time-sorted table."""
        return self._replay.table

    def __iter__(self) -> Iterator[SpanBatch]:
        return iter(self._replay)

    # Resumable: the timeline is a pure function of the seed, so the
    # inner replay cursor restores a restarted run exactly.
    def checkpoint_state(self) -> dict:
        return self._replay.checkpoint_state()

    def restore_state(self, state: dict) -> None:
        self._replay.restore_state(state)

    def reset_cursor(self) -> None:
        self._replay.reset_cursor()


class FileTailSource:
    """Tail a growing traces CSV; yield only the newly appended rows.

    Resumable: the cursor is the tail's byte offset, a rotation
    signature (the header line's hash) and the source rows yielded so
    far (the batches' row ids); a restart restores the offset only when
    the signature still matches the file, else it re-reads from scratch
    (the restored windower drops what it already emitted).
    """

    def __init__(
        self,
        path,
        poll_seconds: float = 2.0,
        idle_exit: int = 0,
        max_polls: int = 0,
        sleep: Callable[[float], None] = time.sleep,
        parse_retry_max: int = 3,
    ):
        self.path = Path(path)
        self.poll_seconds = float(poll_seconds)
        self.idle_exit = int(idle_exit)
        self.max_polls = int(max_polls)
        self.sleep = sleep
        # After this many consecutive failed parses of the same slice,
        # it re-parses line by line and the poison lines are
        # dead-lettered with their byte offsets (0 disables).
        self.parse_retry_max = int(parse_retry_max)
        self._parse_fails = 0
        self._rows = 0   # source rows yielded so far (batch row ids)
        self._stopped = False
        self._tracker = None
        self._restore: Optional[dict] = None

    # ------------------------------------------------------- durability
    def _signature(self) -> Optional[str]:
        import hashlib

        try:
            with open(self.path, "rb") as f:
                header = f.readline()
        except OSError:
            return None
        return hashlib.sha256(header).hexdigest() if header else None

    def checkpoint_state(self) -> dict:
        t = self._tracker
        if t is None or t.parsed_offset <= 0:
            return {"type": "tail", "offset": 0, "rows": int(self._rows)}
        return {"type": "tail", "offset": int(t.parsed_offset), "size": int(t.last_size),
                "signature": self._signature(), "rows": int(self._rows)}

    def restore_state(self, state: dict) -> None:
        if state.get("type") != "tail":
            raise ValueError(f"not a tail cursor: {state}")
        self._restore = dict(state)

    def reset_cursor(self) -> None:
        """Drop a stashed resume cursor (whole-checkpoint rejection)."""
        self._restore = None

    def _tracker_for_run(self):
        from ..pipeline.follow import TailTracker

        tracker = TailTracker(idle_exit=self.idle_exit)
        st = self._restore
        if st:
            # Row ids continue past what the checkpointed run yielded.
            self._rows = int(st.get("rows", 0))
        if st and st.get("offset", 0) > 0:
            sig = self._signature()
            if sig is not None and sig == st.get("signature"):
                with open(self.path, "rb") as f:
                    header = f.readline()
                tracker.restore_cursor(offset=int(st["offset"]),
                                       size=int(st.get("size", st["offset"])), header=header)
                log.info("tail resume: cursor restored at byte %d of %s",
                         tracker.parsed_offset, self.path)
            else:
                log.warning("tail resume: %s rotated since the checkpoint (signature "
                            "mismatch); re-reading from scratch", self.path)
        return tracker

    def stop(self) -> None:
        """End the tail at its next poll (a co-deployed engine's drain)."""
        self._stopped = True

    def _batch(self, table: SpanTable) -> SpanBatch:
        table = table._replace(parent_row=np.where(
            table.parent_row >= 0, table.parent_row + self._rows, -1).astype(np.int64))
        batch = SpanBatch(table, self._rows)
        self._rows += table.n_spans
        return batch

    def _salvage(self, tracker, size: int) -> Optional[List[SpanTable]]:
        """Per-line re-parse of a slice that exhausted its retries: each
        complete appended line parses alone (header prepended); lines
        that still fail are dead-lettered (``unparseable_line``, their
        absolute byte offset). The cursor then advances past the slice.
        Returns the good tables, or None when there was nothing to
        salvage (a torn partial line: keep holding)."""
        from ..ingest.quarantine import get_quarantine
        from ..obs.metrics import record_ingest_rejected

        appended = tracker.read_appended(self.path, size)
        if appended is None:
            return None
        payload, offset = appended
        head_end = payload.find(b"\n")
        if head_end < 0:
            return None
        header, body = payload[: head_end + 1], payload[head_end + 1:]
        if not body:
            return None
        base = offset - len(body)
        good, bad, pos = [], [], 0
        for line in body.splitlines(keepends=True):
            abs_off = base + pos
            pos += len(line)
            try:
                t = _load_bytes(header + line)
            except (ValueError, OSError):
                bad.append((line, abs_off))
                continue
            if t.n_spans:
                good.append(t)
        store = get_quarantine()
        for line, abs_off in bad:
            store.put_raw(line, "unparseable_line", source=f"tail:{self.path}", offset=abs_off)
            record_ingest_rejected("unparseable_line")
        if bad:
            log.warning("tail %s: dead-lettered %d unparseable line(s) after %d whole-slice "
                        "retries; cursor advanced to byte %d", self.path, len(bad),
                        self._parse_fails, offset)
        tracker.parsed(size, offset=offset)
        return good

    def __iter__(self) -> Iterator[SpanBatch]:
        from ..chaos.faults import InjectedFault, maybe_inject
        from ..chaos.retry import record_attempt

        tracker = self._tracker = self._tracker_for_run()
        polls = 0
        while not self._stopped:
            polls += 1
            maybe_inject("source_stall", sleep=self.sleep)
            if maybe_inject("source_rotation") is not None:
                # As a real size shrink resets it: a full re-read next.
                tracker.force_rotation()
            size = os.path.getsize(self.path) if self.path.exists() else -1
            status = tracker.observe_size(size)
            if status != "grew":
                if status == "exit":
                    log.info("tail: no progress for %d polls; done", tracker.idle)
                    return
                if self.max_polls and polls >= self.max_polls:
                    return
                self.sleep(self.poll_seconds)
                continue
            try:
                if maybe_inject("source_torn") is not None:
                    raise InjectedFault("source_torn", "torn_line")
                appended = tracker.read_appended(self.path, size)
                if appended is None:
                    # Only a torn partial line so far: no progress.
                    if self.max_polls and polls >= self.max_polls:
                        return
                    self.sleep(self.poll_seconds)
                    continue
                payload, offset = appended
                table = _load_bytes(payload)
            except (ValueError, OSError, InjectedFault) as exc:
                # The re-read is a retry in the one accounting.
                record_attempt("source_parse")
                self._parse_fails += 1
                if self.parse_retry_max and self._parse_fails >= self.parse_retry_max:
                    salvaged = self._salvage(tracker, size)
                    if salvaged is not None:
                        self._parse_fails = 0
                        for t in salvaged:
                            yield self._batch(t)
                        if self.max_polls and polls >= self.max_polls:
                            return
                        self.sleep(self.poll_seconds)
                        continue
                if tracker.parse_failed(exc) == "exit":
                    return
                if self.max_polls and polls >= self.max_polls:
                    return
                self.sleep(self.poll_seconds)
                continue
            self._parse_fails = 0
            tracker.parsed(size, offset=offset)
            if table.n_spans:
                yield self._batch(table)
            if self.max_polls and polls >= self.max_polls:
                return
            self.sleep(self.poll_seconds)
