"""Follow / tail mode: rank the windows of a GROWING trace dump as they
close (counterpart of ``microrank_tpu/pipeline/follow.py``).

A collector appends spans to a CSV; ``follow_table`` polls the file,
ingests what is new, and ranks every detection window that has closed
since the last poll, emitting results incrementally through the normal
sink.

Closure rule: a window [w0, w1) is ranked only once the ingest horizon
(the newest span START seen, minus ``grace_us`` for stragglers) passes
w1: ``TableRCA.run(end_us=horizon, complete_only=True)``. The window
cursor (pipeline.checkpoint) keeps the NEXT window start across polls
and process restarts, so a crashed follower resumes exactly where it
stopped, with batch resume's at-least-once semantics.

Ingest cost per poll: ``load_span_table`` re-parses the grown file with
the sidecar cache OFF. A write racing the parse could pin a sidecar
whose recorded (mtime, size) matches the appended file but whose
content predates the append, dropping the tail for good; and rewriting
a full-table .npz every poll would be a second O(file) cost. The full
re-parse is needed here (the window cursor re-ranks windows whose spans
straddle polls, so the whole table must exist). ``TailTracker`` also
keeps the byte-offset cursor (``read_appended``) that the stream lane's
tail (``stream.sources.FileTailSource``) uses to feed its parser only the
appended lines; this loop does not call it.
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path
from typing import Callable, Iterator, List, Optional

from ..obs.metrics import follow_parse_failures, follow_polls, follow_rotations
from .results import WindowResult

log = logging.getLogger("microrank_tpu_torch.pipeline.follow")


class TailTracker:
    """Tail-poll bookkeeping, the one source of truth for the tail rules
    (the follow loop below and the stream lane's ``FileTailSource``):

    * growth detection (``size == last`` counts idle);
    * rotation/truncation (``size < last``): counted
      (``follow_rotations``), ``rotated`` flagged so callers reset
      their cursors, and the file re-reads from scratch — including the
      incremental byte cursor below;
    * parse failures (torn final line): counted
      (``follow_parse_failures``) AND counted toward ``idle_exit`` — a
      permanently corrupt tail must not starve the exit condition;
    * ``idle_exit`` consecutive no-progress polls stop the loop
      (0 = follow forever);
    * **byte-offset incremental parse**: ``read_appended``
      remembers the last byte offset handed to the CSV parser and
      returns only the header plus the complete lines appended since —
      each poll costs O(appended), not O(file). Rotation/truncation
      resets the cursor, so those polls still fall back to a full
      re-parse.
    """

    def __init__(self, idle_exit: int = 0):
        self.idle_exit = int(idle_exit)
        self.last_size = -1
        self.idle = 0
        self.rotated = False
        # Incremental-parse cursor: absolute byte offset already fed to
        # the parser (0 = nothing, header included), plus the cached
        # header line prepended to each appended slice.
        self.parsed_offset = 0
        self._header: Optional[bytes] = None
        self.bytes_parsed = 0   # cumulative bytes handed to the parser

    def _idle_tick(self) -> str:
        self.idle += 1
        if self.idle_exit and self.idle >= self.idle_exit:
            return "exit"
        return "idle"

    def observe_size(self, size: int) -> str:
        """Classify one poll's file size: "grew" | "idle" | "exit"."""
        follow_polls().inc()
        self.rotated = False
        if 0 <= size < self.last_size:
            log.warning(
                "follow: file shrank %d -> %d bytes "
                "(rotation/truncation); re-reading", self.last_size, size,
            )
            follow_rotations().inc()
            self.last_size = -1
            self.rotated = True
            # Incremental cursor falls back to a full re-parse.
            self.parsed_offset = 0
            self._header = None
        if size == self.last_size or size < 0:
            return self._idle_tick()
        return "grew"

    def parse_failed(self, exc) -> str:
        """One failed ingest parse: "retry" | "exit". ``last_size``
        stays unchanged so the next poll re-reads even without
        further growth."""
        log.warning("follow: ingest failed (%s); retrying", exc)
        follow_parse_failures().inc()
        return "exit" if self._idle_tick() == "exit" else "retry"

    def parsed(self, size: int, offset: Optional[int] = None) -> None:
        """One successful parse at ``size`` bytes resets the idle run;
        ``offset`` (incremental mode) advances the byte cursor to the
        end of the last line actually parsed."""
        self.idle = 0
        self.last_size = size
        if offset is not None:
            self.parsed_offset = int(offset)

    def read_appended(self, path, size: int):
        """Incremental slice for the CSV parser: ``(payload, offset)``
        where ``payload`` is the header line plus every COMPLETE line
        appended since ``parsed_offset`` and ``offset`` is the absolute
        byte position the cursor should advance to once the parse
        succeeds (pass it to :meth:`parsed`). Returns ``None`` when
        only a torn partial line has been appended — the caller should
        treat the poll as no-progress and retry; the cursor does not
        move, so the bytes re-read next poll. A parse FAILURE likewise
        leaves the cursor in place (``parse_failed`` semantics are
        unchanged), re-feeding the same slice until it parses or
        idle_exit fires."""
        with open(path, "rb") as f:
            if self.parsed_offset <= 0:
                # Full (re-)read: the header is the first line.
                chunk = f.read(size)
                cut = chunk.rfind(b"\n")
                if cut < 0:
                    return None
                head_end = chunk.find(b"\n")
                self._header = chunk[: head_end + 1]
                payload = chunk[: cut + 1]
                self.bytes_parsed += len(payload)
                return payload, cut + 1
            f.seek(self.parsed_offset)
            chunk = f.read(max(0, size - self.parsed_offset))
        cut = chunk.rfind(b"\n")
        if cut < 0 or self._header is None:
            return None
        payload = self._header + chunk[: cut + 1]
        self.bytes_parsed += len(payload)
        return payload, self.parsed_offset + cut + 1


def follow_table(
    rca,
    path,
    out_dir,
    poll_seconds: float = 5.0,
    grace_us: int = 0,
    idle_exit: int = 0,
    max_polls: int = 0,
    sleep: Callable[[float], None] = time.sleep,
) -> Iterator[List[WindowResult]]:
    """Tail ``path`` (a growing traces CSV) and yield each poll's NEWLY
    ranked window results.

    ``rca`` is a fitted TableRCA (``fit_baseline`` already called);
    ``out_dir`` is REQUIRED — the window cursor lives there and is what
    makes polls (and restarts) incremental. ``idle_exit`` > 0 stops
    after that many consecutive polls without PROGRESS — no file growth
    OR a failed ingest parse both count (a permanently torn or corrupt
    tail would otherwise retry forever without counting as idle). File
    rotation/truncation (``size <
    last_size``) is detected, counted (``follow_rotations``) and
    re-read from scratch. (0 = follow forever); ``max_polls`` bounds
    total polls (0 = unbounded). ``sleep`` is injectable for tests.
    """
    from ..native import load_span_table

    if out_dir is None:
        raise ValueError(
            "follow mode needs out_dir: the window cursor there is "
            "what makes polls incremental"
        )
    path = Path(path)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tracker = TailTracker(idle_exit=idle_exit)
    polls = 0
    while True:
        polls += 1
        size = os.path.getsize(path) if path.exists() else -1
        # Rotation note: the tracker re-reads from scratch; the window
        # cursor still guards against re-RANKING old windows, so a
        # rotated-in file that restarts the timeline simply yields
        # nothing new until it passes the cursor again.
        status = tracker.observe_size(size)
        if status != "grew":
            if status == "exit":
                log.info(
                    "follow: no progress for %d polls; exiting",
                    tracker.idle,
                )
                return
            if max_polls and polls >= max_polls:
                return
            sleep(poll_seconds)
            continue
        try:
            table = load_span_table(path, cache=False)
        except (ValueError, OSError) as exc:
            # A torn final line (the collector flushed mid-row) parses
            # as an error THIS poll and as valid data the next — retry,
            # with the failure counting toward idle_exit (tracker).
            if tracker.parse_failed(exc) == "exit":
                log.info(
                    "follow: %d polls without progress (last: parse "
                    "failure); exiting", tracker.idle,
                )
                return
            if max_polls and polls >= max_polls:
                return
            sleep(poll_seconds)
            continue
        tracker.parsed(size)
        if table.n_spans == 0:
            if max_polls and polls >= max_polls:
                return
            sleep(poll_seconds)
            continue
        horizon = int(table.start_us.max()) - int(grace_us)
        new = rca.run(
            table,
            out_dir=out_dir,
            resume=True,
            end_us=horizon,
            complete_only=True,
        )
        emitted = [r for r in new if r.ranking]
        log.info(
            "follow poll %d: %d bytes, horizon %s, %d windows scanned, "
            "%d ranked",
            polls, size, horizon, len(new), len(emitted),
        )
        yield new
        if max_polls and polls >= max_polls:
            return
        sleep(poll_seconds)


def run_follow(
    rca,
    path,
    out_dir,
    poll_seconds: float = 5.0,
    grace_us: int = 0,
    idle_exit: int = 0,
    max_polls: int = 0,
    on_results: Optional[Callable[[List[WindowResult]], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> int:
    """Drive follow_table to completion (the CLI entry): returns the
    total number of ranked windows. ``sleep`` is follow_table's."""
    ranked = 0
    for batch in follow_table(
        rca, path, out_dir,
        poll_seconds=poll_seconds,
        grace_us=grace_us,
        idle_exit=idle_exit,
        max_polls=max_polls,
        sleep=sleep,
    ):
        if on_results is not None:
            on_results(batch)
        ranked += sum(1 for r in batch if r.ranking)
    return ranked
