"""Event-time windower with watermarks over span-table batches
(counterpart of ``microrank_tpu/stream/window.py``).

The engine tracks the maximum span start time it has seen, subtracts an
allowed-lateness bound, and closes every window whose end precedes that
watermark. Spans arriving inside the bound still land in their (earlier)
window; spans older than every window they belong to are dropped and
counted (``microrank_stream_late_spans_total``). Windows are tumbling
(slide == width) or sliding (slide < width: a span lands in
ceil(width / slide) windows), closed in start order, empty ones
included. JAX's rules, line for line; event time is a span's
``start_us``.

A batch is a ``SpanBatch``: a ``SpanTable`` whose rows carry source row
ids (``first_row + i``) and whose ``parent_row`` holds source row ids.
A closed window is a ``SpanTable`` of its rows (``window_table``): its
ops interned in sorted name order (as JAX's window build interns them:
exact score ties break by that index, and the warm start maps the op
axis by name), its traces in first-appearance order, each parent row
re-based onto the window (a parent outside the window: -1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..native import SpanTable


class SpanBatch(NamedTuple):
    """One source batch: rows ``first_row .. first_row + n`` of the
    source, in a table whose ``parent_row`` holds source row ids."""

    table: SpanTable
    first_row: int = 0

    def __len__(self) -> int:
        return self.table.n_spans


def stamp(us: int) -> str:
    """An epoch-microsecond instant as JAX prints a window bound
    (``str(pd.Timestamp(us * 1000))``)."""
    text = str(np.datetime64(int(us), "us")).replace("T", " ")
    return text[:-7] if text.endswith(".000000") else text


@dataclass
class ClosedWindow:
    """One window the watermark sealed: [start_us, end_us) event time."""

    start_us: int
    end_us: int
    table: Optional[SpanTable]   # None for an empty window

    @property
    def n_spans(self) -> int:
        return 0 if self.table is None else self.table.n_spans

    @property
    def start(self) -> str:
        return stamp(self.start_us)

    @property
    def end(self) -> str:
        return stamp(self.end_us)


def _intern(names: Sequence[str], codes_of: List[np.ndarray], sort: bool):
    """One vocabulary over several tables' code spaces: ``names`` each
    table's names per code (a list per table), ``codes_of`` the codes
    each table uses, in the order to intern them (``sort``: by name).
    Returns (window names, per-table code map)."""
    if len(names) == 1:  # one source table: its names are distinct
        table_names, codes = names[0], codes_of[0]
        if sort:
            codes = np.asarray(sorted(codes.tolist(), key=table_names.__getitem__),
                               dtype=np.int64)
        m = np.full(len(table_names), -1, dtype=np.int32)
        m[codes] = np.arange(codes.size, dtype=np.int32)
        return [table_names[c] for c in codes.tolist()], [m]
    seen: Dict[str, int] = {}
    order: List[str] = []
    for table_names, codes in zip(names, codes_of):
        for c in codes.tolist():
            n = table_names[c]
            if n not in seen:
                seen[n] = len(order)
                order.append(n)
    if sort:
        order = sorted(order)
        seen = {n: i for i, n in enumerate(order)}
    maps = []
    for table_names, codes in zip(names, codes_of):
        m = np.full(len(table_names), -1, dtype=np.int32)
        if codes.size:
            m[codes] = [seen[table_names[c]] for c in codes.tolist()]
        maps.append(m)
    return order, maps


def window_table(pieces: Sequence[Tuple[SpanBatch, np.ndarray]]) -> SpanTable:
    """The rows ``idx`` of each (batch, idx) piece as one window table, in
    piece order: ops interned in sorted name order, traces in first
    appearance, parents re-based onto the window's rows."""
    tables = [b.table for b, _ in pieces]
    cols = {f: [getattr(t, f)[idx] for t, (_, idx) in zip(tables, pieces)]
            for f in ("trace_id", "svc_op", "pod_op", "duration_us", "start_us", "end_us",
                      "parent_row")}
    src_rows = np.concatenate([b.first_row + idx.astype(np.int64) for b, idx in pieces])
    # One vocabulary per distinct source table (batches of one source
    # share theirs).
    distinct: Dict[int, int] = {}
    for t in tables:
        distinct.setdefault(id(t.trace_names), len(distinct))
    groups = [[] for _ in distinct]
    for k, t in enumerate(tables):
        groups[distinct[id(t.trace_names)]].append(k)
    firsts = [tables[g[0]] for g in groups]

    def vocab(field_codes, field_names, sort):
        used = [np.unique(np.concatenate([cols[field_codes][k] for k in g])) for g in groups]
        names, maps = _intern([getattr(t, field_names) for t in firsts], used, sort)
        out = np.concatenate([maps[distinct[id(t.trace_names)]][c]
                              for t, c in zip(tables, cols[field_codes])])
        return names, out

    pod_names, pod_op = vocab("pod_op", "pod_op_names", True)
    svc_names, svc_op = vocab("svc_op", "svc_op_names", True)
    # Traces in first appearance: each group's codes ordered by their
    # first row.
    trace_codes = [np.concatenate([cols["trace_id"][k] for k in g]) for g in groups]
    firsts_used = []
    for codes in trace_codes:
        uniq, first = np.unique(codes, return_index=True)
        firsts_used.append(uniq[np.argsort(first, kind="stable")])
    trace_names, trace_maps = _intern([t.trace_names for t in firsts], firsts_used, False)
    trace_id = np.concatenate([trace_maps[distinct[id(t.trace_names)]][c]
                               for t, c in zip(tables, cols["trace_id"])])
    # Parents: source row ids onto window rows.
    parent_src = np.concatenate(cols["parent_row"]).astype(np.int64)
    order = np.argsort(src_rows, kind="stable")
    sorted_rows = src_rows[order]
    at = np.clip(np.searchsorted(sorted_rows, parent_src), 0, max(len(sorted_rows) - 1, 0))
    found = (parent_src >= 0) & (sorted_rows.size > 0)
    if sorted_rows.size:
        found &= sorted_rows[at] == parent_src
    parent_row = np.where(found, order[at] if sorted_rows.size else -1, -1).astype(np.int64)
    start_us = np.concatenate(cols["start_us"]).astype(np.int64)
    return SpanTable(
        trace_id=trace_id.astype(np.int32),
        svc_op=svc_op.astype(np.int32),
        pod_op=pod_op.astype(np.int32),
        duration_us=np.concatenate(cols["duration_us"]).astype(np.int64),
        start_us=start_us,
        end_us=np.concatenate(cols["end_us"]).astype(np.int64),
        parent_row=parent_row,
        trace_names=trace_names,
        svc_op_names=svc_names,
        pod_op_names=pod_names,
        time_sorted=bool(np.all(start_us[1:] >= start_us[:-1])),
    )


class StreamWindower:
    """Assign spans to event-time windows; close them at the watermark.

    ``add(batch)`` buffers the batch's spans into their window(s) and
    returns every window that closed as a result (in start order);
    ``flush()`` closes everything still open (end of stream). Window
    boundaries align to the epoch (origin: the first span's time floored
    to a slide multiple, less the overlap), so replays window
    identically."""

    def __init__(self, width_us: int, slide_us: Optional[int] = None, lateness_us: int = 0):
        self.width_us = int(width_us)
        self.slide_us = int(slide_us) if slide_us else self.width_us
        if not 0 < self.slide_us <= self.width_us:
            raise ValueError(f"slide ({self.slide_us}) must be in (0, width={self.width_us}]")
        self.lateness_us = max(0, int(lateness_us))
        self.origin_us: Optional[int] = None
        self.max_event_us: Optional[int] = None
        self.dropped_late = 0
        self._next = 0                       # next window index to emit
        self._buffers: Dict[int, List[Tuple[SpanBatch, np.ndarray]]] = {}

    def add(self, batch: SpanBatch) -> List[ClosedWindow]:
        """Buffer one span batch; return the windows it closed."""
        if batch is None or len(batch) == 0:
            return []
        t = batch.table.start_us.astype(np.int64)
        n_overlap = -(-self.width_us // self.slide_us)
        if self.origin_us is None:
            first = int(t.min())
            # Index 0 is the earliest epoch-aligned window that can hold
            # the first span (overlap - 1 slides back).
            self.origin_us = (first // self.slide_us - (n_overlap - 1)) * self.slide_us
            self.max_event_us = first
        rel = t - self.origin_us
        base = np.floor_divide(rel, self.slide_us)
        # A span whose newest window (i = base) already emitted can land
        # nowhere: late beyond the bound (so is one before the origin).
        late = base < self._next
        self.dropped_late += int(late.sum())
        if late.any():
            from ..obs.metrics import stream_late_spans

            stream_late_spans().inc(float(late.sum()))
        rows = np.arange(t.size)
        for j in range(n_overlap):
            i = base - j
            ok = (i >= self._next) & (rel - i * self.slide_us < self.width_us)
            if not ok.any():
                continue
            i_ok, r_ok = i[ok], rows[ok]
            for idx in np.unique(i_ok):
                self._buffers.setdefault(int(idx), []).append((batch, r_ok[i_ok == idx]))
        self.max_event_us = max(self.max_event_us, int(t.max()))
        return self._emit_closed()

    def _window_bounds(self, i: int) -> Tuple[int, int]:
        s = self.origin_us + i * self.slide_us
        return s, s + self.width_us

    def _pop_window(self, i: int) -> ClosedWindow:
        s, e = self._window_bounds(i)
        parts = self._buffers.pop(i, None)
        return ClosedWindow(start_us=s, end_us=e, table=window_table(parts) if parts else None)

    def _emit_closed(self) -> List[ClosedWindow]:
        if self.origin_us is None:
            return []
        watermark = self.max_event_us - self.lateness_us
        out: List[ClosedWindow] = []
        while self._window_bounds(self._next)[1] <= watermark:
            out.append(self._pop_window(self._next))
            self._next += 1
        return out

    def flush(self) -> List[ClosedWindow]:
        """Close every remaining open window (end of stream)."""
        out: List[ClosedWindow] = []
        if self.origin_us is None:
            return out
        while self._buffers:
            last = max(self._buffers)
            while self._next <= last:
                out.append(self._pop_window(self._next))
                self._next += 1
        return out
