"""Span admission for the native table lane (counterpart of
``microrank_tpu/ingest/table_admission.py``).

The native loader already settles names and parent linkage (an
unparseable row never becomes a table row, a missing parent is
``parent_row = -1``). What is left to reject at this level are values
and budgets: negative durations, durations over the maximum, a
trace-level end before its start, and spans past the per-trace cap.
``admit_table`` applies those masks over the interned arrays in the JAX
package's order and returns the filtered ``SpanTable`` with the
per-reason counts; ``parent_row`` is remapped so that a surviving span
whose parent was rejected becomes a root (the stitch policy).

Admitted and rejected rows are counted in the metrics registry where
the JAX package counts them (``microrank_ingest_admitted_total``,
``microrank_ingest_rejected_total{reason}``), and every rejected row
lands in the dead-letter store (``ingest.quarantine``) as JAX writes
it: reasons in the masks' order, rows ascending, the row as its decoded
trace, op, duration and times, ``offset`` its row index.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

import numpy as np

from ..obs.metrics import record_ingest_admitted, record_ingest_rejected
from .quarantine import QuarantineStore, get_quarantine

log = logging.getLogger("microrank_tpu_torch.ingest")


def _quarantine_rows(table, mask: np.ndarray, reason: str, store, source: str) -> None:
    """The rows of ``mask`` into ``store``, ascending, as JAX's
    ``_quarantine_rows`` writes them one by one (one write here)."""
    idx = np.flatnonzero(mask)
    trace_names, op_names = table.trace_names, table.pod_op_names
    rows = zip(
        table.trace_id[idx].tolist(), table.pod_op[idx].tolist(),
        table.duration_us[idx].tolist(), table.start_us[idx].tolist(),
        table.end_us[idx].tolist(),
    )
    store.put_raws(
        [f"trace={trace_names[t]} op={op_names[o]} duration_us={d} start_us={s} end_us={e}"
         for t, o, d, s, e in rows],
        reason, source=source, offsets=idx.tolist(),
    )


def admit_table(
    table,
    ingest_config,
    quarantine: Optional[QuarantineStore] = None,
    source: str = "table",
    reject_unparsed: bool = False,
) -> Tuple[object, Dict[str, int]]:
    """Validate and budget one ``SpanTable``; returns ``(clean_table,
    rejected_counts)`` (counts by reason, only reasons that rejected a
    row). Rejected rows go to ``quarantine``, else to the process store
    (``get_quarantine``). The input is never mutated.

    ``reject_unparsed`` (serve's inline records, where JAX's frame
    coerces an unparseable time to NaT): a row whose start or end did
    not parse (``serve.protocol.NAT_US``) rejects as ``bad_timestamp``
    too. The table lane leaves it off, as JAX's table admission keeps
    such rows."""
    cfg = ingest_config
    n = table.n_spans
    if not cfg.enabled or n == 0:
        return table, {}

    masks: Dict[str, np.ndarray] = {}
    dur = table.duration_us
    bad_dur = dur < 0
    masks["bad_duration"] = bad_dur
    max_dur = int(cfg.max_duration_us or 0)
    if max_dur > 0:
        masks["duration_overflow"] = (dur > max_dur) & ~bad_dur
    # A trace-level end before its start (the loader parses both apart,
    # so a garbled row can invert them).
    bad_ts = table.end_us < table.start_us
    if reject_unparsed:
        nat = np.iinfo(np.int64).min
        bad_ts = bad_ts | (table.start_us == nat) | (table.end_us == nat)
    masks["bad_timestamp"] = bad_ts & ~bad_dur

    rejected = np.zeros(n, dtype=bool)
    for m in masks.values():
        rejected |= m

    # Trace-length budget: a trace's spans past the cap reject in row
    # order (the table is time-sorted, so "the first cap spans" is well
    # defined).
    max_trace = int(cfg.max_spans_per_trace or 0)
    if max_trace > 0:
        tid = table.trace_id.astype(np.int64)
        idx = np.flatnonzero(~rejected)
        if idx.size:
            order = idx[np.argsort(tid[idx], kind="stable")]
            t_sorted = tid[order]
            run_start = np.flatnonzero(
                np.concatenate(([True], t_sorted[1:] != t_sorted[:-1]))
            )
            rank = np.arange(order.size) - np.repeat(
                run_start, np.diff(np.append(run_start, order.size))
            )
            too_long = np.zeros(n, dtype=bool)
            too_long[order[rank >= max_trace]] = True
            if too_long.any():
                masks["trace_too_long"] = too_long
                rejected |= too_long

    counts = {reason: int(m.sum()) for reason, m in masks.items() if m.any()}
    if not counts:
        record_ingest_admitted(n)
        return table, {}
    store = quarantine if quarantine is not None else get_quarantine()
    for reason, m in masks.items():
        if reason in counts:
            record_ingest_rejected(reason, counts[reason])
            _quarantine_rows(table, m, reason, store, source)

    keep = ~rejected
    # parent_row holds absolute row indices: remap them onto the kept
    # rows; a span whose parent was rejected becomes a root (-1).
    new_pos = np.cumsum(keep) - 1
    parent = table.parent_row
    has_parent = parent >= 0
    parent_kept = np.zeros(n, dtype=bool)
    parent_kept[has_parent] = keep[parent[has_parent]]
    new_parent = np.where(
        has_parent & parent_kept, new_pos[np.clip(parent, 0, None)], -1
    ).astype(parent.dtype)
    clean = table._replace(
        trace_id=table.trace_id[keep],
        svc_op=table.svc_op[keep],
        pod_op=table.pod_op[keep],
        duration_us=table.duration_us[keep],
        start_us=table.start_us[keep],
        end_us=table.end_us[keep],
        parent_row=new_parent[keep],
    )
    record_ingest_admitted(int(keep.sum()))
    log.warning(
        "%s: admitted %d/%d spans (%s)",
        source, clean.n_spans, n,
        ", ".join(f"{k}={v}" for k, v in sorted(counts.items())),
    )
    return clean, counts
