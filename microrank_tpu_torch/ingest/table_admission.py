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

Not ported: the dead-letter (quarantine) store and the admission
metrics. The counts are logged instead; ROADMAP.md's port queue, item 5
(journal and metrics), brings the rest.
"""

from __future__ import annotations

import logging
from typing import Dict, Tuple

import numpy as np

log = logging.getLogger("microrank_tpu_torch.ingest")


def admit_table(table, ingest_config, source: str = "table") -> Tuple[object, Dict[str, int]]:
    """Validate and budget one ``SpanTable``; returns ``(clean_table,
    rejected_counts)`` (counts by reason, only reasons that rejected a
    row). The input is never mutated."""
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
    masks["bad_timestamp"] = (table.end_us < table.start_us) & ~bad_dur

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
        return table, {}

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
    log.warning(
        "%s: admitted %d/%d spans (%s)",
        source, clean.n_spans, n,
        ", ".join(f"{k}={v}" for k, v in sorted(counts.items())),
    )
    return clean, counts
