"""Array-native window building from a SpanTable — the native lane
(counterpart of ``microrank_tpu/graph/table_ops.py``).

The native loader interned everything at load time, so window slicing,
detection and graph building are pure integer array work: the fused
C++ detector and the C++ graph builder. The PageRank op vocab is the
table's pod-op vocabulary, shared by every window of the table.

The JAX module's numpy fallbacks (used when the C++ library cannot
build) are not ported: here the library builds or the call raises.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

from ..io.interning import Vocab
from .build import DEFAULT_DENSE_BUDGET_BYTES, resolve_aux
from .structures import PartitionGraph, SloBaseline, WindowGraph, pad_to


def compute_slo_from_table(table, stat: str = "mean") -> Tuple[Vocab, SloBaseline]:
    """SLO baseline from a (normal-period) SpanTable — one bincount pass:
    population std, ms, 4 decimals (reference preprocess_data.py:50-78),
    incl. the ``stat="pNN"`` percentile variants (linear interpolation,
    matching np.percentile)."""
    from ..detect.slo import slo_quantile

    n_ops = len(table.svc_op_names)
    dur = table.duration_us.astype(np.float64)
    counts = np.bincount(table.svc_op, minlength=n_ops).astype(np.float64)
    counts = np.maximum(counts, 1.0)
    s1 = np.bincount(table.svc_op, weights=dur, minlength=n_ops)
    mean = s1 / counts
    # Two-pass variance for numerical agreement with np.std.
    centered = dur - mean[table.svc_op]
    s2 = np.bincount(table.svc_op, weights=centered * centered, minlength=n_ops)
    std = np.sqrt(s2 / counts)
    if stat == "mean":
        center = mean
    else:
        q = slo_quantile(stat)
        order = np.lexsort((dur, table.svc_op))
        s_op = table.svc_op[order]
        s_dur = dur[order]
        ids = np.arange(n_ops)
        starts = np.searchsorted(s_op, ids)
        n = np.searchsorted(s_op, ids, side="right") - starts
        n = np.maximum(n, 1)
        pos = q * (n - 1)
        lo = np.floor(pos).astype(np.int64)
        hi = np.minimum(lo + 1, n - 1)
        frac = pos - lo
        center = s_dur[starts + lo] * (1 - frac) + s_dur[starts + hi] * frac
    baseline = SloBaseline(
        mean_ms=np.round(center / 1000.0, 4).astype(np.float32),
        std_ms=np.round(std / 1000.0, 4).astype(np.float32),
    )
    return Vocab(table.svc_op_names), baseline


def window_rows(table, start_us: int, end_us: int) -> np.ndarray:
    """Row mask for one detection window (get_span semantics:
    startTime >= start AND endTime <= end, preprocess_data.py:10-14)."""
    return (table.start_us >= start_us) & (table.end_us <= end_us)


def window_span_range(table, start_us: int, end_us: int):
    """Candidate row range [lo, hi) of one window on a TIME-SORTED table:
    every qualifying row has its start in [w0, w1], which is contiguous
    under the sort."""
    lo = int(np.searchsorted(table.start_us, start_us, "left"))
    hi = int(np.searchsorted(table.start_us, end_us, "right"))
    return lo, hi


def _slice_table(table, lo: int, hi: int):
    """Row-slice view of a SpanTable (parent_row stays table-absolute)."""
    return table._replace(
        trace_id=table.trace_id[lo:hi],
        svc_op=table.svc_op[lo:hi],
        pod_op=table.pod_op[lo:hi],
        duration_us=table.duration_us[lo:hi],
        start_us=table.start_us[lo:hi],
        end_us=table.end_us[lo:hi],
        parent_row=table.parent_row[lo:hi],
    )


def detect_window_partition(
    table,
    w0_us: int,
    w1_us: int,
    slo_vocab: Vocab,
    baseline,
    detector_cfg,
    remap: np.ndarray | None = None,
    thresh: np.ndarray | None = None,
    with_range: bool = False,
):
    """The window-detection seam: (mask, nrm_codes, abn_codes,
    n_window_spans) for one [w0, w1) window via the fused C++ scan.

    Time-sorted tables scan only the window's candidate slice.
    ``with_range=True`` appends that (lo, hi) range and returns the
    mask over the slice; without it the mask is table-length.
    ``remap``/``thresh`` may be passed precomputed.
    """
    from ..detect.detector import _thresholds
    from ..native import detect_window_native

    n_spans = table.n_spans
    if getattr(table, "time_sorted", False):
        lo, hi = window_span_range(table, w0_us, w1_us)
    else:
        lo, hi = 0, n_spans
    sub = table if (lo, hi) == (0, n_spans) else _slice_table(table, lo, hi)
    if remap is None:
        remap = np.ascontiguousarray(
            slo_vocab.encode(table.svc_op_names), dtype=np.int32
        )
    if thresh is None:
        thresh = _thresholds(baseline, detector_cfg)
    sub_mask, nrm, abn, n_window, _ = detect_window_native(
        sub, w0_us, w1_us, remap, thresh, detector_cfg.slack_ms
    )
    if with_range:
        return sub_mask, nrm, abn, n_window, (lo, hi)
    if (lo, hi) == (0, n_spans):
        return sub_mask, nrm, abn, n_window
    mask = np.zeros(n_spans, dtype=sub_mask.dtype)
    mask[lo:hi] = sub_mask
    return mask, nrm, abn, n_window


def _graph_from_padded(p) -> PartitionGraph:
    """Wrap one native PaddedPartition as a PartitionGraph, with the
    bitmap, kind, CSR and partition-centric views the build exported
    (each empty, shaped as the JAX package's build leaves it, where the
    aux mode did not ask for it)."""
    return PartitionGraph(
        inc_op=p.inc_op,
        inc_trace=p.inc_trace,
        sr_val=p.sr_val,
        rs_val=p.rs_val,
        ss_child=p.ss_child,
        ss_parent=p.ss_parent,
        ss_val=p.ss_val,
        inc_trace_opmajor=p.inc_trace_opmajor,
        sr_val_opmajor=p.sr_val_opmajor,
        inc_indptr_op=p.inc_indptr_op,
        inc_indptr_trace=p.inc_indptr_trace,
        ss_indptr=p.ss_indptr,
        cov_bits=p.cov_bits,
        ss_bits=p.ss_bits,
        inv_tracelen=p.inv_tracelen,
        inv_cov_dup=p.inv_cov_dup,
        inv_outdeg=p.inv_outdeg,
        kind=p.kind,
        tracelen=p.tracelen,
        cov_unique=p.cov_unique,
        op_present=p.op_present,
        n_ops=np.int32(p.n_ops),
        n_traces=np.int32(p.n_traces),
        n_inc=np.int32(p.n_inc),
        n_ss=np.int32(p.n_ss),
        n_cols=np.int32(p.n_cols),
        pc_trace=p.pc_trace,
        pc_sr_val=p.pc_sr_val,
        pc_blk_indptr=p.pc_blk_indptr,
        pc_ell_op=p.pc_ell_op,
        pc_ell_rs=p.pc_ell_rs,
    )


def build_window_graph_from_table(
    table,
    mask: np.ndarray,
    normal_trace_codes: Iterable[int],
    abnormal_trace_codes: Iterable[int],
    pad_policy: str = "pow2q",
    min_pad: int = 8,
    aux: str = "none",
    dense_budget_bytes: int = DEFAULT_DENSE_BUDGET_BYTES,
    collapse: str = "off",
    row_range: Tuple[int, int] | None = None,
    kind_dedup_threshold: float | None = None,
    retain_columns: bool = False,
):
    """Both partitions' graphs from table rows, built in C++
    (graph_builder.cpp), with the kind collapse (``collapse`` "off" |
    "auto" | "on") inside the same build.

    ``mask`` is a bool row filter (None = all rows), table-length or
    slice-local to ``row_range`` (lo, hi), which must contain every
    True row. ``aux`` picks the kernel views ("none", "packed", "kind",
    "pcsr", "csr", "all", or "auto": pcsr when the bitmaps would exceed a quarter of
    ``dense_budget_bytes``, else kind past ``kind_dedup_threshold`` on a
    collapsed window, else packed; None takes the build module's default
    threshold).
    Returns (graph, op_names, normal_codes, abnormal_codes).
    ``retain_columns`` (JAX's ``build_window_graph(..., retain_columns=
    True)``): append ``(map_normal, map_abnormal)``, per partition the
    local trace index of each collapsed column's representative (its
    kind group's lowest member; ``mr_export_columns``), or None for an
    identity mapping (an uncollapsed build).
    """
    from ..native import build_window_padded

    if aux == "auto_all":
        raise NotImplementedError(
            "aux mode 'auto_all' is the mesh's (both view families for the "
            "per-shard kernel choice), which is not ported: ROADMAP.md's port "
            "queue, item 12"
        )
    vocab_size = len(table.pod_op_names)
    v_pad = pad_to(vocab_size, pad_policy, min_pad)
    lo, hi = row_range if row_range is not None else (0, table.n_spans)
    if mask is None:
        mask = np.ones(hi - lo, dtype=bool)
    elif len(mask) != hi - lo:
        if len(mask) != table.n_spans:
            raise ValueError(
                f"mask length {len(mask)} matches neither the row_range "
                f"({hi - lo}) nor the table ({table.n_spans})"
            )
        mask = mask[lo:hi]

    normal_trace_codes = list(normal_trace_codes)
    abnormal_trace_codes = list(abnormal_trace_codes)
    if collapse != "off":
        # The C++ build collapses first and resolves the views against
        # the collapsed shapes.
        mode = aux
    else:
        t_pads = [
            pad_to(max(len(set(c)), 1), pad_policy, min_pad)
            for c in (normal_trace_codes, abnormal_trace_codes)
        ]
        mode = resolve_aux(aux, v_pad, t_pads, dense_budget_bytes)

    n_total = len(table.trace_names)
    nf = np.zeros(n_total, dtype=np.uint8)
    af = np.zeros(n_total, dtype=np.uint8)
    ncodes = np.asarray(normal_trace_codes, dtype=np.int64)
    acodes = np.asarray(abnormal_trace_codes, dtype=np.int64)
    if len(ncodes):
        nf[ncodes] = 1
    if len(acodes):
        af[acodes] = 1
    # parent_row stays ABSOLUTE; the C++ scan subtracts parent_base and
    # drops parents outside the slice (they cannot be window rows).
    built = build_window_padded(
        table.pod_op[lo:hi],
        table.trace_id[lo:hi],
        table.parent_row[lo:hi],
        None if bool(np.all(mask)) else mask,
        nf,
        af,
        vocab_size,
        v_pad,
        lambda n: pad_to(n, pad_policy, min_pad),
        mode,
        collapse=collapse,
        dense_budget_bytes=dense_budget_bytes,
        parent_base=lo,
        kind_dedup_threshold=kind_dedup_threshold,
        retain_columns=retain_columns,
    )
    raw_n, raw_a = built[:2]
    graph = WindowGraph(
        normal=_graph_from_padded(raw_n),
        abnormal=_graph_from_padded(raw_a),
    )
    out = (
        graph,
        list(table.pod_op_names),
        raw_n.local_uniques.astype(np.int64),
        raw_a.local_uniques.astype(np.int64),
    )
    if retain_columns:
        return out + (tuple(None if p.n_cols < 0 else cols.astype(np.int64)
                            for p, cols in zip((raw_n, raw_a), built[2])),)
    return out
