"""Array-form window/graph structures (counterpart of
``microrank_tpu/graph/structures.py``).

The host builds flat padded numpy arrays; ``rank_backends.convert``
turns a graph into the same NamedTuples holding torch tensors on the
rank device. Dynamic extents are 0-d values; padded extents live in the
shapes. Field names and meanings match the JAX package one for one, so
either package's graphs convert into the other's by field name.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np


class PartitionGraph(NamedTuple):
    """One trace partition's PageRank graph, padded, in a shared window
    op vocab of padded size ``V``. E = padded unique (op, trace)
    incidence entries, C = padded unique call edges, T = padded trace
    columns. Padding carries value 0 / index 0 and is inert."""

    # Unique (op, trace) incidence entries sorted by (trace, op).
    inc_op: np.ndarray      # int32[E]
    inc_trace: np.ndarray   # int32[E]
    sr_val: np.ndarray      # float32[E]  1 / len_with_dups(trace)   (p_sr)
    rs_val: np.ndarray      # float32[E]  1 / cov_with_dups(op)      (p_rs)
    # Unique call-graph edges (child <- parent), sorted by (child, parent).
    ss_child: np.ndarray    # int32[C]
    ss_parent: np.ndarray   # int32[C]
    ss_val: np.ndarray      # float32[C]  1 / outdeg_with_dups(parent)
    # CSR views of the JAX csr kernel (ss_indptr also of the kind
    # kernel); empty where the build did not make them.
    inc_trace_opmajor: np.ndarray  # int32[E]
    sr_val_opmajor: np.ndarray     # float32[E]
    inc_indptr_op: np.ndarray      # int32[V+1]
    inc_indptr_trace: np.ndarray   # int32[T+1]
    ss_indptr: np.ndarray          # int32[V+1]
    # Packed-bitmap views of the packed (and kind) builds; [V, 0] when
    # not built.
    cov_bits: np.ndarray           # uint8[V, T/8]
    ss_bits: np.ndarray            # uint8[V, V/8]
    inv_tracelen: np.ndarray       # float32[T]
    inv_cov_dup: np.ndarray        # float32[V]
    inv_outdeg: np.ndarray         # float32[V]
    # Per-trace statistics (partition-local trace axis, padded to T).
    kind: np.ndarray        # int32[T]  kind size (column multiplicity when collapsed)
    tracelen: np.ndarray    # int32[T]  spans in trace (with dups)
    # Per-op statistics on the shared window vocab.
    cov_unique: np.ndarray  # int32[V]  unique traces covering op
    op_present: np.ndarray  # bool[V]
    # Dynamic extents (0-d int32).
    n_ops: np.ndarray
    n_traces: np.ndarray
    n_inc: np.ndarray
    n_ss: np.ndarray
    # -1: one column per trace; >= 0: the trace axis is kind-collapsed
    # into ``n_cols`` columns (``kind`` is then the multiplicity).
    n_cols: np.ndarray = np.int32(-1)
    # Partition-centric views of the pcsr kernel (graph.build.
    # pcsr_auxiliary; P = ceil(T / PCSR_PART_TRACES) trace partitions):
    # forward tables in (partition, op, trace) order with every
    # (partition, op) run padded to whole PCSR_BLOCK blocks, trace ids
    # partition-local, pc_blk_indptr the block offset of each op's run;
    # and the backward ELL slab, one row of W entries per trace. The
    # kind kernel's int8 0/1 coverage pattern [V, K] over the collapsed
    # columns.
    pc_trace: np.ndarray = np.zeros((1, 0), np.int32)       # int32[P, Epb]
    pc_sr_val: np.ndarray = np.zeros((1, 0), np.float32)    # float32[P, Epb]
    pc_blk_indptr: np.ndarray = np.zeros((1, 0), np.int32)  # int32[P, V+1]
    pc_ell_op: np.ndarray = np.zeros((1, 0), np.int32)      # int32[T, W]
    pc_ell_rs: np.ndarray = np.zeros((1, 0), np.float32)    # float32[T, W]
    cov_i8: np.ndarray = np.zeros((1, 0), np.int8)


class WindowGraph(NamedTuple):
    """Both partitions of one detection window over a shared op vocab."""

    normal: PartitionGraph
    abnormal: PartitionGraph
    # Port-only, built once per window by
    # rank_backends.torch_cuda.device_subset (None until then): K1's work
    # list (ops.spmv.SpmvGroup) — the six SpMVs of a step for "pallas",
    # the two call-graph terms for the kind and packed kernels — and the
    # two coverage patterns of the pattern-pair kernel
    # (ops.pattern.PatternGroup).
    spmv_group: Optional[Any] = None
    pattern_group: Optional[Any] = None


class DetectBatch(NamedTuple):
    """Spans of one detection window, interned for the detector:
    ``op`` indexes the SLO vocab (-1 = unseen), ``trace`` is
    window-local. Padding spans carry op=-1 / duration=0."""

    op: np.ndarray           # int32[S]
    trace: np.ndarray        # int32[S]
    duration_us: np.ndarray  # float32[S]
    n_spans: np.ndarray      # int32 0-d
    n_traces: np.ndarray     # int32 0-d


class SloBaseline(NamedTuple):
    """Per-operation SLO stats, ms, aligned to a Vocab."""

    mean_ms: np.ndarray   # float32[n_ops]
    std_ms: np.ndarray    # float32[n_ops]


def pad_to(n: int, policy: str = "pow2", min_pad: int = 8) -> int:
    """Bucketed padding size. "pow2": next power of two. "pow2q":
    quarter-pow2 buckets (1.25/1.5/1.75 x 2^k once sizes reach 64).
    "exact": no padding."""
    n = max(int(n), 1)
    if policy == "exact":
        return n
    p = max(min_pad, 1)
    while p < n:
        p <<= 1
    if policy == "pow2q" and p >= 64 and p > min_pad:
        q = p >> 1
        for f_num in (5, 6, 7):  # q*1.25, q*1.5, q*1.75
            cand = (q * f_num) >> 2
            if cand >= n:
                return cand
    return p


def pad1d(arr: np.ndarray, size: int, fill=0) -> np.ndarray:
    out = np.full((size,), fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out
