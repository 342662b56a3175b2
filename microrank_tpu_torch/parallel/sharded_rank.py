"""Batched window ranking on one device (counterpart of
``microrank_tpu/parallel/sharded_rank.py``: ``stack_window_graphs``,
``rank_windows_batched``, ``rank_windows_batched_traced``; the sharded
functions wait for the mesh, ROADMAP.md 'Port queue' item 12).

A batch of window graphs is stacked with a leading window axis: every
field re-padded to the batch maximum, padding inert, each window's true
extents in its ``n_*`` scalars (stacked to [B]). One rank program then
ranks the whole stack (``rank_backends.torch_cuda.rank_window_traced_core``
on a stacked graph, K18): each power-iteration step is one launch of each
kernel of the route (K1, the pattern pair or K8, the pcsr step, K5) for
all B windows, on every route. As JAX's ``_rank_windows_batched_jit``,
packed_blocked's block budget is divided by B (``divide_block_budget``).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..config import PageRankConfig, SpectrumConfig
from ..graph.build import pcsr_partitions
from ..graph.structures import PartitionGraph, WindowGraph


def _pad_axis0(arr: np.ndarray, size: int, fill=0) -> np.ndarray:
    if arr.shape[0] == size:
        return arr
    out = np.full((size,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def _pad2d(arr: np.ndarray, rows: int, cols: int) -> np.ndarray:
    if arr.shape == (rows, cols):
        return arr
    out = np.zeros((rows, cols), dtype=arr.dtype)
    out[: arr.shape[0], : arr.shape[1]] = arr
    return out


def _pad_indptr(arr: np.ndarray, size: int) -> np.ndarray:
    """A row-offset array padded with its last value, so every added row
    is an empty range (the arrays end at the true entry count)."""
    if arr.shape[0] == 0:  # not built
        return np.zeros(0, np.int32)
    if arr.shape[0] == size + 1:
        return arr
    return np.concatenate([arr, np.full(size + 1 - arr.shape[0], arr[-1], arr.dtype)])


def _stack_parts(
    parts: List[PartitionGraph], shard_multiple: int, trace_multiple: int
) -> PartitionGraph:
    n = len(parts)

    def stack_entry(name, dtype):
        """One entry-sized field, padded to ITS OWN rounded batch max: a
        field stripped to length 0 for the kernel stays length 0."""
        arrs = [getattr(p, name) for p in parts]
        size = _round_up(max(a.shape[0] for a in arrs), shard_multiple)
        return np.stack([_pad_axis0(np.asarray(a, dtype), size) for a in arrs])

    t = _round_up(max(p.kind.shape[0] for p in parts), trace_multiple)
    v = max(p.cov_unique.shape[0] for p in parts)
    # A view family that some window lacks is left out for all of them
    # (the kernel chooser treats a 0-length view as "not built"). The two
    # bitmaps degrade independently; the kind views' row offsets ride
    # ss_indptr, stacked whenever every window has it.
    have_csr = all(p.inc_indptr_op.shape[0] for p in parts)
    have_pc = all(p.pc_trace.shape[-1] for p in parts)
    have_cov = all(p.cov_bits.shape[1] for p in parts)
    have_ss = all(p.ss_bits.shape[1] for p in parts)
    have_ssptr = all(p.ss_indptr.shape[0] for p in parts)

    def empty(dtype, *shape):
        return np.zeros((n, *shape), dtype)

    # Partition-centric views: the P axis re-tiles the (re-padded) trace
    # axis, appended partitions all padding; block and slab widths pad to
    # the batch max (zero entries are inert).
    if have_pc:
        p_target = max(pcsr_partitions(t), max(p.pc_trace.shape[0] for p in parts))
        e_target = max(p.pc_trace.shape[1] for p in parts)
        w_target = max(p.pc_ell_op.shape[1] for p in parts)

    def stack_pc_tab(name, dtype):
        if not have_pc:
            return empty(dtype, 1, 0)
        return np.stack([
            _pad2d(getattr(p, name).astype(dtype), p_target, e_target) for p in parts
        ])

    def stack_pc_indptr():
        """[P, V+1] block offsets: appended partitions are all-zero rows
        (every op an empty range), appended ops repeat each row's last
        value (empty ranges at the row's end)."""
        if not have_pc:
            return empty(np.int32, 1, 0)
        out = []
        for p in parts:
            arr = np.asarray(p.pc_blk_indptr, dtype=np.int32)
            if arr.shape[1] < v + 1:
                arr = np.concatenate(
                    [arr, np.repeat(arr[:, -1:], v + 1 - arr.shape[1], axis=1)], axis=1
                )
            out.append(_pad2d(arr, p_target, v + 1))
        return np.stack(out)

    def stack_pc_ell(name, dtype):
        if not have_pc:
            return empty(dtype, 1, 0)
        return np.stack([_pad2d(getattr(p, name).astype(dtype), t, w_target) for p in parts])

    return PartitionGraph(
        inc_op=stack_entry("inc_op", np.int32),
        inc_trace=stack_entry("inc_trace", np.int32),
        sr_val=stack_entry("sr_val", np.float32),
        rs_val=stack_entry("rs_val", np.float32),
        ss_child=stack_entry("ss_child", np.int32),
        ss_parent=stack_entry("ss_parent", np.int32),
        ss_val=stack_entry("ss_val", np.float32),
        inc_trace_opmajor=(
            stack_entry("inc_trace_opmajor", np.int32) if have_csr else empty(np.int32, 0)
        ),
        sr_val_opmajor=(
            stack_entry("sr_val_opmajor", np.float32) if have_csr else empty(np.float32, 0)
        ),
        inc_indptr_op=(
            np.stack([_pad_indptr(p.inc_indptr_op, v) for p in parts])
            if have_csr else empty(np.int32, 0)
        ),
        inc_indptr_trace=(
            np.stack([_pad_indptr(p.inc_indptr_trace, t) for p in parts])
            if have_csr else empty(np.int32, 0)
        ),
        ss_indptr=(
            np.stack([_pad_indptr(p.ss_indptr, v) for p in parts])
            if have_ssptr else empty(np.int32, 0)
        ),
        # Bitmaps: a 2-d zero pad is exact (absent rows and traces are 0 bits).
        cov_bits=(
            np.stack([_pad2d(p.cov_bits, v, (t + 7) // 8) for p in parts])
            if have_cov else empty(np.uint8, v, 0)
        ),
        ss_bits=(
            np.stack([_pad2d(p.ss_bits, v, (v + 7) // 8) for p in parts])
            if have_ss else empty(np.uint8, v, 0)
        ),
        inv_tracelen=np.stack([_pad_axis0(p.inv_tracelen, t) for p in parts]),
        inv_cov_dup=np.stack([_pad_axis0(p.inv_cov_dup, v) for p in parts]),
        inv_outdeg=np.stack([_pad_axis0(p.inv_outdeg, v) for p in parts]),
        kind=np.stack([_pad_axis0(p.kind, t, fill=1) for p in parts]),
        tracelen=np.stack([_pad_axis0(p.tracelen, t, fill=1) for p in parts]),
        cov_unique=np.stack([_pad_axis0(p.cov_unique, v) for p in parts]),
        op_present=np.stack([_pad_axis0(p.op_present, v, fill=False) for p in parts]),
        n_ops=np.stack([p.n_ops for p in parts]),
        n_traces=np.stack([p.n_traces for p in parts]),
        n_inc=np.stack([p.n_inc for p in parts]),
        n_ss=np.stack([p.n_ss for p in parts]),
        n_cols=np.stack([np.int32(p.n_cols) for p in parts]),
        pc_trace=stack_pc_tab("pc_trace", np.int32),
        pc_sr_val=stack_pc_tab("pc_sr_val", np.float32),
        pc_blk_indptr=stack_pc_indptr(),
        pc_ell_op=stack_pc_ell("pc_ell_op", np.int32),
        pc_ell_rs=stack_pc_ell("pc_ell_rs", np.float32),
    )


def stack_window_graphs(
    graphs: Sequence[WindowGraph],
    shard_multiple: int = 1,
    trace_multiple: int = 1,
) -> WindowGraph:
    """Stack per-window host graphs into one batched WindowGraph (numpy).

    Each field is re-padded to the batch maximum (the entry axes rounded
    up to ``shard_multiple``, the trace axis to ``trace_multiple``: the
    sharded kernels' needs, kept for the mesh). Padding entries carry
    value 0 and are inert; per-window true extents live in the ``n_*``
    scalars, stacked to [B]. Fields are read by name, so the JAX
    package's graphs stack too (its int8 ``cov_i8`` is not carried)."""
    return WindowGraph(
        normal=_stack_parts([g.normal for g in graphs], shard_multiple, trace_multiple),
        abnormal=_stack_parts([g.abnormal for g in graphs], shard_multiple, trace_multiple),
    )


def _rank_stacked(batched: WindowGraph, pagerank_cfg, spectrum_cfg, kernel, device):
    from ..rank_backends.convert import graph_from_numpy
    from ..rank_backends.torch_cuda import (
        choose_kernel,
        device_subset,
        divide_block_budget,
        host_subset,
        rank_window_traced_core,
    )
    from ..utils.device import resolve_device

    if kernel == "auto":
        kernel = choose_kernel(batched)
    pagerank_cfg = divide_block_budget(pagerank_cfg, kernel, batched.normal.kind.shape[0])
    dgraph = device_subset(
        graph_from_numpy(host_subset(batched, kernel), resolve_device(device)),
        kernel,
        pagerank_cfg.packed_block_bytes,
    )
    return rank_window_traced_core(dgraph, pagerank_cfg, spectrum_cfg, kernel)


def rank_windows_batched(
    batched: WindowGraph,
    pagerank_cfg: PageRankConfig = PageRankConfig(),
    spectrum_cfg: SpectrumConfig = SpectrumConfig(),
    kernel: str = "auto",
    device=None,
):
    """One program over a stacked host graph: (top_idx int32[B, k],
    top_scores float32[B, k], n_valid int32[B]) on ``device`` (default
    the card; "cpu" runs the kernels' plain versions)."""
    return _rank_stacked(batched, pagerank_cfg, spectrum_cfg, kernel, device)[:3]


def rank_windows_batched_traced(
    batched: WindowGraph,
    pagerank_cfg: PageRankConfig = PageRankConfig(),
    spectrum_cfg: SpectrumConfig = SpectrumConfig(),
    kernel: str = "auto",
    device=None,
):
    """``rank_windows_batched`` plus each window's convergence trace:
    (..., residuals float32[B, 2, I], n_iters int32[B])."""
    return _rank_stacked(batched, pagerank_cfg, spectrum_cfg, kernel, device)
