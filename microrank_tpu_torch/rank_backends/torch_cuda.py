"""The per-window rank program on torch tensors (counterpart of
``microrank_tpu/rank_backends/jax_tpu.py``, every kernel it runs:
"kind", "packed", "packed_bf16", "packed_blocked", "pcsr", "csr", "coo",
"dense", "dense_bf16" and "pallas"):

    set-up (preference and initial vectors) -> 25 power-iteration steps
    over both partitions -> epilogue (rescale, spectrum counters,
    formula, tie-broken top-k)

Each step's products (p_sr @ rv, p_ss @ sv, p_rs @ sv of both
partitions) take one or two launches, built for the window by
``device_subset``:

* ``pallas`` and ``coo`` (K11: JAX's segment sums, ``ops/segment.py``
  ``coo_matvec``, the function K1 computes): all six SpMVs through K1
  in one call (``ops.spmv.coo_spmv_group``) over the COO incidence
  arrays;
* ``csr`` (K10): the same six SpMVs in one K1 call, its work list read
  straight from the build's CSR views (``ops.spmv.indptr_layout``, no
  row sort: ``csr_layouts``). The op-major copies are a stable counting
  scatter of the trace-major entries, so every row holds the pallas
  row's entries in its order, and the products are the pallas path's,
  bit for bit; JAX's compensated prefix sums (an XLA device for a
  scatter-free row sum on the TPU) have no counterpart: K1's row fold
  is fixed-order by construction;
* ``dense`` / ``dense_bf16`` (K12): the transition matrices densified
  once a window (``ops.dense.densify``), then all six products of a
  step in one launch of ``csrc/dense_mv.cu`` (``ops.dense.dense_matvecs``;
  bf16 operands, f32 accumulation for ``dense_bf16``);
* ``pcsr``: the same six SpMVs in one call of the pcsr kernel
  (``ops.spmv.pcsr_spmv_group``, ``window_pcsr_group``): K1's work items
  over the op-side rows built from the partition-centric views and the
  call edges, and the trace side read straight from the views' ELL slab;
  every row holds the pallas row's entries in its order, so the products
  are the pallas path's, bit for bit;
* ``kind`` / ``packed`` / ``packed_bf16`` / ``packed_blocked``: the
  coverage pair of both partitions in one call of K2 / K4
  (``ops.pattern.pattern_pair_group``, over the coverage bitmap of the
  kind columns or of the traces), then both call-graph terms over the
  call-edge list in one K1 call. ``kind`` with
  ``kind_precision="int8"`` quantizes its operands with four scales per
  step: the first step's from one launch per window
  (``ops.pattern.quantize_scales``), every later step's from the step
  kernel below, in its own pass. ``packed_blocked`` is
  ``packed``'s function (f32) on windows whose unpacked matrices exceed
  the dense budget, through K8's own kernel (a group built with
  ``blocked=True``: per set bit, a block per column tile); neither
  kernel unpacks the bitmap, so only the plain version (the CPU path)
  works in bands.

The step's elementwise tail — the damped combination of the products,
the max normalization, the residual trace and, with ``tol``, the freeze
— is K5 (``ops.step.StepWindow``, set up once a window): one
cooperative launch of ``csrc/power_step.cu`` a step for both
partitions, in place of the eager ops the port issued before.

JAX's checked programs (K14, ``rank_window_checked_core`` :1415 and
``rank_window_checked_traced_core`` :1450, ``RuntimeConfig.
device_checks``) are the same program with the epilogue's check word
(``rank_window_checked(_traced)_core``): it rides the outputs' one
device-to-host copy (``pack_rank_outputs(..., checked=True)``), and the
fetch raises ``DeviceCheckError`` with JAX's message of the first
failed check.

K13, the program under every spectrum formula (JAX's
``rank_window_all_methods_core``, ``jax_tpu.py:1373``):
``rank_window_all_methods_core`` runs the same set-up and steps, then one
epilogue launch with a methods axis (``ops.epilogue.
rank_epilogue_all_methods``): top_idx and top_scores [M, k] in
``spectrum.formulas.METHODS`` order, n_valid; ``rank_window_all_methods``
fetches them in one copy. One window only, as in JAX.

The set-up before the loop and the epilogue after it are K6: one
launch each a program (``ops.setup.rank_setup``, ``csrc/rank_setup.cu``:
a block or a cluster of blocks a row, a cooperative grid past 8 tiles;
``ops.epilogue.rank_epilogue``, ``csrc/rank_epilogue.cu``: a block or a
cluster a window, its inputs in shared memory), in place of some 70
eager ops and four launches of the fixed-order fold.

On the card each call is one launch of a CUDA kernel, on the CPU its plain
version. The loop issues device work only — no step reads a value
back — and the caller fetches ``(top_idx, top_scores, n_valid,
residuals, n_iters)`` in one device-to-host copy, started on the stream
that ran the program (``pack_rank_outputs``) and waited for where the
result is needed (``unpack_rank_outputs``).
With a convergence ``tol`` the loop still runs ``iterations`` steps,
the step kernel freezing the carry once a device-side "still
running" flag drops, so no step branches on a device value; vectors,
residuals (zero past ``n_iters``) and ``n_iters`` come out as JAX's
``lax.while_loop`` gives them.

A stacked group of windows (``parallel.stack_window_graphs``: every
field with a leading [B] axis, padded to the group's largest window) runs
the same program once for all B (K18, the counterpart of JAX's
``vmap(rank_window_traced_core)``, ``sharded_rank.py:1091``): one work
list, one pattern group and one K5 state built for the group, a step
one launch of each kernel for all its windows, the epilogue over [B, V],
one copy of the [B] outputs. The set-up and the epilogue read each
window's own ``n_*`` scalars, and their sums over a padded axis (the
preference vector's two, the finish's total) follow the pairwise tree
of ``ops.fold`` (``csrc/tree_fold.cuh``, inside both kernels), in an
order fixed by each row's live length, so a window's bits in a group
are its own program's on every device. Every kernel runs stacked: kind (f32,
bf16, int8: ``quantize_amax`` and the step give [B, 4] scales, each
window's own), packed, packed_bf16, packed_blocked (K8 with a window
axis; the plain version's bands within ``packed_block_bytes`` divided
by B, ``divide_block_budget``), pcsr (one slab of the B windows' rows
per partition), csr (its CSR views' row offsets moved per window,
``indptr_layout``), coo, pallas, and dense / dense_bf16 (a [B, rows, ld]
matrix each, the kernel's window grid dimension).

Scalars that JAX keeps as float32 (damping, call weight, eps, tol) are
float32 here (0-d tensors filled on the device, or the step kernel's
float32 arguments), so each product rounds in float32 as it does there.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import KERNELS, PageRankConfig, SpectrumConfig
from ..graph.build import (
    DEFAULT_DENSE_BUDGET_BYTES,
    PCSR_BLOCK,
    PCSR_PART_TRACES,
    packed_unpacked_bytes,
)
from ..graph.structures import PartitionGraph, WindowGraph
# window_spectrum: the epilogue's plain spectrum, named here for the
# card tests that compare a program stage by stage.
from ..ops.dense import DenseGroup, check_group, dense_group, dense_matvecs
from ..ops.epilogue import (  # noqa: F401
    CHECK_MESSAGES,
    Epilogue,
    finish_topk,
    partition_finish,
    rank_epilogue,
    rank_epilogue_all_methods,
    rank_epilogue_checked,
    window_spectrum,
)
from ..ops.pattern import PatternGroup, pattern_group, pattern_pair_group, quantize_scales
from ..ops.setup import partition_setup_plain, rank_setup
from ..ops.step import StepWindow, step_plan, step_scratch
from ..ops.spmv import (
    EllPart,
    PcsrGroup,
    RowLayout,
    SpmvCounts,
    SpmvGroup,
    coo_spmv_group,
    ell_mode,
    host_indptr_layout,
    host_row_layout,
    host_spmv_counts,
    indptr_layout,
    pcsr_spmv_group,
    row_layout,
    spmv_group,
)


def _check_kernel(kernel: str) -> None:
    if kernel == "auto":
        raise ValueError(
            "kernel='auto' is resolved per window (choose_kernel) before "
            "the rank program"
        )
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r} (expected one of {KERNELS})")


def stacked_windows(graph: WindowGraph) -> Optional[int]:
    """B for a stacked group of windows (``parallel.sharded_rank.
    stack_window_graphs``: every field has a leading window axis), None
    for one window."""
    return int(graph.normal.kind.shape[0]) if graph.normal.kind.dim() == 2 else None


def divide_block_budget(pagerank_cfg: PageRankConfig, kernel: str, n_resident: int):
    """``jax_tpu.divide_block_budget``: with ``n_resident`` windows live
    at once (a stacked group), packed_blocked's plain version unpacks a
    band of every window together, so each window's band budget is
    ``packed_block_bytes // n_resident`` and the band stays within the
    budget. Other kernels and single windows keep the config. The
    kernels never unpack, and a band of whole column tiles moves no bit."""
    if kernel != "packed_blocked" or n_resident <= 1:
        return pagerank_cfg
    return dataclasses.replace(
        pagerank_cfg,
        packed_block_bytes=max(1, pagerank_cfg.packed_block_bytes // int(n_resident)),
    )


def has_kind_views(g: PartitionGraph) -> bool:
    """Whether a partition carries the kind views: the coverage bitmap
    over the kind-collapsed columns and the call-edge row offsets, with
    no CSR views (a JAX package's "all" build has those and the bitmap,
    and is packed). The port's kind build keeps the bitmap only; the
    JAX package's also unpacks it to ``cov_i8``, which the port never
    reads."""
    return (
        int(g.cov_bits.shape[-1]) > 0
        and int(g.ss_indptr.shape[-1]) > 0
        and int(g.inc_indptr_op.shape[-1]) == 0
    )


def choose_kernel(
    graph: WindowGraph,
    dense_budget_bytes: int | None = None,
    prefer_bf16: bool = False,
) -> str:
    """The auto kernel policy, by presence of the views the build made
    (graph.build.resolve_aux holds the budget policy), as
    ``jax_tpu.choose_kernel``: "kind" when both partitions carry the kind
    views; with bitmaps, "packed_bf16" / "packed" when their unpacked
    f32 matrices fit ``dense_budget_bytes``, else "packed_blocked"
    (always f32); "pcsr" with the partition-centric views; "csr" with
    the CSR views; else "coo" (the last resort, e.g. a stacked group
    whose windows were built with different views)."""
    if dense_budget_bytes is None:
        dense_budget_bytes = DEFAULT_DENSE_BUDGET_BYTES
    parts = (graph.normal, graph.abnormal)
    if all(has_kind_views(g) for g in parts):
        return "kind"
    if all(int(g.cov_bits.shape[-1]) > 0 for g in parts):
        unpacked = packed_unpacked_bytes(
            int(parts[0].cov_unique.shape[-1]),
            tuple(int(g.kind.shape[-1]) for g in parts),
        )
        if unpacked <= dense_budget_bytes:
            return "packed_bf16" if prefer_bf16 else "packed"
        return "packed_blocked"
    if all(int(g.pc_trace.shape[-1]) > 0 for g in parts):
        return "pcsr"
    if all(int(g.inc_indptr_op.shape[-1]) > 0 for g in parts):
        return "csr"
    return "coo"


def spmv_layouts(g: PartitionGraph, checked: bool = False
                 ) -> Tuple[RowLayout, RowLayout, RowLayout]:
    """K1's row layouts of the partition's three transition matrices:
    p_sr (rows = op, over traces), p_ss (rows = child op, over parent
    ops) and p_rs (rows = trace, over ops). Entries past the live
    counts are padding and are left out. A stacked group's partition
    gives block-diagonal layouts over its windows. ``checked``: the rows
    were checked on the host (``host_counts``), and no layout syncs."""
    v = g.cov_unique.shape[-1]
    t_pad = g.kind.shape[-1]
    return (
        row_layout(g.inc_op, g.inc_trace, g.sr_val, v, g.n_inc, n_x=t_pad, checked=checked),
        row_layout(g.ss_child, g.ss_parent, g.ss_val, v, g.n_ss, n_x=v, checked=checked),
        row_layout(g.inc_trace, g.inc_op, g.rs_val, t_pad, g.n_inc, n_x=v, checked=checked),
    )


def _host_spmv_layouts(g) -> list:
    """``spmv_layouts`` of one host partition as ``host_spmv_counts``
    reads them (``host_row_layout``)."""
    v, t_pad = int(g.cov_unique.shape[-1]), int(g.kind.shape[-1])
    return [
        host_row_layout(g.inc_op, g.inc_trace, v, g.n_inc, t_pad),
        host_row_layout(g.ss_child, g.ss_parent, v, g.n_ss, v),
        host_row_layout(g.inc_trace, g.inc_op, t_pad, g.n_inc, v),
    ]


def _require_csr_views(g: PartitionGraph) -> None:
    if g.inc_indptr_op.shape[-1] == 0:
        raise ValueError(
            "kernel='csr' needs the CSR views, but this window was "
            "built with aux='auto' inside the bitmap budget — build "
            "with aux='all' (or use kernel='packed')"
        )


def csr_layouts(g: PartitionGraph, checked: bool = False
                ) -> Tuple[RowLayout, RowLayout, RowLayout]:
    """K1's row layouts of the partition's three matrices read straight
    from the CSR views (``indptr_layout``, no sort): p_sr from
    ``inc_indptr_op`` over ``sr_val_opmajor`` / ``inc_trace_opmajor``,
    p_ss from ``ss_indptr`` over ``ss_val`` / ``ss_parent``, p_rs from
    ``inc_indptr_trace`` over ``rs_val`` / ``inc_op`` (the COO arrays are
    trace-major). Each row holds the entries ``spmv_layouts``' stable
    sort gives the pallas path, in the same order. A stacked group's
    partition gives block-diagonal layouts. ``checked`` is accepted for
    ``window_spmv_group``: no layout here syncs."""
    del checked
    _require_csr_views(g)
    v, t_pad = g.cov_unique.shape[-1], g.kind.shape[-1]
    return (
        indptr_layout(g.inc_indptr_op, g.inc_trace_opmajor, g.sr_val_opmajor, n_x=t_pad),
        indptr_layout(g.ss_indptr, g.ss_parent, g.ss_val, n_x=v),
        indptr_layout(g.inc_indptr_trace, g.inc_op, g.rs_val, n_x=v),
    )


def _host_csr_layouts(g) -> list:
    """``csr_layouts`` of one host partition as ``host_spmv_counts``
    reads them (``host_indptr_layout``)."""
    _require_csr_views(g)
    v, t_pad = int(g.cov_unique.shape[-1]), int(g.kind.shape[-1])
    return [
        host_indptr_layout(g.inc_indptr_op, g.inc_trace_opmajor, t_pad),
        host_indptr_layout(g.ss_indptr, g.ss_parent, v),
        host_indptr_layout(g.inc_indptr_trace, g.inc_op, v),
    ]


def _host_dense_checks(graph) -> None:
    """What ``densify`` takes on trust, checked on the host: every
    entry's row and column inside its matrix (an index out of range would
    fault the card's scatter). Raises ``IndexError``."""
    for g in (graph.normal, graph.abnormal):
        v, t = int(g.cov_unique.shape[-1]), int(g.kind.shape[-1])
        for name, a, n in (("inc_op", g.inc_op, v), ("inc_trace", g.inc_trace, t),
                           ("ss_child", g.ss_child, v), ("ss_parent", g.ss_parent, v)):
            a = np.asarray(a)
            if a.size and (a.min() < 0 or a.max() >= n):
                raise IndexError(f"densify: {name} outside [0, {n})")


# x slots of a step's group: (rv_n, sv_n, rv_a, sv_a). p_sr reads a
# partition's rv, p_ss and p_rs its sv.
STEP_X_SLOTS = (0, 1, 1, 2, 3, 3)


def window_spmv_group(graph: WindowGraph, layouts_of=spmv_layouts,
                      counts: Optional[SpmvCounts] = None) -> SpmvGroup:
    """K1's work list of one power-iteration step: the three matrices of
    the normal partition, then of the abnormal one (``layouts_of`` each
    partition), read from x slots ``STEP_X_SLOTS``. A stacked group's
    work list covers all its windows (``SpmvGroup.windows``). ``counts``:
    the work list's counts from the host graph (``host_counts``), with
    which the layouts and the work list are built without a host sync."""
    windows = stacked_windows(graph)
    layouts, n_x = [], []
    for g in (graph.normal, graph.abnormal):
        v, t_pad = g.cov_unique.shape[-1], g.kind.shape[-1]
        layouts += layouts_of(g) if counts is None else layouts_of(g, checked=True)
        n_x += [(windows or 1) * n for n in (t_pad, v, v)]
    return spmv_group(layouts, STEP_X_SLOTS, n_x, windows, counts)


def _require_pc_views(g: PartitionGraph) -> None:
    if g.pc_trace.shape[-1] == 0:
        raise ValueError(
            "kernel='pcsr' needs the partition-centric views, but this "
            "window was built without them: build with aux='pcsr' (aux='auto' "
            "resolves to it past a quarter of the dense budget in bitmaps)"
        )


def _compact(live: torch.Tensor, n_live: int, *tensors: torch.Tensor):
    """The entries of each tensor where ``live`` holds, in order, as
    ``t[live]`` gives them, for a live count ``n_live`` known on the
    host: every entry scattered to its live rank (the dead ones to a slot
    past the end, dropped), so nothing waits on the device."""
    flat = live.reshape(-1)
    dest = torch.where(flat, torch.cumsum(flat, 0) - 1, n_live)
    return tuple(
        t.reshape(-1).new_empty(n_live + 1).scatter_(0, dest, t.reshape(-1))[:n_live]
        for t in tensors
    )


def _pcsr_sr_layout(g: PartitionGraph, n_sr: Optional[int] = None) -> RowLayout:
    """K1's row layout of p_sr (rows = ops) read from the forward tables:
    entry j of partition p's table belongs to op o when its block
    j // PCSR_BLOCK lies in [pc_blk_indptr[p, o], pc_blk_indptr[p, o + 1]);
    its column is the global trace pc_trace + p * PCSR_PART_TRACES. Only
    the nonzero (live) entries are kept, ``n_sr`` of them (from the host,
    ``host_counts``; None counts them on the device, one host sync). A
    stacked group's partition ([B, P, .] tables) gives one block-diagonal
    layout: window b's rows at b * V, its columns at b * T, each row's
    entries in its window's order. A row lies in [0, B * V] by
    construction, so the layout needs no range check."""
    v, t_pad = g.cov_unique.shape[-1], g.kind.shape[-1]
    lead = tuple(g.pc_trace.shape[:-2])
    n_parts, e_blk = g.pc_trace.shape[-2:]
    dev = g.pc_trace.device
    blocks = torch.arange(e_blk // PCSR_BLOCK, dtype=torch.int64, device=dev)
    block_op = torch.searchsorted(
        g.pc_blk_indptr[..., 1:].to(torch.int64).contiguous(),
        blocks.expand(*lead, n_parts, -1).contiguous(),
        right=True,
    )
    live = g.pc_sr_val != 0
    rows = block_op.repeat_interleave(PCSR_BLOCK, dim=-1)
    part_base = torch.arange(n_parts, dtype=torch.int32, device=dev)[:, None] * PCSR_PART_TRACES
    cols = g.pc_trace + part_base
    if lead:
        win = torch.arange(lead[0], dtype=torch.int32, device=dev)[:, None, None]
        rows, cols = rows + win * v, cols + win * t_pad
    n_rows = (lead[0] if lead else 1) * v
    if n_sr is None:
        n_sr = int(live.sum())
    rows, cols, vals = _compact(live, n_sr, rows, cols, g.pc_sr_val)
    return row_layout(rows.to(torch.int32), cols, vals, n_rows, checked=True)


def pcsr_layouts(g: PartitionGraph) -> Tuple[RowLayout, RowLayout, RowLayout]:
    """K1's row layouts of p_sr, p_ss and p_rs read from the
    partition-centric views instead of the COO incidence arrays: p_sr
    from the forward tables (``_pcsr_sr_layout``), p_rs the ELL slab's
    rows, p_ss the call-edge list as the pallas path reads it. The rank
    path reads p_rs from the slab itself (``window_pcsr_group``); this
    work list of all three is the pcsr kernel's earlier design, which
    the tests and chip_smoke.py hold the slab against.

    Liveness: a live value is never 0 (sr_val = 1 / tracelen, rs_val =
    1 / cov_dup) and every padding value is (the block padding inside
    each (partition, op) run, the slab's tail), so the nonzero entries
    are the live ones; each table must hold ``n_inc`` of them. A row
    then holds the entries of the pallas path's ``spmv_layouts`` in the
    same order (an op's traces ascending, partition by partition; a
    trace's ops ascending), and K1, whose sums depend on a row's entries
    and their order alone, gives the same bits."""
    _require_pc_views(g)
    t_pad = g.kind.shape[0]
    sr = _pcsr_sr_layout(g)
    ell_live = g.pc_ell_rs != 0
    rs_rows = torch.arange(t_pad, dtype=torch.int32, device=g.pc_ell_op.device)[:, None]
    rs_rows = rs_rows.expand_as(g.pc_ell_op)[ell_live]
    _check_pc_liveness(g, sr.cols.shape[0], rs_rows.shape[0])
    return (
        sr,
        row_layout(g.ss_child, g.ss_parent, g.ss_val, sr.n_rows, g.n_ss),
        row_layout(rs_rows, g.pc_ell_op[ell_live], g.pc_ell_rs[ell_live], t_pad),
    )


def _check_pc_liveness(g: PartitionGraph, n_sr: int, n_rs: int) -> None:
    n_inc = int(g.n_inc)
    if not n_sr == n_rs == n_inc:
        raise ValueError(
            f"pcsr views hold {n_sr} forward and {n_rs} backward nonzero "
            f"entries, not n_inc={n_inc}"
        )


def _ell_checks(g: PartitionGraph) -> Tuple[torch.Tensor, torch.Tensor]:
    """A partition's ELL slab row lengths, and what the pcsr kernel takes
    on trust about the slab, as counts on the device: (nonzero entries,
    live entries after a padding slot of their row, live ops outside
    [0, V), nonzero forward entries, n_inc), each a window's for a
    stacked group ([B, 5]). The kernel reads a row's live entries as a
    prefix of its length and does not check ops."""
    live = g.pc_ell_rs != 0
    ops = g.pc_ell_op
    v = g.cov_unique.shape[-1]
    lens = live.sum(-1, dtype=torch.int32)
    return lens, torch.stack([
        lens.sum(-1, dtype=torch.int64),
        (live[..., 1:] & ~live[..., :-1]).sum((-2, -1)),
        (live & ((ops < 0) | (ops >= v))).sum((-2, -1)),
        (g.pc_sr_val != 0).sum((-2, -1)),
        g.n_inc.to(torch.int64),
    ], -1)


# x slots of a pcsr step's work list (p_sr, p_ss of each partition) and
# of its ELL slabs (p_rs), and where each lands in the step's order
# (STEP_X_SLOTS: sr_n, ss_n, rs_n, sr_a, ss_a, rs_a).
PCSR_ROW_SLOTS = (0, 1, 2, 3)
PCSR_ELL_SLOTS = (1, 3)
PCSR_ORDER = (0, 1, 4, 2, 3, 5)


class PcsrCounts(NamedTuple):
    """What ``window_pcsr_group`` otherwise reads back from the device,
    counted on the host graph (``host_counts``): the work list's counts,
    and per partition its live forward entries (p_sr's layout) and its
    live ELL entries (the slab's read mode)."""

    rows: SpmvCounts
    n_sr: Tuple[int, int]
    n_ell: Tuple[int, int]


def _check_pcsr_views(parts, checks, windows) -> None:
    """Raise on what the pcsr kernel takes on trust, from each
    partition's per-window counts (``_ell_checks`` on the device,
    ``_host_ell_checks`` on the host): (nonzero ELL entries, live entries
    after padding, ops outside [0, V), nonzero forward entries, n_inc)."""
    for g, per_window in zip(parts, checks):
        for b, (n_rs, gaps, bad_ops, n_sr, n_inc) in enumerate(per_window):
            where = "" if windows is None else f" (window {b})"
            if not n_sr == n_rs == n_inc:
                raise ValueError(
                    f"pcsr views hold {n_sr} forward and {n_rs} backward nonzero "
                    f"entries, not n_inc={n_inc}{where}"
                )
            if gaps or bad_ops:
                raise ValueError(
                    f"pcsr ELL slab: {gaps} live entries after padding, "
                    f"{bad_ops} ops outside [0, {g.cov_unique.shape[-1]}){where}"
                )


def window_pcsr_group(graph: WindowGraph, counts: Optional[PcsrCounts] = None) -> PcsrGroup:
    """The pcsr kernel's step, built once per window from the
    partition-centric views: K1's work list of p_sr (``_pcsr_sr_layout``)
    and p_ss of both partitions, and each partition's ELL slab as it
    lies on the device (p_rs), with its row lengths and the mode the
    kernel reads it in (``ell_mode``). Checks that each partition's
    tables hold ``n_inc`` live entries, that every slab row's live
    entries form a prefix and that their ops index x: with one host sync
    here, or none where ``counts`` come from the host graph, whose checks
    ``host_counts`` made.

    A stacked group of B windows: the work list block-diagonal over the
    windows (``_pcsr_sr_layout``, ``row_layout``), each partition's slabs
    one slab of B * T rows (window b's rows after window b - 1's, its
    live ops moved by b * V into the flat x), read in one mode (which
    moves no bit, ``ell_mode``); the checks are each window's, still
    one sync for the group."""
    windows = stacked_windows(graph)
    parts = (graph.normal, graph.abnormal)
    layouts, n_x, lens, device_counts = [], [], [], []
    for i, g in enumerate(parts):
        _require_pc_views(g)
        v, t_pad = g.cov_unique.shape[-1], g.kind.shape[-1]
        layouts += [
            _pcsr_sr_layout(g, None if counts is None else counts.n_sr[i]),
            row_layout(g.ss_child, g.ss_parent, g.ss_val, v, g.n_ss, n_x=v,
                       checked=counts is not None),
        ]
        n_x += [(windows or 1) * n for n in (t_pad, v)]
        if counts is None:
            row_lens, c = _ell_checks(g)
            device_counts.append(c.reshape(-1, c.shape[-1]))
        else:
            row_lens = (g.pc_ell_rs != 0).sum(-1, dtype=torch.int32)
        lens.append(row_lens.reshape(-1))
    if counts is None:
        checks = torch.stack(device_counts).tolist()
        _check_pcsr_views(parts, checks, windows)
        n_ell = [sum(w[0] for w in per_window) for per_window in checks]
    else:
        n_ell = counts.n_ell
    ell = []
    for g, slot, row_lens, n_live in zip(parts, PCSR_ELL_SLOTS, lens, n_ell):
        ops, vals = g.pc_ell_op, g.pc_ell_rs
        if windows is not None:
            win = torch.arange(windows, dtype=torch.int32, device=ops.device)[:, None, None]
            ops = torch.where(vals != 0, ops + win * g.cov_unique.shape[-1], 0)
            ops, vals = ops.reshape(-1, ops.shape[-1]), vals.reshape(-1, vals.shape[-1])
        ell.append(EllPart(ops.contiguous(), vals.contiguous(), slot, row_lens,
                           ell_mode(ops.shape[1], ops.shape[0], n_live)))
    return PcsrGroup(
        rows=spmv_group(layouts, PCSR_ROW_SLOTS, n_x, windows,
                        None if counts is None else counts.rows),
        ell=tuple(ell),
        order=PCSR_ORDER,
    )


def _per_window(mask: np.ndarray, n_win: int) -> np.ndarray:
    """The true entries of each window's slice of ``mask``, int64 [B]."""
    return np.count_nonzero(mask.reshape(n_win, -1), axis=1).astype(np.int64)


def _host_ell_checks(g, sr_live: np.ndarray) -> np.ndarray:
    """``_ell_checks``' counts of one host partition, in numpy: [B, 5]
    (one row for a window); ``sr_live`` its forward tables' nonzero
    entries."""
    live = np.asarray(g.pc_ell_rs) != 0
    ops = np.asarray(g.pc_ell_op)
    v = int(g.cov_unique.shape[-1])
    n_win = live.shape[0] if live.ndim == 3 else 1
    width = live.shape[-1]
    # A live slot after a dead one, over the flat slab (contiguous), less
    # the pairs that straddle two rows (a row's first slot after the
    # previous row's last).
    flat = live.reshape(n_win, -1)
    gaps = (_per_window(flat[:, 1:] > flat[:, :-1], n_win)
            - _per_window(flat[:, width::width] > flat[:, width - 1:-1:width], n_win))
    return np.stack([
        _per_window(live, n_win),
        gaps,
        _bad_ops(live, ops, v, n_win),
        _per_window(sr_live, n_win),
        np.asarray(g.n_inc).reshape(-1).astype(np.int64),
    ], 1)


def _bad_ops(live: np.ndarray, ops: np.ndarray, v: int, n_win: int) -> np.ndarray:
    """Each window's live ELL entries whose op lies outside [0, v) (a
    negative op reads as a large unsigned one). Padding holds op 0, so
    they are only counted where some op is out of range."""
    if not ops.size or (ops.min() >= 0 and ops.max() < v):
        return np.zeros(n_win, np.int64)
    return _per_window((ops.view(np.uint32) >= v) & live, n_win)


def _block_counts(live: np.ndarray) -> np.ndarray:
    """The true entries of each block of PCSR_BLOCK (8) consecutive
    entries of a bool array whose last axis is whole blocks: each block
    read as one uint64 of 0 / 1 bytes, whose bytes a multiply sums into
    the top byte."""
    words = np.ascontiguousarray(live).view(np.uint64)
    return (words * np.uint64(0x0101010101010101)) >> np.uint64(56)


def _host_pcsr_sr_layout(g, sr_live: np.ndarray) -> Tuple[np.ndarray, int]:
    """``_pcsr_sr_layout`` of one host partition as ``host_spmv_counts``
    reads it: (indptr, the live entries whose global column lies outside
    the x); ``sr_live`` its forward tables' nonzero entries. A block's
    op is the count of ``pc_blk_indptr[..., 1:]`` at or below it (the
    device's ``searchsorted(..., right=True)``), which needs the offsets
    sorted: unsorted ones raise."""
    assert PCSR_BLOCK == 8  # _block_counts reads a block as one uint64
    pc_trace = np.asarray(g.pc_trace)
    indptr = np.asarray(g.pc_blk_indptr).astype(np.int64)
    v, t_pad = int(g.cov_unique.shape[-1]), int(g.kind.shape[-1])
    n_parts, e_blk = pc_trace.shape[-2:]
    n_win = pc_trace.shape[0] if pc_trace.ndim == 3 else 1
    n_blk = e_blk // PCSR_BLOCK
    if (np.diff(indptr, axis=-1) < 0).any():
        raise ValueError("pcsr views: block offsets pc_blk_indptr are not sorted")
    runs = n_win * n_parts
    bounds = np.clip(indptr[..., 1:].reshape(runs, -1), 0, n_blk)
    hist = np.bincount((np.arange(runs)[:, None] * (n_blk + 1) + bounds).ravel(),
                       minlength=runs * (n_blk + 1)).reshape(runs, n_blk + 1)
    block_op = np.cumsum(hist[:, :n_blk], axis=1).reshape(n_win, n_parts, n_blk)
    key = block_op + (np.arange(n_win) * v)[:, None, None]
    n_rows = n_win * v
    row_len = np.bincount(key.ravel(), weights=_block_counts(sr_live).ravel(),
                          minlength=n_rows + 1)
    indptr_rows = np.concatenate([[0], np.cumsum(row_len[:n_rows].astype(np.int64))])
    # A live entry's global column pc_trace + p * PCSR_PART_TRACES +
    # b * T must lie in [0, B * T): bounds on pc_trace per (window,
    # partition), compared in int32.
    base = ((np.arange(n_parts) * PCSR_PART_TRACES)[None, :, None]
            + (np.arange(n_win) * t_pad)[:, None, None]).astype(np.int32)
    trace = pc_trace.reshape(n_win, n_parts, e_blk)
    # Padding holds column 0 of its partition, in range: where every
    # partition's extremes are in range, no live entry is out of it.
    if (trace.min(-1, keepdims=True) >= -base).all() and (
            trace.max(-1, keepdims=True) < n_win * t_pad - base).all():
        return indptr_rows, 0
    # Only live entries of a counted row are checked (a block past the
    # last op's run sorts past every row); a negative column reads as a
    # large unsigned one.
    bad = ((trace + base).view(np.uint32) >= n_win * t_pad) & sr_live.reshape(trace.shape)
    bad = bad.reshape(n_win, n_parts, n_blk, PCSR_BLOCK) & (key < n_rows)[..., None]
    return indptr_rows, int(np.count_nonzero(bad))


def _host_pcsr_counts(graph) -> PcsrCounts:
    """``PcsrCounts`` of a host graph, with ``window_pcsr_group``'s
    checks raised on the host."""
    parts = (graph.normal, graph.abnormal)
    for g in parts:
        _require_pc_views(g)
    sr_live = [np.asarray(g.pc_sr_val) != 0 for g in parts]
    checks = [_host_ell_checks(g, live) for g, live in zip(parts, sr_live)]
    windows = checks[0].shape[0] if np.asarray(graph.normal.pc_trace).ndim == 3 else None
    _check_pcsr_views(parts, [c.tolist() for c in checks], windows)
    layouts = []
    for g, live in zip(parts, sr_live):
        v = int(g.cov_unique.shape[-1])
        layouts += [_host_pcsr_sr_layout(g, live),
                    host_row_layout(g.ss_child, g.ss_parent, v, g.n_ss, v)]
    return PcsrCounts(
        rows=host_spmv_counts(layouts),
        n_sr=tuple(int(c[:, 3].sum()) for c in checks),
        n_ell=tuple(int(c[:, 0].sum()) for c in checks),
    )


def ss_layout(g: PartitionGraph, kernel: str, checked: bool = False) -> RowLayout:
    """K1's row layout of the call-graph term of the kind and packed
    kernels. kind: the child-sorted edge list as it stands (rows from
    ss_indptr, values ss_val), summed against sv, as JAX's scatter-free
    ``ss_rowsum``. packed: the same edges with value 1, summed against
    op(sv * w_out) — the pattern kernel's x_ss — which is the unique-edge
    bitmap B_ss times that vector, without building B_ss. A stacked
    group's partition gives one block-diagonal layout over its windows
    (kind: window b's row offsets moved by b times the padded edge
    count, its parents by b times V; a parent outside [0, V) becomes -1,
    which ``spmv_group`` refuses). ``checked``: the rows were checked on
    the host (``ss_host_counts``), so the layout makes no host sync."""
    v = g.cov_unique.shape[-1]
    dev = g.ss_parent.device
    if kernel == "kind":
        if g.ss_parent.dim() == 1:
            e = g.ss_parent.shape[0]
            return RowLayout(
                indptr=g.ss_indptr, cols=g.ss_parent, vals=g.ss_val,
                perm=torch.arange(e, device=dev), n_rows=int(v),
            )
        n_win, e = g.ss_parent.shape
        win = torch.arange(n_win, device=dev)[:, None]
        parent = g.ss_parent
        return RowLayout(
            indptr=torch.cat([
                (g.ss_indptr[:, :-1] + win * e).reshape(-1),
                g.ss_indptr[-1, -1:] + (n_win - 1) * e,
            ]).to(torch.int32),
            cols=torch.where((parent >= 0) & (parent < v), parent + win * v, -1)
            .reshape(-1).to(torch.int32),
            vals=g.ss_val.reshape(-1),
            perm=torch.arange(n_win * e, device=dev),
            n_rows=int(n_win * v),
        )
    ones = torch.ones(g.ss_parent.shape, dtype=torch.float32, device=dev)
    return row_layout(g.ss_child, g.ss_parent, ones, v, g.n_ss, n_x=v, checked=checked)


# Routes whose call-graph terms are K1's work list beside the pattern
# pair (``ss_host_counts``).
PATTERN_KERNELS = ("kind", "packed", "packed_bf16", "packed_blocked")
# Routes whose step is K1's six SpMVs in one launch, and the dense ones.
K1_KERNELS = ("pallas", "coo", "csr")
DENSE_KERNELS = ("dense", "dense_bf16")


def _ss_host_layout(g, kernel: str) -> Tuple[np.ndarray, int]:
    """``ss_layout`` of one host partition as numpy, for
    ``host_spmv_counts``: (indptr, the live entries whose column lies
    outside the x), a stacked partition's block-diagonal over its
    windows. Raises ``row_layout``'s ValueError on a live row outside
    [0, n_rows]."""
    v = int(g.cov_unique.shape[-1])
    if kernel != "kind":
        return host_row_layout(g.ss_child, g.ss_parent, v, g.n_ss, v)
    parent = np.asarray(g.ss_parent).astype(np.int64)
    stacked = parent.ndim == 2
    n_win, e = parent.shape if stacked else (1, parent.shape[0])
    win = np.arange(n_win)[:, None]
    if stacked:
        parent = np.where((parent >= 0) & (parent < v), parent + win * v, -1)
    parent = parent.reshape(-1)
    indptr = np.asarray(g.ss_indptr).astype(np.int64)
    if stacked:
        indptr = np.concatenate([
            (indptr[:, :-1] + win * e).reshape(-1), indptr[-1, -1:] + (n_win - 1) * e,
        ])
    live = parent[: indptr[-1]]
    return indptr, int(np.count_nonzero((live < 0) | (live >= n_win * v)))


def ss_host_counts(graph, kernel: str) -> Optional[SpmvCounts]:
    """The counts of the call-graph terms' work list (``device_subset``
    of the kind and packed routes), computed on the host graph with its
    checks; None for a route without that work list (pcsr, pallas:
    ``host_counts``)."""
    if kernel not in PATTERN_KERNELS:
        return None
    return host_spmv_counts([_ss_host_layout(g, kernel) for g in (graph.normal, graph.abnormal)])


def host_counts(graph, kernel: str):
    """What ``device_subset`` of ``kernel`` would read back from the
    device, computed on the host graph with its checks (the same
    ``ValueError`` / ``IndexError`` on a bad view, row or column), so
    that the device side of a window issues without a host sync: the
    call-graph terms' counts on the pattern routes (``ss_host_counts``),
    the six SpMVs' on pallas, coo and csr, ``PcsrCounts`` on pcsr; on
    dense and dense_bf16 nothing is counted (None), the entries' indices
    are checked."""
    _check_kernel(kernel)
    parts = (graph.normal, graph.abnormal)
    if kernel == "pcsr":
        return _host_pcsr_counts(graph)
    if kernel in ("pallas", "coo"):
        return host_spmv_counts([lay for g in parts for lay in _host_spmv_layouts(g)])
    if kernel == "csr":
        return host_spmv_counts([lay for g in parts for lay in _host_csr_layouts(g)])
    if kernel in DENSE_KERNELS:
        _host_dense_checks(graph)
        return None
    return ss_host_counts(graph, kernel)


def window_pattern_group(
    graph: WindowGraph,
    kernel: str,
    packed_block_bytes: int = PageRankConfig.packed_block_bytes,
) -> PatternGroup:
    """Both partitions' coverage bitmaps as one pattern-pair launch reads
    them, over the padded trace (or kind) axis: K2 reads the kind build's
    bitmap, K4 the packed build's. Under "packed_blocked" the group
    launches K8's own kernel (``blocked``), and the plain version unpacks
    bands of at most ``packed_block_bytes``."""
    parts = (graph.normal, graph.abnormal)
    if kernel == "kind":
        if not all(has_kind_views(g) for g in parts):
            raise ValueError(
                "kernel='kind' needs the kind views, but this window was "
                "built without them: build with aux='kind' (collapse_kinds "
                "!= 'off' resolves aux='auto' to it past the dedup threshold)"
            )
        w_outs = [None, None]
    else:
        if any(g.cov_bits.shape[-1] == 0 for g in parts):
            raise ValueError(
                f"kernel={kernel!r} needs the coverage bitmaps, but this "
                "window was built without them: build with aux='packed'"
            )
        w_outs = [g.inv_outdeg for g in parts]
    return pattern_group(
        [g.cov_bits for g in parts],
        [g.inv_tracelen for g in parts],
        [g.inv_cov_dup for g in parts],
        w_outs,
        [g.kind.shape[-1] for g in parts],
        band_bytes=packed_block_bytes if kernel == "packed_blocked" else None,
        blocked=kernel == "packed_blocked",
    )


def _partition_setup(
    g: PartitionGraph, anomaly: bool, cfg: PageRankConfig, kernel: str = "pallas"
):
    """One partition's iteration ingredients: (pref, sv0, rv0), by the
    set-up's plain version (``ops.setup.partition_setup_plain``; the rank
    program takes both partitions' from one ``rank_setup`` call)."""
    _check_kernel(kernel)
    return partition_setup_plain(g, anomaly, cfg)


# One partition's finish by the epilogue's plain version (the rank
# program takes both partitions' and the ranking from one
# ``rank_epilogue`` call).
_partition_finish = partition_finish


def window_weights_full(
    graph: WindowGraph, pagerank_cfg: PageRankConfig, kernel: str = "pallas"
):
    """Both partitions' PageRank weights, stepped together, with the
    per-partition convergence trace.

    Returns (n_weight[V], a_weight[V], rv_n[T_n], rv_a[T_a],
    residuals[2, I], n_iters int32, score_n[V], score_a[V]); residual
    row 0 is the normal partition, row 1 the abnormal one. A stacked
    group of B windows (``stack_window_graphs``) gives each with a
    leading [B] axis: one program, one launch of each kernel a step for
    all of them, each window frozen on its own step under ``tol``.
    """
    out = _rank_program(graph, pagerank_cfg, SpectrumConfig(), kernel)
    return (out.epilogue.n_weight, out.epilogue.a_weight, out.rv_n, out.rv_a, out.residuals,
            out.n_iters, out.epilogue.score_n, out.epilogue.score_a)


class _Program(NamedTuple):
    """What one rank program leaves on the device."""

    epilogue: Epilogue
    sv_n: torch.Tensor  # the final carry
    rv_n: torch.Tensor
    sv_a: torch.Tensor
    rv_a: torch.Tensor
    residuals: torch.Tensor
    n_iters: torch.Tensor
    check: Optional[torch.Tensor] = None  # K14's check word (a checked program)


def _step_group_type(kernel: str):
    """The type of ``WindowGraph.spmv_group`` that ``device_subset``
    builds for ``kernel``."""
    if kernel == "pcsr":
        return PcsrGroup
    return DenseGroup if kernel in DENSE_KERNELS else SpmvGroup


# The epilogues a rank program can end in (``_rank_program``).
EPILOGUES = ("one_method", "checked", "checked_traced", "all_methods")


def _rank_program(
    graph: WindowGraph,
    pagerank_cfg: PageRankConfig,
    spectrum_cfg: SpectrumConfig,
    kernel: str,
    epilogue: str = "one_method",
) -> _Program:
    """The rank program: the set-up (one ``rank_setup`` call for both
    partitions), the 25 steps, the epilogue (one launch: the finish of
    both partitions, the spectrum and the top-k). ``epilogue``:
    "one_method" ranks by the configured formula (``rank_epilogue``);
    "checked" (K14) adds the epilogue's check word over the ranking
    (JAX's ``rank_window_checked_core``), "checked_traced" over the
    residual trace too (``rank_window_checked_traced_core``);
    "all_methods" (K13) ranks by every formula
    (``rank_epilogue_all_methods``, [(B,) M, k])."""
    _check_kernel(kernel)
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r} (expected one of {EPILOGUES})")
    cfg = pagerank_cfg
    windows = stacked_windows(graph)
    lead = () if windows is None else (windows,)
    int8 = kernel == "kind" and cfg.kind_precision == "int8"
    (pref_n, sv_n, rv_n), (pref_a, sv_a, rv_a) = rank_setup(graph.normal, graph.abnormal, cfg)
    pattern_route = kernel in PATTERN_KERNELS
    if (
        not isinstance(graph.spmv_group, _step_group_type(kernel))
        or (graph.pattern_group is None) == pattern_route
        or graph.step_scratch is None
    ):
        graph = device_subset(graph, kernel, cfg.packed_block_bytes)
    group = graph.spmv_group
    pgroup = graph.pattern_group
    if not pattern_route:
        if kernel == "pcsr":
            six = pcsr_spmv_group
        else:
            six = dense_matvecs if kernel in DENSE_KERNELS else coo_spmv_group

        def products(old_n, old_a, scales):
            # One call: all six products of the step (x slots
            # STEP_X_SLOTS).
            ys = six(group, (old_n[1], old_n[0], old_a[1], old_a[0]))
            return ys[:3], ys[3:]

    else:
        if kernel == "kind":
            precision = cfg.kind_precision
        else:
            precision = "bf16" if kernel == "packed_bf16" else "f32"

        def products(old_n, old_a, scales):
            # One pattern-pair call (both partitions, both directions),
            # then one K1 call for both call-graph terms.
            rvs, svs = (old_n[1], old_a[1]), (old_n[0], old_a[0])
            (f_n, b_n, x_n), (f_a, b_a, x_a) = pattern_pair_group(
                pgroup, rvs, svs, precision, scales
            )
            ss_n, ss_a = coo_spmv_group(
                group,
                (old_n[0] if x_n is None else x_n, old_a[0] if x_a is None else x_a),
            )
            return (f_n, ss_n, b_n), (f_a, ss_a, b_a)

    dev = sv_n.device
    n_steps = int(cfg.iterations)
    plan = step_plan(
        (pref_n, pref_a), cfg.call_weight, cfg.damping, cfg.tol,
        cfg.max_normalize_each_iter, graph.step_scratch, pgroup if int8 else None,
    )
    carry = ((sv_n, rv_n), (sv_a, rv_a))
    # int8: the first step's operand scales here, once; every later
    # step's come from the step that writes its vectors.
    scales = quantize_scales(pgroup, (rv_n, rv_a), (sv_n, sv_a)) if int8 else None
    residuals = torch.zeros(lead + (2, n_steps), dtype=torch.float32, device=dev)
    n_iters = running = None
    if cfg.tol is not None:
        running = torch.ones(lead, dtype=torch.bool, device=dev)
        n_iters = torch.zeros(lead, dtype=torch.int32, device=dev)
    # K5's state, set up once: the checks, two carry buffers, and on the
    # card the kernel's arguments; each step then passes its products.
    steps = StepWindow(plan, carry, residuals, n_iters, running)
    for i in range(n_steps):
        ys = products(*carry, scales)
        carry, scales = steps.step(ys, i, want_scales=int8 and i + 1 < n_steps)
    if n_iters is None:
        n_iters = torch.full(lead, n_steps, dtype=torch.int32, device=dev)
    (sv_n, rv_n), (sv_a, rv_a) = carry
    word = None
    parts = (graph.normal, graph.abnormal, sv_n, sv_a, spectrum_cfg)
    if epilogue == "one_method":
        out = rank_epilogue(*parts)
    elif epilogue == "all_methods":
        out = rank_epilogue_all_methods(*parts)
    else:
        traced = epilogue == "checked_traced"
        out, word = rank_epilogue_checked(*parts, residuals if traced else None,
                                          n_iters if traced else None)
    return _Program(out, sv_n, rv_n, sv_a, rv_a, residuals, n_iters, word)


def _finish_topk(graph: WindowGraph, n_weight, a_weight, spectrum_cfg):
    """Spectrum + top-k tail by the epilogue's plain version: (top_idx
    int32[k], top_scores float32[k], n_valid int32)."""
    return finish_topk(graph.normal, graph.abnormal, n_weight, a_weight, spectrum_cfg)


def rank_window_traced_core(
    graph: WindowGraph,
    pagerank_cfg: PageRankConfig,
    spectrum_cfg: SpectrumConfig,
    kernel: str = "pallas",
):
    """The full single-window ranking with its convergence trace:
    (top_idx int32[k], top_scores float32[k], n_valid int32,
    residuals float32[2, I], n_iters int32), all still on the device.
    Indices point into the shared window op vocab; entries past
    ``n_valid`` are padding (score -inf). On a stacked group of B
    windows (K18, the counterpart of JAX's vmapped program) every output
    gains a leading [B] axis: top_idx [B, k], residuals [B, 2, I],
    n_iters [B]."""
    out = _rank_program(graph, pagerank_cfg, spectrum_cfg, kernel)
    return (out.epilogue.top_idx, out.epilogue.top_scores, out.epilogue.n_valid,
            out.residuals, out.n_iters)


class DeviceCheckError(RuntimeError):
    """A checked rank program's in-program check failed (K14; JAX raises
    ``checkify.JaxRuntimeError``): the message is JAX's message of the
    first failed check, in JAX's order of checks."""


def rank_window_checked_core(graph, pagerank_cfg, spectrum_cfg, kernel: str = "coo"):
    """JAX's ``rank_window_checked_core`` (K14): the window's ranking
    (top_idx, top_scores, n_valid) and its check word (int32: live
    scores finite, 0 <= n_valid <= k), all still on the device; fetch
    with ``fetch_rank_outputs(..., checked=True)``, which raises on the
    word."""
    out = _rank_program(graph, pagerank_cfg, spectrum_cfg, kernel, "checked")
    e = out.epilogue
    return e.top_idx, e.top_scores, e.n_valid, out.check


def rank_window_checked_traced_core(graph, pagerank_cfg, spectrum_cfg, kernel: str = "coo"):
    """JAX's ``rank_window_checked_traced_core`` (K14): the five outputs
    of ``rank_window_traced_core`` and the check word, whose third check
    is that the live residuals (step < n_iters) are finite."""
    out = _rank_program(graph, pagerank_cfg, spectrum_cfg, kernel, "checked_traced")
    e = out.epilogue
    return e.top_idx, e.top_scores, e.n_valid, out.residuals, out.n_iters, out.check


def rank_window_checked(graph, pagerank_cfg, spectrum_cfg, kernel: str = "coo"):
    """``rank_window_checked_core`` fetched in one copy: (top_idx,
    top_scores, n_valid) on the host, or ``DeviceCheckError`` naming the
    failed check (JAX's ``rank_window_checked``, which raises
    ``checkify.JaxRuntimeError``)."""
    return fetch_rank_outputs(rank_window_checked_core(graph, pagerank_cfg, spectrum_cfg, kernel),
                              checked=True)


def rank_window_checked_traced(graph, pagerank_cfg, spectrum_cfg, kernel: str = "coo"):
    """``rank_window_checked_traced_core`` fetched in one copy: the five
    outputs on the host, or ``DeviceCheckError``."""
    return fetch_rank_outputs(
        rank_window_checked_traced_core(graph, pagerank_cfg, spectrum_cfg, kernel), checked=True)


def rank_window_all_methods_core(graph: WindowGraph, pagerank_cfg: PageRankConfig,
                                 spectrum_cfg: SpectrumConfig, kernel: str = "coo"):
    """JAX's ``rank_window_all_methods_core`` (K13): one window ranked
    under every formula of ``spectrum.formulas.METHODS`` in one program,
    the set-up and steps once and one epilogue launch: (top_idx
    int32[M, k], top_scores float32[M, k], n_valid int32), rows in
    METHODS order, still on the device (``spectrum_cfg.method`` is not
    read). A stacked group raises: JAX has no batched all-methods
    program."""
    if stacked_windows(graph) is not None:
        raise ValueError("rank_window_all_methods_core ranks one window; JAX has no "
                         "batched all-methods program")
    e = _rank_program(graph, pagerank_cfg, spectrum_cfg, kernel, "all_methods").epilogue
    return e.top_idx, e.top_scores, e.n_valid


def rank_window_all_methods(graph: WindowGraph, pagerank_cfg: PageRankConfig,
                            spectrum_cfg: SpectrumConfig, kernel: str = "coo"):
    """``rank_window_all_methods_core`` fetched in one device-to-host
    copy: (top_idx [M, k], top_scores [M, k], n_valid) on the host."""
    return fetch_rank_outputs(
        rank_window_all_methods_core(graph, pagerank_cfg, spectrum_cfg, kernel))


def _raise_on_check_word(word) -> None:
    """``DeviceCheckError`` with JAX's message of the first failed check
    of a fetched check word (an int, or an array of a group's)."""
    bits = int(np.bitwise_or.reduce(np.asarray(word, dtype=np.int32).reshape(-1)))
    for bit, message in CHECK_MESSAGES:
        if bits & bit:
            raise DeviceCheckError(message)


class PackedOutputs(NamedTuple):
    """rank_window_traced_core's five outputs packed into one float32
    host buffer (int32 values ride bit-for-bit through ``view``), with
    the event that marks its copy done (None on the CPU, where the pack
    is the host buffer itself) and the outputs' shapes (a stacked
    group's carry a leading [B] axis; the all-methods program's top-k
    is [M, k])."""

    host: torch.Tensor
    ready: Optional[torch.cuda.Event]
    shapes: Tuple[Tuple[int, ...], ...]
    # The window's staged blob in pinned host memory (blob staging),
    # held until the outputs are fetched, so that no later pack can
    # reuse its bytes while their copy to the card may be in flight.
    staged: Optional[torch.Tensor] = None
    # The last output is a checked program's check word (K14), which
    # the unpack raises on and leaves out.
    checked: bool = False


def pack_rank_outputs(outs, staged: Optional[torch.Tensor] = None,
                      checked: bool = False) -> PackedOutputs:
    """Pack the five outputs into one buffer on their device and start
    its one device-to-host copy, all on the current stream: on CUDA a
    ``non_blocking`` copy into pinned host memory and an event recorded
    behind it, so the caller returns without waiting for the device.
    One copy for a stacked group's outputs too. ``staged``: the pinned
    blob the program's graph was copied from, held with the outputs.
    ``checked``: the last output is a checked program's check word,
    which rides the same copy."""
    packed = torch.cat([
        t.reshape(-1) if t.dtype == torch.float32 else t.reshape(-1).view(torch.float32)
        for t in outs
    ])
    ready = None
    if packed.device.type == "cuda":
        host = torch.empty(packed.shape, dtype=torch.float32, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(packed.device))
        packed = host
    return PackedOutputs(packed, ready, tuple(tuple(t.shape) for t in outs), staged, checked)


# The dtypes of rank_window_traced_core's outputs, in order.
_OUT_DTYPES = (np.int32, np.float32, np.int32, np.float32, np.int32)


def unpack_rank_outputs(p: PackedOutputs):
    """Wait for the copy of ``pack_rank_outputs`` (its event only, not
    the device) and unpack it on the host as numpy (top_idx, top_scores,
    n_valid, residuals, n_iters): n_valid and n_iters as ints for one
    window, [B] arrays for a stacked group. A checked program's outputs
    raise ``DeviceCheckError`` where its check word says a check
    failed, and come out without the word."""
    if p.ready is not None:
        p.ready.synchronize()
    host, out, at = p.host.numpy(), [], 0
    n_outs = len(p.shapes) - p.checked
    dtypes = _OUT_DTYPES[:n_outs] + ((np.int32,) if p.checked else ())
    for shape, dtype in zip(p.shapes, dtypes):
        n = int(np.prod(shape))
        arr = host[at: at + n].view(dtype).reshape(shape).copy()
        out.append(int(arr) if shape == () else arr)
        at += n
    if p.checked:
        _raise_on_check_word(out.pop())
    return tuple(out)


def fetch_rank_outputs(outs, checked: bool = False):
    """One device-to-host copy of rank_window_traced_core's outputs (or
    a checked program's, raising on its check word), waited for:
    ``unpack_rank_outputs(pack_rank_outputs(outs, checked=checked))``."""
    return unpack_rank_outputs(pack_rank_outputs(outs, checked=checked))


# Fields each kernel never reads, dropped on the host before the graph
# is copied to the device (jax_tpu._KERNEL_UNUSED_FIELDS with its
# default staging of the call graph as an edge list). The packed family
# reads the coverage bitmap, the edge list and the inverse vectors; kind
# the coverage bitmap over the kind columns (where the JAX kernel reads
# its int8 unpacking, 8x the bytes), the edge values, parents and row
# offsets, and the inverse vectors; pcsr the partition-centric views and
# the edge list. None of them reads the COO incidence arrays, the
# largest leaves. csr reads rs_val and inc_op (trace-major), ss_val and
# ss_parent, and the CSR views; pallas, coo and dense drop nothing, as
# in JAX.
_PC_FIELDS = ("pc_trace", "pc_sr_val", "pc_blk_indptr", "pc_ell_op", "pc_ell_rs")
_PACKED_UNUSED = (
    "inc_op", "inc_trace", "sr_val", "rs_val", "ss_val",
    "inc_trace_opmajor", "sr_val_opmajor", "ss_bits",
) + _PC_FIELDS
_KIND_UNUSED = (
    "inc_op", "inc_trace", "sr_val", "rs_val",
    "inc_trace_opmajor", "sr_val_opmajor",
    "inc_indptr_op", "inc_indptr_trace",
    "ss_bits", "ss_child",
) + _PC_FIELDS
_PCSR_UNUSED = (
    "inc_op", "inc_trace", "sr_val", "rs_val",
    "inc_trace_opmajor", "sr_val_opmajor",
    "inc_indptr_op", "inc_indptr_trace", "ss_indptr",
    "cov_bits", "ss_bits", "inv_tracelen", "inv_cov_dup", "inv_outdeg",
)
KERNEL_UNUSED_FIELDS = {
    "csr": ("inc_trace", "ss_child", "sr_val", "cov_bits", "ss_bits") + _PC_FIELDS,
    "packed": _PACKED_UNUSED,
    "packed_bf16": _PACKED_UNUSED,
    "packed_blocked": _PACKED_UNUSED,
    "pcsr": _PCSR_UNUSED,
    "kind": _KIND_UNUSED,
}


def host_subset(graph, kernel: str):
    """The host graph without the fields ``kernel`` never reads (each
    replaced by an empty array of its dtype, last axis 0), so that
    ``convert.graph_from_numpy`` copies only what the kernel reads."""
    fields = KERNEL_UNUSED_FIELDS.get(kernel, ())
    if not fields:
        return graph

    def strip(p):
        return p._replace(**{
            f: np.zeros(tuple(getattr(p, f).shape[:-1]) + (0,), getattr(p, f).dtype)
            for f in fields
        })

    return graph._replace(normal=strip(graph.normal), abnormal=strip(graph.abnormal))


def device_subset(
    graph: WindowGraph,
    kernel: str = "pallas",
    packed_block_bytes: int = PageRankConfig.packed_block_bytes,
    counts=None,
) -> WindowGraph:
    """The graph as the kernels consume it, built once per window so each
    power-iteration step is one or two launches of its products and the
    step kernel's one (``step_scratch``: K5's scratch, the window's
    own, so that two windows in flight never share it): for "pallas"
    and "coo", K1's work list of the six SpMVs (``window_spmv_group``
    over the COO arrays);
    for "csr", the same over the CSR views (``csr_layouts``); for "dense"
    and "dense_bf16", the densified matrices (``ops.dense.dense_group``,
    checked once);
    for "pcsr", the pcsr kernel's group (``window_pcsr_group``: K1's
    work list of the op side and the call edges, the ELL slabs of the
    trace side); for the kind and packed kernels, the pattern-pair group of
    both coverage patterns (``window_pattern_group``; packed_blocked's
    plain version in bands of ``packed_block_bytes``) and K1's work list
    of both call-graph terms. A stacked group of windows gets one work
    list, one pattern group and one step scratch for all of them (the
    caller divides ``packed_block_bytes`` by B, ``divide_block_budget``).

    ``counts``: the route's counts from the host graph (``host_counts``:
    the call-graph terms' on the kind and packed routes, the six SpMVs'
    on pallas, ``PcsrCounts`` on pcsr), which the layouts then take on
    trust: the device side issues with no host sync, so it need not
    wait for the work queued before it."""
    _check_kernel(kernel)
    windows = stacked_windows(graph)
    scratch = step_scratch(graph.normal.kind.device, windows or 1)
    if kernel in K1_KERNELS:
        layouts_of = csr_layouts if kernel == "csr" else spmv_layouts
        return graph._replace(spmv_group=window_spmv_group(graph, layouts_of, counts),
                              step_scratch=scratch)
    if kernel in DENSE_KERNELS:
        group = dense_group(graph, kernel == "dense_bf16", STEP_X_SLOTS)
        check_group(group, graph.normal.kind.device)
        return graph._replace(spmv_group=group, step_scratch=scratch)
    if kernel == "pcsr":
        return graph._replace(spmv_group=window_pcsr_group(graph, counts), step_scratch=scratch)
    pgroup = window_pattern_group(graph, kernel, packed_block_bytes)  # checks the views first
    parts = (graph.normal, graph.abnormal)
    layouts = [ss_layout(g, kernel, checked=counts is not None) for g in parts]
    v = [(windows or 1) * int(g.cov_unique.shape[-1]) for g in parts]
    return graph._replace(
        spmv_group=spmv_group(layouts, (0, 1), v, windows, counts), pattern_group=pgroup,
        step_scratch=scratch,
    )
