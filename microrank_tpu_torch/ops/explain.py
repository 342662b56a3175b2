"""K15, the explained program's attribution epilogue, as hand-written
CUDA kernels (``csrc/explain_epilogue.cu``) with their plain PyTorch
version beside them.

It replaces what XLA compiles for the TPU in
``microrank_tpu/explain/extract.py``: ``:59`` ``_slot_map``, ``:74``
``_contrib_rows``, ``:172`` ``_top_traces`` and the gathers of ``:212``
``rank_window_explained_core`` (its blob twin ``:277`` stages the same
program). From a finished rank program (K6's epilogue: the weights and
``top_idx``) and the final rv of both partitions, for the Ke suspects
``sus = top_idx[:Ke]`` (Ke = k, or ``ExplainConfig.top_suspects``):

* ``counters`` float32[4, Ke]: ef, nf, ep, np at the suspects;
* ``terms`` float32[13, Ke]: every formula of ``spectrum.formulas.METHODS``
  on them;
* ``mass`` float32[2, Ke]: n_weight, a_weight at the suspects;
* ``trace_idx`` int32 / ``trace_val`` float32 [2, Ke, J]: per partition,
  each suspect's top-J columns of ``p_sr[v, t] * rv[t]`` (value
  descending, column ascending on exact ties, -inf past the live columns;
  J past the padded columns pads with (0, -inf)), read from the route's
  own staged view (``ROUTES``): the coverage bitmap (kind and the packed
  family; the port's kind route stages ``cov_bits`` over the kind columns,
  JAX's kind route its int8 unpacking, the same 0 / 1 rows), the pcsr
  ELL slab, the csr op-major view, or the trace-major COO entries (coo,
  pallas, dense, dense_bf16). None of those views is among the fields
  ``torch_cuda.KERNEL_UNUSED_FIELDS`` strips from its route.

``explain_epilogue(normal, abnormal, rv_n, rv_a, epilogue, spectrum_cfg,
explain_cfg, kernel)``: on CPU tensors ``explain_plain`` (JAX's
expressions in JAX's order, its top-J ``ops.epilogue.top_k_tiebroken``);
on CUDA tensors one call of the library (the route's fill,
``explain_cols`` for the bitmap and ELL views or ``explain_sparse`` for
the op-major and trace-major ones, then ``explain_merge`` passes, as
``explain_plan`` plans them), counted in ``explain_epilogue.launches``
(calls) and ``.kernel_launches`` (the kernels the calls launched) — or
it raises: there is no fallback for a CUDA tensor. On the card J is at
most ``J_MAX``; the plain version takes any J.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from pathlib import Path
from typing import List, NamedTuple, Optional

import torch

from ..config import ExplainConfig, SpectrumConfig
from ..graph.structures import PartitionGraph
from ..spectrum.formulas import METHODS, spectrum_scores
from ..utils.build import BUILD_DIR, is_stale, run_build, tmp_output
from .epilogue import Epilogue, spectrum_counters, top_k_tiebroken
from .pattern import unpack_bits
from .setup import as_kernel_field, f32_bits
from .spmv import nvcc

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "explain_epilogue.cu"
COMMON_HEADER = SOURCE.with_name("rank_common.cuh")
LIB_PATH = BUILD_DIR / "libmr_explain.so"
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()

# Each rank route's staged view the contributions are read from (csrc
# ``Route``).
BITMAP, ELL, OP_MAJOR, TRACE_MAJOR = range(4)
ROUTES = {
    "kind": BITMAP, "packed": BITMAP, "packed_bf16": BITMAP, "packed_blocked": BITMAP,
    "pcsr": ELL, "csr": OP_MAJOR,
    "coo": TRACE_MAJOR, "pallas": TRACE_MAJOR, "dense": TRACE_MAJOR, "dense_bf16": TRACE_MAJOR,
}
SUS = 32          # suspects a fill block holds: one match word (csrc kSus)
WARP_J = 32       # J up to this: the warp-select (csrc kWarpJ)
J_MAX = 2048      # the bitonic path's largest J (csrc kJMax)
FILL_BLOCKS = 264  # fill blocks a plan aims for: two an SM of an H100's 132
MERGE_WARP = 8192  # keys a warp-select merge block folds (csrc kMergeWarp)
SORT_MIN = 1024   # keys a bitonic merge block sorts, at least (csrc kSortMin)
SORT_MAX = 8192   # the bitonic path's largest sort in shared memory (csrc kSortMax)
# A fill unit's least and largest size by route (csrc kUnitMin, kUnitMax):
# columns a tile of the bitmap, ELL and op-major views, entries a chunk of
# the trace-major one.
UNITS = {BITMAP: (128, 2048), ELL: (16, 2048), OP_MAJOR: (128, 2048), TRACE_MAJOR: (64, 1024)}
# Suspects a fill block holds by route (csrc kChunkRows): SUS where the
# block reads a view all its rows share (ELL, trace-major); a warp's row
# each (8) where a row reads its own bitmap row or op-major range.
CHUNK_ROWS = {BITMAP: 8, ELL: SUS, OP_MAJOR: 8, TRACE_MAJOR: SUS}
INT32_MAX = 2**31 - 1


class Explained(NamedTuple):
    """The attribution tensors of one window (JAX's five explain outputs)."""

    counters: torch.Tensor   # float32 [4, Ke]
    terms: torch.Tensor      # float32 [13, Ke]
    mass: torch.Tensor       # float32 [2, Ke]
    trace_idx: torch.Tensor  # int32 [2, Ke, J]
    trace_val: torch.Tensor  # float32 [2, Ke, J]


def n_suspects(k: int, explain_cfg: ExplainConfig) -> int:
    """Ke: every rank row, or ``top_suspects`` of them."""
    return k if explain_cfg.top_suspects <= 0 else min(int(explain_cfg.top_suspects), k)


# ------------------------------------------------------------ plain version


def slot_map(top_idx: torch.Tensor, v_pad: int) -> torch.Tensor:
    """int64[v_pad + 1]: op index -> suspect slot, k (scrap) elsewhere
    (JAX's ``_slot_map``; row v_pad takes the csr path's past-the-end
    op)."""
    k = top_idx.shape[0]
    out = torch.full((v_pad + 1,), k, dtype=torch.int64, device=top_idx.device)
    out[top_idx.long()] = torch.arange(k, device=top_idx.device)
    return out


def contrib_rows(g: PartitionGraph, sus: torch.Tensor, rv: torch.Tensor,
                 kernel: str) -> torch.Tensor:
    """float32[Ke, T]: ``p_sr[sus[k], t] * rv[t]`` over the padded column
    axis, from ``kernel``'s staged view (JAX's ``_contrib_rows``, one
    device)."""
    k = sus.shape[0]
    v_pad = g.cov_unique.shape[0]
    t_pad = g.kind.shape[0]
    route = ROUTES[kernel]
    if route == BITMAP:
        rows = unpack_bits(g.cov_bits[sus.long()], t_pad)
        return rows * (rv * g.inv_tracelen)[None, :]
    if route == ELL:
        live_cell = g.pc_ell_rs > 0
        match = torch.any(live_cell[None, :, :] & (g.pc_ell_op[None, :, :] == sus[:, None, None]),
                          dim=-1).to(torch.float32)
        mult = torch.where(g.n_cols < 0, 1.0, g.kind.to(torch.float32))
        w_col = rv * mult / g.tracelen.to(torch.float32)
        return match * w_col[: g.pc_ell_op.shape[0]]
    zeros = torch.zeros((k + 1, t_pad), dtype=torch.float32, device=rv.device)
    if route == OP_MAJOR:
        e = torch.arange(g.sr_val_opmajor.shape[0], dtype=torch.int32, device=rv.device)
        op_e = torch.searchsorted(g.inc_indptr_op, e, right=True) - 1
        op_e = op_e.clamp(0, v_pad)
        vals = g.sr_val_opmajor * rv[g.inc_trace_opmajor.long()]
        cells = (slot_map(sus, v_pad)[op_e], g.inc_trace_opmajor.long())
    else:
        vals = g.sr_val * rv[g.inc_trace.long()]
        cells = (slot_map(sus, v_pad)[g.inc_op.long().clamp(0, v_pad)], g.inc_trace.long())
    return zeros.index_put_(cells, vals, accumulate=True)[:k]


def top_traces_plain(g: PartitionGraph, sus: torch.Tensor, rv: torch.Tensor, j_want: int,
                     kernel: str):
    """(idx int32[Ke, J], val float32[Ke, J]): each suspect's top-J
    contributing columns of one partition, -inf past the live columns,
    padded with (0, -inf) past the padded ones (JAX's ``_top_traces``)."""
    contrib = contrib_rows(g, sus, rv, kernel)
    t_full = contrib.shape[1]
    n_live = torch.where(g.n_cols < 0, g.n_traces, g.n_cols)
    live = torch.arange(t_full, device=rv.device) < n_live
    masked = torch.where(live[None, :], contrib, float("-inf"))
    j = min(int(j_want), t_full)
    vals, idx = top_k_tiebroken(masked, j)
    if j < j_want:
        pad = j_want - j
        vals = torch.cat([vals, torch.full((vals.shape[0], pad), float("-inf"),
                                           device=vals.device)], 1)
        idx = torch.cat([idx, torch.zeros((idx.shape[0], pad), dtype=torch.int32,
                                          device=idx.device)], 1)
    return idx.to(torch.int32), vals


def explain_plain(normal: PartitionGraph, abnormal: PartitionGraph, rv_n, rv_a,
                  epi: Epilogue, spectrum_cfg: SpectrumConfig, explain_cfg: ExplainConfig,
                  kernel: str) -> Explained:
    """K15 in plain PyTorch: JAX's attribution outputs past
    ``window_weights_full`` and the top-k (``rank_window_explained_core``
    :239-273), from the epilogue's weights and top_idx."""
    ke = n_suspects(epi.top_idx.shape[0], explain_cfg)
    sus = epi.top_idx[:ke].long()
    ef, nf, ep, np_, _ = spectrum_counters(epi.a_weight, abnormal, epi.n_weight, normal,
                                           spectrum_cfg)
    c_sus = tuple(x[sus] for x in (ef, nf, ep, np_))
    counters = torch.stack(c_sus)
    # Elementwise formulas: gather-then-score is score-then-gather.
    terms = torch.stack([spectrum_scores(*c_sus, m) for m in METHODS])
    mass = torch.stack([epi.n_weight[sus], epi.a_weight[sus]])
    j = int(explain_cfg.top_traces)
    ti_n, tv_n = top_traces_plain(normal, sus, rv_n, j, kernel)
    ti_a, tv_a = top_traces_plain(abnormal, sus, rv_a, j, kernel)
    return Explained(counters, terms, mass, torch.stack([ti_n, ti_a]), torch.stack([tv_n, tv_a]))


# ------------------------------------------------------------------ kernel


class ExplainPlan(NamedTuple):
    """One K15 call, as the host plans it (``explain_plan``)."""

    select: str       # "warp" (J <= WARP_J) or "bitonic"
    route: int        # the staged view's route (ROUTES)
    unit: tuple       # per partition: columns a tile, or entries a chunk
    units: tuple      # per partition: its tiles or chunks (candidate lists a row)
    chunks: int       # suspect chunks of CHUNK_ROWS[route] (grid y of the fill)
    lists: int        # the candidate lists of the partition with the most
    group: int        # lists a merge block folds (merge_keys // J)
    merge_keys: int   # keys a merge block takes
    passes: tuple     # the lists left after each merge pass (the last is 1)
    fill_smem: int    # a fill block's dynamic shared memory, bytes

    @property
    def kernel_launches(self) -> int:
        return 1 + len(self.passes)

    @property
    def fill_blocks(self) -> int:
        """The fill's grid: each chunk's units, and its terms block."""
        return (sum(self.units) + 1) * self.chunks


def _pow2_at_least(n: int) -> int:
    return max(2, 1 << (int(n) - 1).bit_length())


def explain_plan(route: int, cols: tuple, j: int, ke: int, width: tuple = (1, 1),
                 entries: tuple = (1, 1)) -> ExplainPlan:
    """K15's launches for a window whose partitions have ``cols`` padded
    columns (ELL slabs ``width`` cells a column; trace-major arrays
    ``entries`` long), a top-``j`` and ``ke`` suspects. Each partition is
    planned on its own work: units of columns (the bitmap and op-major
    views), of columns of ``width`` cells (ELL) or of entries (trace-major),
    the largest power of two within ``UNITS[route]`` (one quantum of
    cells or entries for both partitions) that still gives the fill
    FILL_BLOCKS blocks over its suspect chunks (past WARP_J, units of at
    least 2J); then merge passes of ``merge_keys // j`` lists a group
    until one is left. Pure: the C library checks the same rules again."""
    if not 1 <= j <= J_MAX or min(cols) < 1 or ke < 1:
        raise ValueError(f"explain_plan: 1 <= top_traces <= {J_MAX} on the card, at least "
                         f"one column and one suspect (got {j}, {cols}, {ke})")
    chunks = -(-ke // CHUNK_ROWS[route])
    if max(cols) > INT32_MAX or chunks > 65535 or 2 * ke > INT32_MAX:
        raise ValueError(f"explain_plan: {max(cols)} columns or {ke} suspects is past the "
                         "card's grid")
    if route == ELL and not all(1 <= w <= 4096 for w in width):
        raise ValueError(f"explain_plan: an ELL slab of 1 to 4,096 cells a column (got {width})")
    sizes = tuple(entries) if route == TRACE_MAJOR else tuple(cols)
    if min(sizes) < 1:
        raise ValueError(f"explain_plan: a trace-major view of at least one entry (got {sizes})")
    warp = j <= WARP_J
    least, most = UNITS[route]
    if not warp:   # fewer, wider units: a bitonic merge folds few lists
        least = min(most, max(least, _pow2_at_least(2 * j)))
    per = tuple(width) if route == ELL else (1, 1)
    target = -(-FILL_BLOCKS // chunks)
    quantum = most * max(per)
    while True:
        unit = tuple(min(most, max(least, 1 << (max(1, quantum // w).bit_length() - 1)))
                     for w in per)
        units = tuple(-(-n // c) for n, c in zip(sizes, unit))
        if sum(units) >= target or all(c == least for c in unit):
            break
        quantum //= 2
    merge_keys = MERGE_WARP if warp else max(SORT_MIN, _pow2_at_least(2 * j))
    group = merge_keys // j
    lists = max(units)
    if sum(units) >= INT32_MAX or -(-lists // group) > 65535:
        raise ValueError(f"explain_plan: {sizes} is past the card's grid")
    passes, n = [], lists
    while n > 1:
        n = -(-n // group)
        passes.append(n)
    if route in (BITMAP, ELL):
        smem = max(unit) * (12 if warp else 16)
    else:
        smem = 0 if warp else 8 * _pow2_at_least(max(unit) + 2 * j)
    return ExplainPlan("warp" if warp else "bitonic", route, unit, units, chunks, lists, group,
                       merge_keys, tuple(passes), smem)


def window_plan(normal: PartitionGraph, abnormal: PartitionGraph, kernel: str, j: int,
                ke: int) -> ExplainPlan:
    """``explain_plan`` for a window's staged views (shapes only: no
    device read)."""
    route = ROUTES[kernel]
    parts = (normal, abnormal)
    cols = tuple(int(g.kind.shape[0]) for g in parts)
    width = tuple(int(g.pc_ell_op.shape[1]) for g in parts) if route == ELL else (1, 1)
    entries = tuple(_entries(g) for g in parts) if route == TRACE_MAJOR else (1, 1)
    return explain_plan(route, cols, j, ke, width, entries)


def _entries(g: PartitionGraph) -> int:
    """The trace-major arrays' length as the kernel reads them."""
    return min(int(g.inc_op.shape[0]), int(g.inc_trace.shape[0]), int(g.sr_val.shape[0]))


def chunk_edges(inc_trace: torch.Tensor, n_inc: int, t_pad: int, unit: int, units: int):
    """The trace-major fill's split of a partition (csrc ``chunk_edges``),
    for the tests: (starts int64[units + 1], columns int64[units + 1]).
    Chunk c reads entries [starts[c], starts[c + 1]) and owns columns
    [columns[c], columns[c + 1]): starts[0] = 0, starts[c] the first
    entry at or past c * unit that starts a trace (n_inc when none), its
    trace its first column (t_pad past the entries)."""
    trace = inc_trace[:n_inc].long()
    first = torch.ones(min(n_inc, 1), dtype=torch.bool)
    heads = torch.nonzero(torch.cat([first, trace[1:] != trace[:-1]])).flatten()
    heads = torch.cat([heads, torch.tensor([n_inc])])
    nominal = torch.arange(units + 1, dtype=torch.int64) * unit
    starts = heads[torch.searchsorted(heads, nominal).clamp(max=heads.numel() - 1)]
    starts[0] = 0
    columns = torch.full_like(starts, t_pad)
    inside = starts < n_inc
    columns[inside] = trace[starts[inside]].clamp(0, t_pad)
    columns[0] = 0
    return starts, columns


# The argument block of ``mr_explain_launch`` (csrc ``Word``): per
# partition rv, n_cols, n_traces, cov_bits, inv_tracelen, ell_op, ell_rs,
# kind, tracelen, indptr, trace_om, val_om, inc_op, inc_trace, sr_val,
# n_inc, row_bytes, entries, width, t, unit, units; then top_idx,
# n_weight, a_weight, n_present, a_present, n_cov, a_cov, counters,
# terms, mass, trace_idx, trace_val, the two key scratches, route, v, ke,
# j, lists, group, merge_keys, eps's float32 bits, device, stream.
PART_WORDS = 22
ARGS = struct.Struct(f"<{2 * PART_WORDS + 24}q")


def _ptr(t: torch.Tensor, keep: list, dtype=torch.int32) -> int:
    """The address of ``t`` as the kernel reads it (``as_kernel_field``),
    the converted copy kept in ``keep`` until the call."""
    f = as_kernel_field(t, dtype)
    keep.append(f)
    return f.data_ptr()


def _part_words(g: PartitionGraph, rv: torch.Tensor, route: int, unit: int, units: int,
                keep: list) -> list:
    """One partition's words: its route's fields as the kernel reads them,
    0 for the others, and its share of the plan."""
    def ptr(t, dtype=torch.int32):
        return _ptr(t, keep, dtype)

    t_pad = int(g.kind.shape[0])
    w = [ptr(rv, torch.float32), ptr(g.n_cols), ptr(g.n_traces)] + [0] * 13 + [0, 0, 0, t_pad,
                                                                                  unit, units]
    if route == BITMAP:
        w[3] = ptr(g.cov_bits, torch.uint8)
        w[4] = ptr(g.inv_tracelen, torch.float32)
        w[16] = int(g.cov_bits.shape[1])
    elif route == ELL:
        if g.pc_ell_op.shape[0] != t_pad or g.pc_ell_rs.shape != g.pc_ell_op.shape:
            raise ValueError("explain_epilogue: the ELL slab must have a row a column")
        w[5] = ptr(g.pc_ell_op)
        w[6] = ptr(g.pc_ell_rs, torch.float32)
        w[7] = ptr(g.kind)
        w[8] = ptr(g.tracelen)
        w[18] = int(g.pc_ell_op.shape[1])
    elif route == OP_MAJOR:
        w[9] = ptr(g.inc_indptr_op)
        w[10] = ptr(g.inc_trace_opmajor)
        w[11] = ptr(g.sr_val_opmajor, torch.float32)
    else:
        w[12] = ptr(g.inc_op)
        w[13] = ptr(g.inc_trace)
        w[14] = ptr(g.sr_val, torch.float32)
        w[15] = ptr(g.n_inc)
        w[17] = _entries(g)
    return w


def _check(normal: PartitionGraph, abnormal: PartitionGraph, rv_n, rv_a, epi: Epilogue, kernel):
    """What the kernels take on trust: one window, rv [T] float32 of each
    partition, the route's views present, every field on rv_n's device."""
    if kernel not in ROUTES:
        raise ValueError(f"explain_epilogue: unknown kernel {kernel!r}")
    dev = rv_n.device
    if epi.top_idx.dim() != 1:
        raise ValueError("explain_epilogue: one window (JAX has no batched explained program)")
    v = int(epi.n_weight.shape[-1])
    for g, rv in ((normal, rv_n), (abnormal, rv_a)):
        if rv.shape != (int(g.kind.shape[0]),) or rv.dtype != torch.float32 or rv.device != dev:
            raise ValueError("explain_epilogue: rv must be float32 [T] on the rank device")
        if int(g.cov_unique.shape[0]) != v:
            raise ValueError("explain_epilogue: the partitions' vocab does not match the weights")
        route = ROUTES[kernel]
        need = {BITMAP: (g.cov_bits, g.inv_tracelen), ELL: (g.pc_ell_op, g.pc_ell_rs),
                OP_MAJOR: (g.inc_indptr_op, g.inc_trace_opmajor, g.sr_val_opmajor),
                TRACE_MAJOR: (g.inc_op, g.inc_trace, g.sr_val)}[route]
        if any(int(t.shape[-1]) == 0 for t in need):
            raise ValueError(f"explain_epilogue: kernel={kernel!r} needs its staged view, but "
                             "this window was built without it")
        if route == BITMAP and int(g.cov_bits.shape[0]) != v:
            raise ValueError("explain_epilogue: cov_bits must have a row an op")
        for t in g:
            if torch.is_tensor(t) and t.numel() and t.device != dev:
                raise ValueError(f"explain_epilogue: every field must lie on {dev}")


def explain_epilogue(normal: PartitionGraph, abnormal: PartitionGraph, rv_n: torch.Tensor,
                     rv_a: torch.Tensor, epi: Epilogue, spectrum_cfg: SpectrumConfig,
                     explain_cfg: ExplainConfig, kernel: str) -> Explained:
    """``explain_plain``'s results: CPU tensors run it; CUDA tensors
    launch K15 once (the route's fill, then the merge passes), or
    raise. The outputs are views of one fresh allocation."""
    dev = rv_n.device
    if dev.type == "cpu":
        return explain_plain(normal, abnormal, rv_n, rv_a, epi, spectrum_cfg, explain_cfg,
                             kernel)
    if dev.type != "cuda":
        raise ValueError(f"explain_epilogue: unsupported device {dev}")
    _check(normal, abnormal, rv_n, rv_a, epi, kernel)
    j = int(explain_cfg.top_traces)
    ke = n_suspects(int(epi.top_idx.shape[0]), explain_cfg)
    plan = window_plan(normal, abnormal, kernel, j, ke)
    sizes = (4 * ke, len(METHODS) * ke, 2 * ke, 2 * ke * j, 2 * ke * j)
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    counters, terms, mass, trace_idx, trace_val = torch.split_with_sizes(flat, sizes)
    rows = 2 * ke
    keys_a = keys_b = None
    if plan.lists > 1:
        keys_a = torch.empty(rows * plan.lists * j, dtype=torch.int64, device=dev)
    if len(plan.passes) > 1:
        keys_b = torch.empty(rows * plan.passes[0] * j, dtype=torch.int64, device=dev)
    route = ROUTES[kernel]
    keep: list = []
    words = (_part_words(normal, rv_n, route, plan.unit[0], plan.units[0], keep)
             + _part_words(abnormal, rv_a, route, plan.unit[1], plan.units[1], keep))

    def ptr(t, dtype=torch.int32):
        return _ptr(t, keep, dtype)

    index = dev.index if dev.index is not None else torch.cuda.current_device()
    lib = load_library()
    rc = lib.mr_explain_launch(ARGS.pack(
        *words, ptr(epi.top_idx), ptr(epi.n_weight, torch.float32),
        ptr(epi.a_weight, torch.float32), ptr(normal.op_present, torch.bool),
        ptr(abnormal.op_present, torch.bool), ptr(normal.cov_unique), ptr(abnormal.cov_unique),
        counters.data_ptr(), terms.data_ptr(), mass.data_ptr(), trace_idx.data_ptr(),
        trace_val.data_ptr(), 0 if keys_a is None else keys_a.data_ptr(),
        0 if keys_b is None else keys_b.data_ptr(), route, int(epi.n_weight.shape[-1]), ke, j,
        plan.lists, plan.group, plan.merge_keys, f32_bits(spectrum_cfg.eps), index,
        torch._C._cuda_getCurrentRawStream(index)))
    if rc != 0:
        raise RuntimeError(f"explain_epilogue launch failed: "
                           f"{lib.mr_explain_error_string(rc).decode()}")
    explain_epilogue.launches += 1
    explain_epilogue.kernel_launches += plan.kernel_launches
    return Explained(counters.view(4, ke), terms.view(len(METHODS), ke), mass.view(2, ke),
                     trace_idx.view(torch.int32).view(2, ke, j), trace_val.view(2, ke, j))


# Calls that launched K15 (a plain int; explain_epilogue is the one place
# that launches it), and the kernel launches they made (one fill a call,
# the rest explain_merge passes).
explain_epilogue.launches = 0
explain_epilogue.kernel_launches = 0


def build_command(out: Path) -> List[str]:
    """The nvcc command that builds the kernel library into ``out``
    (``-Xptxas -v`` reports registers, shared memory and spills;
    ``-fmad=false`` keeps every multiply and add its own rounding)."""
    return [
        nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v", "-o", str(out), str(SOURCE),
    ]


def build_library() -> str:
    """Compile the kernel library if it is missing or older than its
    sources; returns the compiler's report ("" when up to date)."""
    if not is_stale(LIB_PATH, [SOURCE, COMMON_HEADER]):
        return ""
    tmp = tmp_output(LIB_PATH)
    return run_build(build_command(tmp), tmp, LIB_PATH)


def load_library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            build_library()
            lib = ctypes.CDLL(str(LIB_PATH))
            lib.mr_explain_config.restype = ctypes.c_int
            lib.mr_explain_config.argtypes = [ctypes.POINTER(ctypes.c_int32)]
            lib.mr_explain_launch.restype = ctypes.c_int
            lib.mr_explain_launch.argtypes = [ctypes.c_char_p]  # ARGS, packed
            lib.mr_explain_error_string.restype = ctypes.c_char_p
            lib.mr_explain_error_string.argtypes = [ctypes.c_int]
            out = (ctypes.c_int32 * 19)()
            lib.mr_explain_config(out)
            units = tuple(x for r in sorted(UNITS) for x in UNITS[r])
            rows = tuple(CHUNK_ROWS[r] for r in sorted(CHUNK_ROWS))
            if tuple(out) != (SUS, WARP_J, ARGS.size // 8, 256, MERGE_WARP, SORT_MIN,
                              SORT_MAX) + units + rows:
                raise RuntimeError("explain_epilogue: the library's limits or argument block "
                                   "are not the wrapper's")
            _lib = lib
    return _lib
