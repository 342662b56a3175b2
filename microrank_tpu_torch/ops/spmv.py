"""K1: the COO segment-sum SpMV, as a hand-written CUDA kernel
(``csrc/coo_spmv.cu``) with its plain PyTorch version beside it.

It replaces the TPU kernel ``microrank_tpu/ops/pallas_spmv.py``
``coo_segment_sum_pallas`` / ``coo_matvec_pallas``: the same function,
``y[r] = sum over entries e with rows[e] == r of vals[e] * x[cols[e]]``.

Three steps:

* ``row_layout`` — once per window and matrix: a stable sort of the
  entries by row (one row's entries keep the build's order, whatever
  that order was) plus ``indptr[n_rows + 1]``, with the columns and
  values gathered into that order. Entries at or past ``n_live`` are
  padding (value 0) and move past the last row, outside every row.
* ``indptr_layout`` — the same layout read straight from a matrix
  already in row order (the build's CSR views, the csr kernel's): its
  row offsets as they are, no sort; stacked windows block-diagonal as
  below.
* ``spmv_group`` — once per window: one work list for several row
  layouts (a power-iteration step's six matrices). Every row is cut into
  chunks of at most ``CHUNK`` entries at positions ``[j * CHUNK,
  (j + 1) * CHUNK)`` of the row; an empty row gets one empty item.
  Stacked windows (``row_layout`` of [B, E] entries) make one
  block-diagonal matrix per layout: window b's rows follow window
  b - 1's and its columns are offset by b times its x length, so the x
  slots are [B, n] tensors read by row stride and no slot is spent on a
  window. Each row keeps its chunks and its fold order, so a window's
  bits are the same alone or in a group; the kernel is unchanged.
* ``coo_spmv_group`` — every step: on CUDA tensors one launch computes
  every matrix of the group (one warp per item, fixed-order lane sums
  and shuffle tree, the chunks of a row folded left to right by the last
  warp to arrive; no float atomics) or raises; on CPU tensors it runs
  ``coo_spmv_group_plain``, which repeats the kernel's arithmetic in the
  kernel's order, so both give the same bits. ``coo_spmv`` is a group of
  one.

The pcsr kernel's step, ``pcsr_spmv_group``, is one launch of a second
entry of the same source over a ``PcsrGroup``: a work list of the
long-row matrices (op side, call edges), as above, plus each
partition's trace side read straight from its ELL slab, rows of W
slots with zero-valued padding. ``ell_part`` counts a slab's rows once
and picks how the kernel reads them (``ell_mode``). ``ell_spmv_plain``
sums an ELL row in the order K1 sums the same row as a work item, so
both give the same bits. A stacked group's step (``PcsrGroup.rows.
windows``) is the same launch: its work list block-diagonal, as above,
and each partition's slabs of all B windows one slab of B * T rows, the
rows of window b reading x at b * V; every read mode gives K1's order
of a row's live entries (``ell_mode``), so a window's bits do not
depend on the mode its group's slab is read in.

What bounds the kernel on the card, and what it does about it, is in
the note at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes
import itertools
import shutil
import threading
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..utils.build import BUILD_DIR, is_stale, run_build, tmp_output

WARP = 32
# Entries per work item (csrc/coo_spmv.cu kChunk). Chunk boundaries fix
# the order of every sum, so this is part of the function's bits, not a
# tuning knob: the plain version and the kernel must agree on it.
CHUNK = 256
MAX_X = 8  # x slots a group may read (csrc/coo_spmv.cu kMaxX)
MAX_ELL = 2  # ELL slabs of one pcsr launch (csrc/coo_spmv.cu kMaxEll)
# How the kernel reads an ELL slab's rows (csrc/coo_spmv.cu kEll*).
ELL_SLAB, ELL_SHORT, ELL_WARP = 0, 1, 2
ITEM_FIELDS = ("slot", "y", "begin", "end", "chunk", "n_chunks")
INT32_MAX = 2**31 - 1
SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "coo_spmv.cu"
LIB_PATH = BUILD_DIR / "libmr_coo_spmv.so"
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


class RowLayout(NamedTuple):
    """A COO matrix laid out by row."""

    indptr: torch.Tensor  # int32[n_rows + 1]: row r is [indptr[r], indptr[r+1])
    cols: torch.Tensor    # int32[E] column per entry, row-sorted
    vals: torch.Tensor    # float32[E] value per entry, row-sorted
    perm: torch.Tensor    # int64[E] sorted position -> original entry
    n_rows: int


def row_layout(
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    n_rows: int,
    n_live: Union[int, torch.Tensor, None] = None,
    n_x: Optional[int] = None,
    checked: bool = False,
) -> RowLayout:
    """Row-sorted layout of COO entries (``rows``/``cols`` int32,
    ``vals`` float32). Entries ``e >= n_live`` are padding and are left
    out of every row; None keeps all entries. A live row outside
    [0, n_rows] raises, after one host sync; ``checked``: the caller
    has checked the rows on the host (``host_spmv_counts``), and the
    layout is built without one.

    Stacked windows (``rows`` [B, E], ``n_live`` [B], ``n_x`` each
    window's x length): one block-diagonal matrix of B * n_rows rows over
    an x of B * n_x, window b's rows at [b * n_rows, (b + 1) * n_rows)
    and its columns offset by b * n_x (a column outside [0, n_x) becomes
    -1, which ``spmv_group`` refuses). Each row holds its window's
    entries in the same order as that window's own layout."""
    if rows.dtype != torch.int32 or cols.dtype != torch.int32:
        raise TypeError("rows and cols must be int32")
    if vals.dtype != torch.float32:
        raise TypeError("vals must be float32")
    if rows.dim() == 2:
        if n_x is None:
            raise ValueError("row_layout: stacked windows need their x length n_x")
        n_win, e = rows.shape
        win = torch.arange(n_win, device=rows.device)[:, None]
        key = rows.to(torch.int64) + win * n_rows
        if n_live is not None:
            pos = torch.arange(e, device=rows.device)
            live = pos < torch.as_tensor(n_live, device=rows.device).reshape(-1, 1)
            key = torch.where(live, key, n_win * n_rows)
        cols = torch.where((cols >= 0) & (cols < n_x), cols + (win * n_x).to(torch.int32), -1)
        rows, n_rows, n_live = key.reshape(-1), n_win * n_rows, None
        cols, vals = cols.reshape(-1), vals.reshape(-1)
    e = rows.shape[0]
    key = rows.to(torch.int64)
    if n_live is not None:
        pos = torch.arange(e, device=rows.device)
        key = torch.where(pos < n_live, key, n_rows)
    keys, perm = torch.sort(key, stable=True)
    if not checked and e:
        lo, hi = torch.stack([keys[0], keys[-1]]).tolist()
        if lo < 0 or hi > n_rows:
            raise ValueError(f"row index out of range for n_rows={n_rows}")
    # Row r starts after the keys below r (a padding key, n_rows, sorts
    # past every row).
    bounds = torch.arange(n_rows + 1, dtype=torch.int64, device=rows.device)
    return RowLayout(
        indptr=torch.searchsorted(keys, bounds).to(torch.int32),
        cols=cols[perm],
        vals=vals[perm],
        perm=perm,
        n_rows=int(n_rows),
    )


def indptr_layout(
    indptr: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    n_x: Optional[int] = None,
) -> RowLayout:
    """The row layout of a matrix already in row order, read straight
    from its row offsets with no sort (the csr kernel's layouts over the
    build's CSR views: ``indptr`` int32[n_rows + 1], each row's entries
    in the build's order). Entries past ``indptr[-1]`` are padding,
    outside every row.

    Stacked windows (``indptr`` [B, n_rows + 1], ``cols`` / ``vals``
    [B, E], ``n_x`` each window's x length): one block-diagonal matrix,
    window b's offsets moved by b * E and its columns by b * n_x (a
    column outside [0, n_x) becomes -1, which ``spmv_group`` refuses).
    A window's padding entries (value 0, column 0) then close its last
    row after the row's own entries: each adds a +0 product to a lane's
    sum, or a chunk of +0 to the row's fold, which moves no bit of a
    finite sum, so each row keeps its window's own bits."""
    if cols.dtype != torch.int32 or indptr.dtype != torch.int32:
        raise TypeError("indptr and cols must be int32")
    if vals.dtype != torch.float32:
        raise TypeError("vals must be float32")
    dev = cols.device
    if indptr.dim() == 1:
        return RowLayout(indptr=indptr, cols=cols, vals=vals,
                         perm=torch.arange(cols.shape[0], device=dev),
                         n_rows=int(indptr.shape[0]) - 1)
    if n_x is None:
        raise ValueError("indptr_layout: stacked windows need their x length n_x")
    n_win, e = cols.shape
    win = torch.arange(n_win, device=dev)[:, None]
    return RowLayout(
        indptr=torch.cat([
            (indptr[:, :-1] + win * e).reshape(-1), indptr[-1, -1:] + (n_win - 1) * e,
        ]).to(torch.int32),
        cols=torch.where((cols >= 0) & (cols < n_x), cols + (win * n_x).to(torch.int32), -1)
        .reshape(-1),
        vals=vals.reshape(-1),
        perm=torch.arange(n_win * e, device=dev),
        n_rows=int(n_win * (indptr.shape[1] - 1)),
    )


class SpmvGroup(NamedTuple):
    """Several row layouts as one work list: what one launch of the
    chunked kernel computes. Matrix m reads x slot ``x_slots[m]`` (of
    length ``n_x[m]``) and writes the next ``n_rows[m]`` entries of the
    flat y. Positions are global: matrix m's entries sit at
    ``[entry_offsets[m], entry_offsets[m+1])`` of ``cols``/``vals``.
    ``spmv_group`` makes every tensor contiguous, on one device, with
    the kernel's dtypes."""

    items: torch.Tensor       # int32[n_items, 6], ITEM_FIELDS; y indexes the flat y
    cols: torch.Tensor        # int32[E] all matrices' row-sorted columns
    vals: torch.Tensor        # float32[E]
    part: torch.Tensor        # float32[n_items] kernel scratch: chunk sums
    counters: torch.Tensor    # int32[n_y] chunk arrivals per row, 0 between launches
    bucket: torch.Tensor      # int64[E] plain: item * 32 + lane; padding n_items * 32
    chunk_slot: torch.Tensor  # int64[n_items] plain: y index * max_chunks + chunk
    row_chunks: torch.Tensor  # int64[n_y] chunks of each row
    x_slots: Tuple[int, ...]
    n_x: Tuple[int, ...]
    n_rows: Tuple[int, ...]
    entry_offsets: Tuple[int, ...]
    max_chunks: int
    # Stacked windows: each layout is block-diagonal over this many
    # windows (``row_layout`` of [B, E] entries); the x slots are [B, n]
    # and each y comes out [B, n_rows / B]. None: one window, 1-d.
    windows: Optional[int] = None


class SpmvCounts(NamedTuple):
    """What ``spmv_group`` otherwise reads back from the device: the
    work list's items, the most chunks of a row, and the live entries
    (``host_spmv_counts``)."""

    n_items: int
    max_chunks: int
    n_live: int


def host_row_layout(rows, cols, n_rows: int, n_live=None, n_x: Optional[int] = None
                    ) -> Tuple[np.ndarray, int]:
    """``row_layout`` of host arrays as ``host_spmv_counts`` reads it:
    (indptr, the live entries whose column lies outside [0, n_x)), the
    live entries those of a row below ``n_rows``. Stacked windows
    (``rows`` [B, E], ``n_live`` [B]) give the block-diagonal layout, a
    column outside its window's x counted bad, as ``row_layout`` lays
    them out. Raises ``row_layout``'s ValueError on a live row outside
    [0, n_rows]."""
    rows, cols = np.asarray(rows), np.asarray(cols)
    if rows.ndim == 2:
        n_win, e = rows.shape
        win = np.arange(n_win)[:, None]
        key = rows.astype(np.int64) + win * n_rows
        if n_live is not None:
            key = np.where(np.arange(e) < np.asarray(n_live).reshape(-1, 1), key, n_win * n_rows)
        n_rows, key = n_win * n_rows, key.reshape(-1)
    else:
        # Entries at or past n_live are padding: they sort past every row.
        key = rows[: None if n_live is None else max(0, int(n_live))]
        cols = cols[: key.shape[0]]
    lo, hi = (int(key.min()), int(key.max())) if key.size else (0, 0)
    if lo < 0 or hi > n_rows:
        raise ValueError(f"row index out of range for n_rows={n_rows}")
    counts = np.bincount(key, minlength=n_rows + 1)
    indptr = np.concatenate([[0], np.cumsum(counts[:n_rows])])
    bad = (cols < 0) | (cols >= n_x)
    if rows.ndim == 2 or hi == n_rows:
        bad = bad.reshape(-1) & (key < n_rows)
    return indptr, int(np.count_nonzero(bad))


def host_indptr_layout(indptr, cols, n_x: int) -> Tuple[np.ndarray, int]:
    """``indptr_layout`` of host arrays as ``host_spmv_counts`` reads it:
    (indptr, the entries inside a row whose column lies outside its
    window's x), a stacked group's block-diagonal over its windows.
    Raises ``ValueError`` on offsets that decrease or leave [0, E]."""
    indptr, cols = np.asarray(indptr).astype(np.int64), np.asarray(cols)
    stacked = indptr.ndim == 2
    n_win, e = cols.shape if stacked else (1, cols.shape[0])
    if indptr.size and ((np.diff(indptr, axis=-1) < 0).any() or indptr.min() < 0
                        or indptr.max() > e):
        raise ValueError("CSR row offsets must be non-decreasing within [0, E]")
    bad = (cols < 0) | (cols >= n_x)
    if stacked:
        win = np.arange(n_win)[:, None]
        indptr = np.concatenate([(indptr[:, :-1] + win * e).reshape(-1),
                                 indptr[-1, -1:] + (n_win - 1) * e])
    if not indptr.size:
        return indptr, 0
    return indptr, int(np.count_nonzero(bad.reshape(-1)[int(indptr[0]): int(indptr[-1])]))


def host_spmv_counts(layouts: Sequence[Tuple[np.ndarray, int]]) -> SpmvCounts:
    """``spmv_group``'s counts and column check, in numpy, from the host
    arrays its layouts come from: per matrix (indptr, the live entries
    whose column lies outside its x), as ``row_layout`` would lay them
    out (``host_row_layout``). Raises the ``IndexError`` of
    ``spmv_group`` on a column outside its x. With these counts the
    group is built without a host sync."""
    lens = np.concatenate([np.diff(ip.astype(np.int64)) for ip, _ in layouts])
    n_bad = sum(n for _, n in layouts)
    if n_bad:
        raise IndexError(f"spmv_group: {n_bad} column(s) outside their x")
    if not lens.size:
        return SpmvCounts(0, 1, 0)
    n_chunks = np.maximum((lens + CHUNK - 1) // CHUNK, 1)
    return SpmvCounts(int(n_chunks.sum()), int(n_chunks.max()), int(lens.sum()))


def _on_device(host: torch.Tensor, dev) -> torch.Tensor:
    """A small host tensor on ``dev`` without waiting for the stream: a
    copy from pinned memory (one from pageable memory waits for all the
    work queued before it)."""
    if dev.type == "cpu":
        return host
    return host.pin_memory().to(dev, non_blocking=True)


def spmv_group(
    layouts: Sequence[RowLayout], x_slots: Sequence[int], n_x: Sequence[int],
    windows: Optional[int] = None, counts: Optional[SpmvCounts] = None,
) -> SpmvGroup:
    """The work list of ``layouts`` (all on one device): matrix m reads x
    slot ``x_slots[m]``, a vector of ``n_x[m]`` floats. Tensor ops only,
    with one host sync (the work list's length, with the check that
    every live column lies inside its x: the kernel does not check),
    or none where the caller gives those ``counts``, checked on the
    host (``host_spmv_counts``).
    ``windows``: the layouts are stacked windows' block-diagonal ones
    (``SpmvGroup.windows``), n_x and their rows counted over all of
    them."""
    n_mats = len(layouts)
    if n_mats == 0 or not n_mats == len(x_slots) == len(n_x):
        raise ValueError("spmv_group: one x slot and one n_x per layout")
    if any(not 0 <= int(s) < MAX_X for s in x_slots):
        raise ValueError(f"spmv_group: x slots must lie in [0, {MAX_X})")
    dev = layouts[0].cols.device
    i64 = dict(dtype=torch.int64, device=dev)
    n_rows = [lay.n_rows for lay in layouts]
    n_e = [lay.cols.shape[0] for lay in layouts]
    e_off = (0, *itertools.accumulate(n_e))
    n_y, n_e_all = sum(n_rows), e_off[-1]
    if max(n_e_all, n_y, *n_x) > INT32_MAX:
        raise ValueError("spmv_group: extents must fit int32")
    # Whole-group tensor ops (a few dozen launches, not a few per matrix):
    # this runs once per window on the rank path.
    meta = _on_device(
        torch.tensor([n_rows, x_slots, e_off[:-1], n_e, n_x], dtype=torch.int64), dev
    )
    row_slot, row_e_off = torch.repeat_interleave(
        meta[1:3], meta[0], dim=1, output_size=n_y
    )
    starts = torch.cat([lay.indptr[:-1] for lay in layouts]).to(torch.int64)
    lens = torch.cat([lay.indptr[1:] for lay in layouts]).to(torch.int64) - starts
    row_beg = starts + row_e_off
    n_chunks = torch.clamp_min((lens + CHUNK - 1) // CHUNK, 1)
    first_item = torch.cumsum(n_chunks, 0) - n_chunks
    cols = torch.cat([lay.cols for lay in layouts])
    if counts is None:
        live_end, entry_n_x = torch.repeat_interleave(
            torch.stack([
                torch.cat([lay.indptr[-1:] for lay in layouts]).to(torch.int64) + meta[2],
                meta[4],
            ]),
            meta[3], dim=1, output_size=n_e_all,
        )
        n_bad = (
            ((cols < 0) | (cols >= entry_n_x)) & (torch.arange(n_e_all, **i64) < live_end)
        ).sum()
        n_items, max_chunks, n_bad, n_live = (
            torch.stack([n_chunks.sum(), n_chunks.max(), n_bad, lens.sum()]).tolist()
            if n_y else (0, 1, 0, 0)
        )
        if n_bad:
            # The graph build pads with col 0, so an out-of-range column is a
            # bug upstream: stop here instead of clamping it silently.
            raise IndexError(f"spmv_group: {n_bad} column(s) outside their x")
    else:
        n_items, max_chunks, n_live = counts
    if n_items > INT32_MAX // WARP:
        raise ValueError("spmv_group: work list must fit int32")
    item_row = torch.repeat_interleave(
        torch.arange(n_y, **i64), n_chunks, output_size=n_items
    )
    chunk = torch.arange(n_items, **i64) - first_item[item_row]
    begin = row_beg[item_row] + chunk * CHUNK
    end = torch.minimum(begin + CHUNK, (row_beg + lens)[item_row])
    items = torch.stack(
        [row_slot[item_row], item_row, begin, end, chunk, n_chunks[item_row]], 1
    ).to(torch.int32)

    # The plain version's lane bucket of every entry: kernel lane l of an
    # item sums the item's positions begin + l, + l + 32, ...; padding
    # goes to a sentinel bucket past the last item.
    size = end - begin
    entry_item = torch.repeat_interleave(
        torch.arange(n_items, **i64), size, output_size=n_live
    )
    in_item = torch.arange(n_live, **i64) - (torch.cumsum(size, 0) - size)[entry_item]
    bucket = torch.full((n_e_all,), n_items * WARP, **i64).index_put_(
        (begin[entry_item] + in_item,), entry_item * WARP + in_item % WARP
    )

    return SpmvGroup(
        items=items.contiguous(),
        cols=cols,
        vals=torch.cat([lay.vals for lay in layouts]),
        part=torch.zeros(n_items, dtype=torch.float32, device=dev),
        counters=torch.zeros(n_y, dtype=torch.int32, device=dev),
        bucket=bucket,
        chunk_slot=item_row * max_chunks + chunk,
        row_chunks=n_chunks,
        x_slots=tuple(int(s) for s in x_slots),
        n_x=tuple(int(n) for n in n_x),
        n_rows=tuple(n_rows),
        entry_offsets=e_off,
        max_chunks=int(max_chunks),
        windows=windows,
    )


def _split(group: SpmvGroup, y: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    ys = y.split_with_sizes(group.n_rows)
    if group.windows is None:
        return tuple(ys)
    return tuple(t.view(group.windows, -1) for t in ys)


def _flat_xs(group: SpmvGroup, xs: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
    """A stacked group's x slots, [B, n] each, as the flat vectors its
    block-diagonal layouts index (views of contiguous tensors)."""
    if group.windows is None:
        return xs
    if any(x.dim() != 2 or x.shape[0] != group.windows for x in xs):
        raise ValueError(f"coo_spmv: every x of a stacked group is [{group.windows}, n]")
    return [x.reshape(-1) for x in xs]


def _check_xs(group: SpmvGroup, xs: Sequence[torch.Tensor]) -> None:
    if len(xs) <= max(group.x_slots):
        raise ValueError(f"coo_spmv: the group reads {max(group.x_slots) + 1} x slots")
    for slot, n in zip(group.x_slots, group.n_x):
        if xs[slot].shape != (n,):
            raise ValueError(f"coo_spmv: x slot {slot} must hold {n} floats")


def _check_cuda_xs(group: SpmvGroup, xs: Sequence[torch.Tensor], dev) -> None:
    if dev.type != "cuda":
        raise ValueError(f"coo_spmv: unsupported device {dev}")
    if len(xs) > MAX_X:
        raise ValueError(f"coo_spmv: at most {MAX_X} x slots")
    for x in xs:
        if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"coo_spmv: every x must be a contiguous float32 vector on {dev}")
    _check_xs(group, xs)
    if any(t.device != dev for t in (group.items, group.cols, group.vals,
                                     group.part, group.counters)):
        raise ValueError(f"coo_spmv: the group's tensors must lie on {dev}")


def coo_spmv_group_plain(
    group: SpmvGroup, xs: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, ...]:
    """The kernel's arithmetic in plain PyTorch: per-lane sums of each
    chunk in position order (a sequential index_add on the CPU), the same
    shuffle tree (16, 8, 4, 2, 1), then each row's chunk sums folded left
    to right, ((p0 + p1) + p2) ..., masked where a row has no chunk j.
    Padding entries land in a sentinel item's lanes, which are dropped."""
    xs = _flat_xs(group, xs)
    _check_xs(group, xs)
    e = group.entry_offsets
    prod = torch.cat([
        group.vals[a:b] * xs[slot].index_select(0, group.cols[a:b])
        for slot, a, b in zip(group.x_slots, e[:-1], e[1:])
    ])
    n_items = group.items.shape[0]
    lanes = torch.zeros(
        (n_items + 1) * WARP, dtype=torch.float32, device=prod.device
    ).index_add_(0, group.bucket, prod)
    lanes = lanes[: n_items * WARP].view(n_items, WARP)
    off = WARP // 2
    while off:
        lanes = lanes[:, :off] + lanes[:, off: 2 * off]
        off //= 2
    n_y, width = group.row_chunks.shape[0], group.max_chunks
    table = torch.zeros(n_y * width, dtype=torch.float32, device=prod.device)
    table = table.index_copy_(0, group.chunk_slot, lanes[:, 0]).view(n_y, width)
    y = table[:, 0]
    for j in range(1, width):
        y = torch.where(group.row_chunks > j, y + table[:, j], y)
    return _split(group, y)


def coo_spmv_group(
    group: SpmvGroup, xs: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, ...]:
    """y_m = A_m @ xs[x_slots[m]] for every matrix m of the group, as
    views of one flat y. CPU tensors run the plain version; CUDA tensors
    launch the kernel once (counted in ``coo_spmv.launches``, the SpMVs
    in ``coo_spmv.spmvs``) or raise — there is no fallback for a CUDA
    tensor. A group is used by one stream at a time. A stacked group
    (``windows``) reads [B, n] x's and gives [B, n_rows] y's: one launch
    for all its windows."""
    # Checks kept cheap: this runs once per power-iteration step.
    dev = xs[0].device
    if dev.type == "cpu":
        return coo_spmv_group_plain(group, xs)
    xs = _flat_xs(group, xs)
    _check_cuda_xs(group, xs, dev)
    y = torch.empty(sum(group.n_rows), dtype=torch.float32, device=dev)
    n_items = group.items.shape[0]
    if n_items == 0:
        return _split(group, y)
    lib = load_library()
    x_ptrs = (ctypes.c_void_p * len(xs))(*(x.data_ptr() for x in xs))
    rc = lib.mr_coo_spmv_group(
        group.items.data_ptr(), n_items,
        group.cols.data_ptr(), group.vals.data_ptr(),
        group.part.data_ptr(), group.counters.data_ptr(),
        x_ptrs, len(xs), y.data_ptr(),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"coo_spmv launch failed: {lib.mr_cuda_error_string(rc).decode()}"
        )
    coo_spmv.launches += 1
    coo_spmv.spmvs += len(group.x_slots) * (group.windows or 1)
    return _split(group, y)


class EllPart(NamedTuple):
    """One matrix as an ELL slab: row r is ``ops[r]`` / ``vals[r]``, W
    slots (a power of two), its ``lens[r]`` live entries a prefix of the
    row in the row's order and every padding slot of value 0 (a live
    value never is). Reads x slot ``slot``; the kernel reads its rows in
    ``mode`` (``ell_mode``). ``ell_part`` builds one."""

    ops: torch.Tensor   # int32[n_rows, W]
    vals: torch.Tensor  # float32[n_rows, W]
    slot: int
    lens: torch.Tensor  # int32[n_rows]
    mode: int


def ell_mode(width: int, n_rows: int, n_live: int) -> int:
    """How the kernel reads a slab of ``n_rows`` rows of ``width`` slots
    holding ``n_live`` live entries. At most 32 slots: whole rows,
    32 * min(W, 4) / W rows a warp (ELL_SLAB). Wider (W is the partition's
    longest trace, so one long trace widens every row): by each row's
    length, reading only the columns of 32 slots that hold live entries,
    8 threads a row where rows hold 32 entries or fewer on average
    (ELL_SHORT), else one warp a row with every load of a chunk in
    flight at once, as K1 (ELL_WARP).

    The mode moves no bit: each sums a row's live prefix in K1's order
    for that row as a work item (lane l the positions l, l + 32, ...
    of each chunk of 256, the tree 16 ... 1, the chunks left to right),
    which depends on the row's entries alone; lanes past a narrow row
    hold +0, which changes no sum. So a stacked group's slab, padded to
    its widest window and read in one mode, gives each window the bits
    of its own slab read in its own mode (``ell_spmv_plain`` holds both;
    the card tests hold widths 4 and 64 under one padded width)."""
    if width <= WARP:
        return ELL_SLAB
    return ELL_WARP if n_live > WARP * n_rows else ELL_SHORT


def ell_part(ops: torch.Tensor, vals: torch.Tensor, slot: int,
             mode: Optional[int] = None) -> EllPart:
    """An ``EllPart`` of a slab: its row lengths counted and, unless
    ``mode`` is given, its mode picked from them (one device sync)."""
    lens = (vals != 0).sum(1, dtype=torch.int32)
    if mode is None:
        mode = ell_mode(ops.shape[1], ops.shape[0], int(lens.sum()))
    return EllPart(ops, vals, slot, lens, mode)


class PcsrGroup(NamedTuple):
    """One pcsr step as one launch reads it: the work list ``rows`` of
    the matrices with long rows, then the ELL slabs ``ell``. Output m of
    the step is matrix ``order[m]`` of ``rows``' matrices followed by the
    slabs. A stacked group (``rows.windows`` B): the work list is
    block-diagonal, each slab holds the B windows' rows one after another
    (ops offset into the flat [B * V] x), the x slots are [B, n] and the
    outputs [B, n]."""

    rows: SpmvGroup
    ell: Tuple[EllPart, ...]
    order: Tuple[int, ...]


def ell_spmv_plain(ops: torch.Tensor, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The kernel's trace-side sums in plain PyTorch, in K1's order for
    the same row as a work item: K1 lane l of a chunk of 256 slots sums
    slots l, l + 32, ... in order (padding skipped, never multiplied),
    then the tree over the row's min(W, 32) lanes (K1's lanes past W
    hold +0, which changes no bit), then the chunks whose first slot is
    live, folded left to right."""
    n_rows, width = ops.shape
    lanes = min(width, WARP)
    n_chunks = max(1, width // CHUNK)
    shape = (n_rows, n_chunks, min(width, CHUNK) // lanes, lanes)
    live = vals != 0
    prod = torch.where(live, vals * x[ops], 0.0).view(shape)
    live_k = live.view(shape)
    acc = torch.zeros((n_rows, n_chunks, lanes), dtype=torch.float32, device=ops.device)
    for k in range(shape[2]):
        acc = torch.where(live_k[:, :, k], acc + prod[:, :, k], acc)
    off = lanes // 2
    while off:
        acc = acc[..., :off] + acc[..., off: 2 * off]
        off //= 2
    y = acc[:, 0, 0]
    for c in range(1, n_chunks):
        y = torch.where(live[:, c * CHUNK], y + acc[:, c, 0], y)
    return y


def _ell_split(group: PcsrGroup, y: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    outs = y.split_with_sizes([*group.rows.n_rows, *(e.ops.shape[0] for e in group.ell)])
    if group.rows.windows is not None:
        outs = [t.view(group.rows.windows, -1) for t in outs]
    return tuple(outs[m] for m in group.order)


def pcsr_spmv_group_plain(
    group: PcsrGroup, xs: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, ...]:
    """The pcsr step's plain version: ``coo_spmv_group_plain`` over the
    work list, ``ell_spmv_plain`` over each slab."""
    flat = _flat_xs(group.rows, xs)
    y = torch.cat([
        *(t.reshape(-1) for t in coo_spmv_group_plain(group.rows, xs)),
        *(ell_spmv_plain(e.ops, e.vals, flat[e.slot]) for e in group.ell),
    ])
    return _ell_split(group, y)


def pcsr_spmv_group(
    group: PcsrGroup, xs: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, ...]:
    """Every product of one pcsr step, in ``group.order``, as views of
    one flat y. CPU tensors run the plain version; CUDA tensors launch
    the kernel once (counted in ``pcsr_spmv_group.launches``, the SpMVs
    in ``.spmvs``, a stacked group's per window) or raise: there is no
    fallback for a CUDA tensor. A group is used by one stream at a time.
    A stacked group reads [B, n] x's and gives [B, n] outputs, one launch
    for all its windows."""
    dev = xs[0].device
    if dev.type == "cpu":
        return pcsr_spmv_group_plain(group, xs)
    rows = group.rows
    xs = _flat_xs(rows, xs)
    _check_cuda_xs(rows, xs, dev)
    if not 0 < len(group.ell) <= MAX_ELL:
        raise ValueError(f"pcsr_spmv: 1 to {MAX_ELL} ELL slabs")
    for e in group.ell:
        if not 0 <= e.slot < len(xs):
            raise ValueError(f"pcsr_spmv: ELL x slot {e.slot} is not given")
        for t, dtype in ((e.ops, torch.int32), (e.vals, torch.float32)):
            if (t.device != dev or t.dtype != dtype or t.dim() != 2
                    or not t.is_contiguous() or t.data_ptr() % 16):
                raise ValueError(
                    f"pcsr_spmv: ELL slabs must be contiguous, 16-byte aligned "
                    f"int32 / float32 matrices on {dev}"
                )
        width = e.ops.shape[1]
        if e.vals.shape != e.ops.shape or width & (width - 1):
            raise ValueError("pcsr_spmv: an ELL slab's width must be a power of two")
        if (e.lens.device != dev or e.lens.dtype != torch.int32
                or e.lens.shape != e.ops.shape[:1] or not e.lens.is_contiguous()):
            raise ValueError(f"pcsr_spmv: ELL row lengths must be contiguous int32 on {dev}")
        if e.mode not in (ELL_SLAB, ELL_SHORT, ELL_WARP) or (e.mode == ELL_SLAB) != (width <= WARP):
            raise ValueError(f"pcsr_spmv: ELL mode {e.mode} does not fit a width of {width}")
    ell = group.ell
    n_k1 = sum(rows.n_rows)
    n_ell = [e.ops.shape[0] for e in ell]
    y = torch.empty(n_k1 + sum(n_ell), dtype=torch.float32, device=dev)
    lib = load_library()
    ptr, i32, k = ctypes.c_void_p, ctypes.c_int32, len(ell)
    rc = lib.mr_pcsr_step(
        rows.items.data_ptr(), rows.items.shape[0],
        rows.cols.data_ptr(), rows.vals.data_ptr(),
        rows.part.data_ptr(), rows.counters.data_ptr(),
        (ptr * len(xs))(*(x.data_ptr() for x in xs)), len(xs), y.data_ptr(),
        (ptr * k)(*(e.ops.data_ptr() for e in ell)),
        (ptr * k)(*(e.vals.data_ptr() for e in ell)),
        (ptr * k)(*(e.lens.data_ptr() for e in ell)),
        (i32 * k)(*(e.mode for e in ell)),
        (i32 * k)(*(e.slot for e in ell)),
        (i32 * k)(*n_ell),
        (i32 * k)(*(e.ops.shape[1] for e in ell)),
        (ctypes.c_int64 * k)(*itertools.accumulate(n_ell[:-1], initial=n_k1)),
        k,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"pcsr_spmv launch failed: {lib.mr_cuda_error_string(rc).decode()}")
    pcsr_spmv_group.launches += 1
    pcsr_spmv_group.spmvs += (len(rows.x_slots) + k) * (rows.windows or 1)
    return _ell_split(group, y)


# Counts of the pcsr kernel's launches and of the SpMVs they computed
# (plain ints; pcsr_spmv_group is the one place that launches it).
pcsr_spmv_group.launches = 0
pcsr_spmv_group.spmvs = 0


def coo_spmv_plain(layout: RowLayout, x: torch.Tensor) -> torch.Tensor:
    """The plain version of ``coo_spmv``: a group of one."""
    return coo_spmv_group_plain(spmv_group([layout], (0,), (x.shape[0],)), (x,))[0]


def coo_spmv(layout: RowLayout, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x over one row layout: a group of one (its work list is
    built on every call, so the rank program builds its group once per
    window and calls ``coo_spmv_group`` instead)."""
    return coo_spmv_group(spmv_group([layout], (0,), (x.shape[0],)), (x,))[0]


# Counts of the chunked kernel's launches and of the SpMVs they computed,
# a stacked group's counted per window (plain ints; coo_spmv_group is the
# one place that launches).
coo_spmv.launches = 0
coo_spmv.spmvs = 0


def nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def build_command(out: Path) -> List[str]:
    """The nvcc command that builds the kernel library into ``out``
    (``-Xptxas -v`` reports registers, shared memory and spills)."""
    return [
        nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v", "-o", str(out), str(SOURCE),
    ]


def build_library() -> str:
    """Compile the kernel library if it is missing or older than its
    source; returns the compiler's report ("" when up to date)."""
    if not is_stale(LIB_PATH, [SOURCE]):
        return ""
    tmp = tmp_output(LIB_PATH)
    return run_build(build_command(tmp), tmp, LIB_PATH)


def load_library() -> ctypes.CDLL:
    global _lib
    # The window loop's stage worker may be the first caller while the
    # main thread also gets here: one thread builds and binds.
    with _lib_lock:
        if _lib is None:
            build_library()
            _lib = _bind(ctypes.CDLL(str(LIB_PATH)))
    return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the library's C signatures."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int32
    lib.mr_coo_spmv_group.restype = ctypes.c_int
    lib.mr_coo_spmv_group.argtypes = [
        ptr, i32,                         # items, n_items
        ptr, ptr, ptr, ptr,               # cols, vals, part, counters
        ctypes.POINTER(ptr), i32, ptr,    # xs, n_xs, y
        ctypes.c_int, ptr,                # device, stream
    ]
    lib.mr_pcsr_step.restype = ctypes.c_int
    lib.mr_pcsr_step.argtypes = [
        ptr, i32, ptr, ptr, ptr, ptr,     # items, n_items, cols, vals, part, counters
        ctypes.POINTER(ptr), i32, ptr,    # xs, n_xs, y
        ctypes.POINTER(ptr), ctypes.POINTER(ptr),  # ell_ops, ell_vals
        ctypes.POINTER(ptr), ctypes.POINTER(i32),  # ell_lens, ell_mode
        ctypes.POINTER(i32), ctypes.POINTER(i32), ctypes.POINTER(i32),  # slot, rows, width
        ctypes.POINTER(ctypes.c_int64), i32,  # ell_y, n_ell
        ctypes.c_int, ptr,                # device, stream
    ]
    # The first, warp-per-row design, for chip_smoke.py's comparison only.
    lib.mr_coo_spmv_rows.restype = ctypes.c_int
    lib.mr_coo_spmv_rows.argtypes = [
        ptr, ptr, ptr, ptr, ptr,          # indptr, cols, vals, x, y
        i32, i32, ctypes.c_int, ptr,      # n_rows, n_x, device, stream
    ]
    lib.mr_cuda_error_string.restype = ctypes.c_char_p
    lib.mr_cuda_error_string.argtypes = [ctypes.c_int]
    return lib
