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
* ``spmv_group`` — once per window: one work list for several row
  layouts (a power-iteration step's six matrices). Every row is cut into
  chunks of at most ``CHUNK`` entries at positions ``[j * CHUNK,
  (j + 1) * CHUNK)`` of the row; an empty row gets one empty item.
* ``coo_spmv_group`` — every step: on CUDA tensors one launch computes
  every matrix of the group (one warp per item, fixed-order lane sums
  and shuffle tree, the chunks of a row folded left to right by the last
  warp to arrive; no float atomics) or raises; on CPU tensors it runs
  ``coo_spmv_group_plain``, which repeats the kernel's arithmetic in the
  kernel's order, so both give the same bits. ``coo_spmv`` is a group of
  one.

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

import torch

from ..utils.build import BUILD_DIR, is_stale, run_build, tmp_output

WARP = 32
# Entries per work item (csrc/coo_spmv.cu kChunk). Chunk boundaries fix
# the order of every sum, so this is part of the function's bits, not a
# tuning knob: the plain version and the kernel must agree on it.
CHUNK = 256
MAX_X = 8  # x slots a group may read (csrc/coo_spmv.cu kMaxX)
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
) -> RowLayout:
    """Row-sorted layout of COO entries (``rows``/``cols`` int32,
    ``vals`` float32). Entries ``e >= n_live`` are padding and are left
    out of every row; None keeps all entries."""
    if rows.dtype != torch.int32 or cols.dtype != torch.int32:
        raise TypeError("rows and cols must be int32")
    if vals.dtype != torch.float32:
        raise TypeError("vals must be float32")
    e = rows.shape[0]
    key = rows.to(torch.int64)
    if n_live is not None:
        pos = torch.arange(e, device=rows.device)
        key = torch.where(pos < n_live, key, n_rows)
    counts = torch.bincount(key, minlength=n_rows + 1)
    if counts.shape[0] != n_rows + 1:
        raise ValueError(f"row index out of range for n_rows={n_rows}")
    perm = torch.sort(key, stable=True).indices
    starts = torch.zeros(n_rows + 2, dtype=torch.int64, device=rows.device)
    torch.cumsum(counts, 0, out=starts[1:])
    return RowLayout(
        indptr=starts[: n_rows + 1].to(torch.int32),
        cols=cols[perm],
        vals=vals[perm],
        perm=perm,
        n_rows=int(n_rows),
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


def spmv_group(
    layouts: Sequence[RowLayout], x_slots: Sequence[int], n_x: Sequence[int]
) -> SpmvGroup:
    """The work list of ``layouts`` (all on one device): matrix m reads x
    slot ``x_slots[m]``, a vector of ``n_x[m]`` floats. Tensor ops only,
    with one host sync (the work list's length, with the check that
    every live column lies inside its x: the kernel does not check)."""
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
    meta = torch.tensor([n_rows, x_slots, e_off[:-1], n_e, n_x], **i64)
    row_slot, row_e_off = torch.repeat_interleave(
        meta[1:3], meta[0], dim=1, output_size=n_y
    )
    starts = torch.cat([lay.indptr[:-1] for lay in layouts]).to(torch.int64)
    lens = torch.cat([lay.indptr[1:] for lay in layouts]).to(torch.int64) - starts
    row_beg = starts + row_e_off
    n_chunks = torch.clamp_min((lens + CHUNK - 1) // CHUNK, 1)
    first_item = torch.cumsum(n_chunks, 0) - n_chunks
    cols = torch.cat([lay.cols for lay in layouts])
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
    )


def _split(group: SpmvGroup, y: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    return tuple(y.split_with_sizes(group.n_rows))


def _check_xs(group: SpmvGroup, xs: Sequence[torch.Tensor]) -> None:
    if len(xs) <= max(group.x_slots):
        raise ValueError(f"coo_spmv: the group reads {max(group.x_slots) + 1} x slots")
    for slot, n in zip(group.x_slots, group.n_x):
        if xs[slot].shape != (n,):
            raise ValueError(f"coo_spmv: x slot {slot} must hold {n} floats")


def coo_spmv_group_plain(
    group: SpmvGroup, xs: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, ...]:
    """The kernel's arithmetic in plain PyTorch: per-lane sums of each
    chunk in position order (a sequential index_add on the CPU), the same
    shuffle tree (16, 8, 4, 2, 1), then each row's chunk sums folded left
    to right, ((p0 + p1) + p2) ..., masked where a row has no chunk j.
    Padding entries land in a sentinel item's lanes, which are dropped."""
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
    tensor. A group is used by one stream at a time."""
    # Checks kept cheap: this runs once per power-iteration step.
    dev = xs[0].device
    if dev.type == "cpu":
        return coo_spmv_group_plain(group, xs)
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
    coo_spmv.spmvs += len(group.x_slots)
    return _split(group, y)


def coo_spmv_plain(layout: RowLayout, x: torch.Tensor) -> torch.Tensor:
    """The plain version of ``coo_spmv``: a group of one."""
    return coo_spmv_group_plain(spmv_group([layout], (0,), (x.shape[0],)), (x,))[0]


def coo_spmv(layout: RowLayout, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x over one row layout: a group of one (its work list is
    built on every call, so the rank program builds its group once per
    window and calls ``coo_spmv_group`` instead)."""
    return coo_spmv_group(spmv_group([layout], (0,), (x.shape[0],)), (x,))[0]


# Counts of the chunked kernel's launches and of the SpMVs they computed
# (plain ints; coo_spmv_group is the one place that launches).
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
    # The first, warp-per-row design, for chip_smoke.py's comparison only.
    lib.mr_coo_spmv_rows.restype = ctypes.c_int
    lib.mr_coo_spmv_rows.argtypes = [
        ptr, ptr, ptr, ptr, ptr,          # indptr, cols, vals, x, y
        i32, i32, ctypes.c_int, ptr,      # n_rows, n_x, device, stream
    ]
    lib.mr_cuda_error_string.restype = ctypes.c_char_p
    lib.mr_cuda_error_string.argtypes = [ctypes.c_int]
    return lib
