"""K10: the csr route's products in JAX's order of sums, as a
hand-written CUDA kernel (``csrc/csr_scan.cu``) with its plain PyTorch
version beside it.

It replaces what XLA compiles for the TPU in
``microrank_tpu/rank_backends/jax_tpu.py:671-700`` (kernel="csr",
``csr_rowsum``): for each matrix in CSR order, the entry products
``vals * x[cols]``, their double-f32 inclusive prefix scan
(``microrank_tpu/ops/segment.py`` ``compensated_cumsum``, JAX's
``lax.associative_scan`` with the TwoSum combine ``_two_sum``), then
each row's ``(hi[b] - hi[a]) + (lo[b] - lo[a])`` over its offsets, a
zero pair prepended to the scan.

* ``scan_group`` — once a window: the six matrices of a step (p_sr,
  p_ss, p_rs of each partition, read from the CSR views), each window
  of a stacked group a segment of its own (its scan restarts at its
  first entry, as JAX's vmapped program scans each window), with the
  kernel's segment table, its tiles of 2,048 entries and each tile's
  run of row offsets (``marks``), scratch and launch plan
  (``tile_plan``: one cooperative launch a step on a grid of a block an
  SM, each block a run of tiles, their products held in shared memory
  across the grid barrier where they fit).
* ``csr_scan_spmv`` — every step: on CUDA tensors one launch of
  ``scan_step`` (counted in ``csr_scan_spmv.launches``) or it raises; on
  CPU tensors ``csr_scan_spmv_plain``, which runs JAX's recursion itself
  (``compensated_scan``), so both give JAX's bits for the same products.
  A matrix past 2048^2 entries, or a group past the plan's shared
  memory, takes the first design (``design="levels"``: ``2 D + 2``
  launches, D the levels of block totals), which also stays for
  comparison (``scan_group(..., levels=True)``).
"""

from __future__ import annotations

import ctypes
import struct
import threading
from pathlib import Path
from collections import Counter
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..utils.build import BUILD_DIR, is_stale, run_build, tmp_output
from .spmv import INT32_MAX, _on_device, nvcc

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "csr_scan.cu"
LIB_PATH = BUILD_DIR / "libmr_csr_scan.so"
BLOCK = 2048      # entries a block of the kernel (csrc/csr_scan.cu kBlock)
MAX_LEVELS = 3    # levels of block totals (kMaxLevels): 2048^3 entries
MAX_X = 4         # x slots (kMaxX)
# A segment's words (csrc/csr_scan.cu enum Seg): entry offset, live
# count, x slot, x offset, out offset; scan_step's first tile and tiles;
# the first design's level offsets and lengths.
SEG_WORDS = 7 + 2 * MAX_LEVELS
# The argument block of the first design (csrc/csr_scan.cu enum Word):
# cols, vals, segs, n_seg, x[4], out, levels, rows, n_rows, y, depth,
# blocks[4], device, stream.
ARGS = struct.Struct(f"<{12 + MAX_X + MAX_LEVELS + 1}q")
# scan_step's (enum StepWord): cols, vals, segs, n_seg, x[4], tiles,
# n_tiles, marks, n_marks, mark rows, totals, ends, y, grid, per, held,
# smem, stamps, device, stream.
STEP_ARGS = struct.Struct(f"<{19 + MAX_X}q")
# The phases scan_step stamps (csrc kStepStamps): block 0's start, then
# the latest block's end of the products and tile totals, the first grid
# barrier, the top scans, the down-sweeps and row offsets, the second
# barrier, the rows.
STEP_STAMPS = 7
# A tile's words (enum TileWord): segment, index in it, first and end mark.
TILE_WORDS = 4
STEP_THREADS = 1024   # a scan_step block (kStepThreads)
TOP_MAX = BLOCK       # tile totals a segment scan_step scans (kTopMax)
DESIGNS = ("step", "levels")
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def two_sum(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Knuth's TwoSum as JAX's ``_two_sum``: s = fl(a + b), e its error."""
    s = a + b
    t = s - a
    return s, (a - (s - t)) + (b - t)


def _comb(a, b):
    hi, e = two_sum(a[0], b[0])
    return hi, (e + a[1]) + b[1]


def compensated_scan(hi: torch.Tensor, lo: Optional[torch.Tensor] = None):
    """JAX's ``compensated_cumsum`` along the last axis, in the combine
    tree of ``lax.associative_scan``: combine adjacent pairs, scan that
    half-length array, then each even position i > 0 as comb(scan at
    i - 1, element i). Returns (hi, lo)."""
    if lo is None:
        lo = torch.zeros_like(hi)
    n = hi.shape[-1]
    if n < 2:
        return hi, lo
    r = _comb((hi[..., 0:-1:2], lo[..., 0:-1:2]), (hi[..., 1::2], lo[..., 1::2]))
    odd = compensated_scan(*r)
    head = odd if n % 2 else (odd[0][..., :-1], odd[1][..., :-1])
    even = _comb(head, (hi[..., 2::2], lo[..., 2::2]))
    out = []
    for first, e, o in zip((hi, lo), even, odd):
        t = torch.empty_like(first)
        t[..., 0:1] = first[..., 0:1]
        t[..., 2::2] = e
        t[..., 1::2] = o
        out.append(t)
    return tuple(out)


class TilePlan(NamedTuple):
    """scan_step's launch, as the host plans it (``tile_plan``)."""

    grid: int   # blocks, all resident (a block an SM)
    per: int    # tiles a block (the last block's run may be shorter)
    held: int   # tiles a block holds in shared memory across the grid barrier
    smem: int   # a block's dynamic shared memory, bytes


class ScanGroup(NamedTuple):
    """A step's matrices as the kernel reads them (``scan_group``)."""

    cols: torch.Tensor      # int32 [N]: every matrix's [B, E_m] entries, flat
    vals: torch.Tensor      # float32 [N]
    indptr: Tuple[torch.Tensor, ...]  # per matrix int64 [B, n_rows + 1]
    segs: torch.Tensor      # int64 [S, SEG_WORDS] (segment (m, b) at m * B + b)
    tiles: torch.Tensor     # int32 [T, TILE_WORDS]: every segment's tiles in order
    marks: torch.Tensor     # int32 [sum of rows + 1]: every segment's row offsets
    mark_rows: torch.Tensor  # int32 [marks]: the row of y starting at each mark, -1 at a segment's last
    totals: torch.Tensor    # float32 [T, 2]: scan_step's tile totals
    ends: torch.Tensor      # float32 [marks, 2]: the scan at each row offset
    plan: Optional[TilePlan]  # None: the first design
    rows: Optional[torch.Tensor]    # int32 [n_y, 2]: a row's scan ends in ``out``
    out: Optional[torch.Tensor]     # float32 [N + S, 2]: (hi, lo), a zero pair a segment's head
    levels: Optional[torch.Tensor]  # float32 [L, 2]: block totals of levels 1..D
    blocks: Tuple[int, ...]  # the first design's grid x, levels 0..D
    x_slots: Tuple[int, ...]
    n_x: Tuple[int, ...]    # a window's x length per matrix
    n_rows: Tuple[int, ...]  # a window's rows per matrix
    e_pad: Tuple[int, ...]  # a window's entries per matrix
    windows: Optional[int]


def _levels(e: int, depth: int) -> List[int]:
    """A segment of ``e`` entries' padded lengths at levels 1..depth, each
    the block count of the level below and at least 1, so that every
    segment of a launch has every level (a short one's top is then a
    single total, its own scan)."""
    out, n = [], e
    for _ in range(depth):
        n = max(1, -(-n // BLOCK))
        out.append(n)
    return out


def _depth(e: int) -> int:
    """Levels of block totals a segment of ``e`` entries needs."""
    d = 0
    while e > BLOCK:
        e, d = -(-e // BLOCK), d + 1
    return d


class CardConfig(NamedTuple):
    """What scan_step gets on one card (``mr_csr_scan_config``)."""

    sms: int
    smem: int   # the most dynamic shared memory a block may take


# An H100 SXM: the CPU tests' card (232,448 bytes opt-in, less the
# kernel's 512 bytes of static shared memory).
H100 = CardConfig(132, 232_448 - 512)


def tile_smem(per: int, held: int) -> int:
    """scan_step's dynamic shared memory (csrc ``step_smem``): two stages
    of a tile's scan pairs, each tile's 32 warp totals and their scans,
    the tiles' scans and the ones before, the held tiles' products."""
    return 2 * BLOCK * 8 + per * (2 * 32 * 8 + 2 * 8) + held * BLOCK * 4


def tile_plan(n_tiles: int, card: CardConfig) -> Optional[TilePlan]:
    """scan_step's grid for ``n_tiles`` tiles on ``card``: a block an SM
    (at most), each a run of ``per`` whole tiles with none empty, and as
    many of its tiles held in shared memory across the grid barrier as
    fit beside the rest of its share (the others compute their products
    again from the L2). None where a run's tables alone exceed the
    share. Pure: the C library checks the same rules again."""
    if n_tiles < 1:
        raise ValueError("tile_plan: at least one tile")
    grid = min(n_tiles, card.sms)
    per = -(-n_tiles // grid)
    grid = -(-n_tiles // per)
    room = card.smem - tile_smem(per, 0)
    if room < 0:
        return None
    held = min(per, room // (BLOCK * 4))
    return TilePlan(grid, per, held, tile_smem(per, held))


_configs: Dict[int, CardConfig] = {}


def kernel_config(device) -> CardConfig:
    """scan_step's limits on ``device`` (a CUDA device), asked once per
    card and kept."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _configs:
        lib = load_library()
        out = (ctypes.c_int32 * 6)()
        rc = lib.mr_csr_scan_config(index, out)
        if rc != 0:
            raise RuntimeError(f"csr_scan_spmv: device query failed: "
                               f"{lib.mr_csr_scan_error_string(rc).decode()}")
        if (out[2], out[3], out[4], out[5]) != (STEP_ARGS.size // 8, BLOCK, TOP_MAX,
                                                STEP_STAMPS):
            raise RuntimeError("csr_scan_spmv: the library's argument block is not the "
                               "wrapper's")
        _configs[index] = CardConfig(out[0], out[1])
    return _configs[index]


def _tile_table(indptrs, e_pad, n_rows, b, dev):
    """The tiles of every segment in order (``TILE_WORDS`` each), the
    segments' row offsets (``marks``) and the row of y that starts at
    each (-1 at a segment's last): tile t of a segment takes the offsets
    o with o - 1 in [2048 t, 2048 (t + 1)); its first tile also the
    offsets equal to 0. Tensor ops only (``searchsorted`` over the
    device's indptr)."""
    tiles, marks, rows, mark_at, row_at = [], [], [], 0, 0
    for m, (ip, e, r) in enumerate(zip(indptrs, e_pad, n_rows)):
        nt = max(1, -(-e // BLOCK))
        starts = (torch.arange(1, nt, device=dev, dtype=torch.int64) * BLOCK + 1)
        cut = torch.searchsorted(ip.contiguous(), starts.expand(b, nt - 1).contiguous())
        first = torch.cat([torch.zeros((b, 1), dtype=torch.int64, device=dev), cut], 1)
        end = torch.cat([cut, torch.full((b, 1), r + 1, dtype=torch.int64, device=dev)], 1)
        at = mark_at + torch.arange(b, device=dev, dtype=torch.int64)[:, None] * (r + 1)
        seg = m * b + torch.arange(b, device=dev, dtype=torch.int64)[:, None].expand(b, nt)
        index = torch.arange(nt, device=dev, dtype=torch.int64)[None, :].expand(b, nt)
        tiles.append(torch.stack([seg, index, first + at, end + at], -1).reshape(-1, TILE_WORDS))
        marks.append(ip.reshape(-1))
        local = torch.arange(r + 1, device=dev, dtype=torch.int64)[None, :]
        row = row_at + torch.arange(b, device=dev, dtype=torch.int64)[:, None] * r + local
        rows.append(torch.where(local < r, row, -1).reshape(-1))
        mark_at += b * (r + 1)
        row_at += b * r
    return (torch.cat(tiles).to(torch.int32).contiguous(),
            torch.cat(marks).to(torch.int32).contiguous(),
            torch.cat(rows).to(torch.int32).contiguous())


def scan_group(
    matrices: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    x_slots: Sequence[int], n_x: Sequence[int], windows: Optional[int] = None,
    checked: bool = False, levels: bool = False,
) -> ScanGroup:
    """The kernel's group of ``matrices`` (indptr int32 [(B,) rows + 1],
    cols int32 [(B,) E], vals float32 [(B,) E]: a CSR view and its
    entries, each row's entries in the build's order): matrix m reads x
    slot ``x_slots[m]`` of ``n_x[m]`` floats a window. Tensor ops only;
    one host sync checks that every live column lies inside its x,
    none where the caller ``checked`` it on the host (``host_counts``).
    ``levels``: also the first design's scratch (a scan pair an entry),
    for comparison; a group that scan_step does not take always has
    it."""
    if not len(matrices) == len(x_slots) == len(n_x) or not matrices:
        raise ValueError("scan_group: one x slot and one n_x per matrix")
    if any(not 0 <= int(s) < MAX_X for s in x_slots):
        raise ValueError(f"scan_group: x slots must lie in [0, {MAX_X})")
    b = windows or 1
    dev = matrices[0][1].device
    indptrs, cols, vals, e_pad, n_rows, lens = [], [], [], [], [], []
    for indptr, c, v in matrices:
        if c.dtype != torch.int32 or indptr.dtype != torch.int32 or v.dtype != torch.float32:
            raise TypeError("scan_group: indptr and cols int32, vals float32")
        ip = indptr.reshape(b, -1).to(torch.int64)
        indptrs.append(ip)
        cols.append(c.reshape(-1))
        vals.append(v.reshape(-1))
        e_pad.append(int(c.shape[-1]))
        n_rows.append(int(ip.shape[1]) - 1)
        lens.append(ip[:, -1])
    n_total = sum(e * b for e in e_pad)
    n_seg = len(matrices) * b
    depth = max(_depth(e) for e in e_pad)
    levels_at = [_levels(e, depth) for e in e_pad]
    if depth > MAX_LEVELS:
        raise ValueError(f"scan_group: a matrix past {BLOCK ** (MAX_LEVELS + 1)} entries")
    if n_total + n_seg > INT32_MAX:
        raise ValueError("scan_group: extents must fit int32")
    seg_rows, lvl_at, entry_at, out_at, tile_at = [], 0, 0, 0, 0
    for m, (e, lv) in enumerate(zip(e_pad, levels_at)):
        nt = max(1, -(-e // BLOCK))
        for w in range(b):
            offs = []
            for n in lv:
                offs.append(lvl_at)
                lvl_at += n
            pad = MAX_LEVELS - depth
            seg_rows.append([entry_at, 0, int(x_slots[m]), w * int(n_x[m]), out_at,
                             tile_at, nt] + offs + [0] * pad + lv + [0] * pad)
            entry_at += e
            out_at += e + 1
            tile_at += nt
    segs = _on_device(torch.tensor(seg_rows, dtype=torch.int64).reshape(n_seg, SEG_WORDS), dev)
    # The live counts stay on the device (row offsets' last entries).
    segs[:, 1] = torch.cat(lens)
    cols_all = torch.cat(cols)
    if not checked:
        _check_columns(indptrs, cols, n_x, b)
    tiles, marks, mark_rows = _tile_table(indptrs, e_pad, n_rows, b, dev)
    n_tiles = int(tiles.shape[0])
    plan = None
    if depth <= 1:
        plan = tile_plan(n_tiles, H100 if dev.type == "cpu" else kernel_config(dev))
    rows = out = lvl = None
    if levels or plan is None:
        # Row r of segment (m, w) reads out at its head + indptr[r], [r + 1].
        heads = segs[:, 4].view(len(matrices), b, 1)
        rows = torch.cat([
            torch.stack([ip[:, :-1] + heads[m], ip[:, 1:] + heads[m]], -1).reshape(-1, 2)
            for m, ip in enumerate(indptrs)
        ]).to(torch.int32).contiguous()
        out = torch.zeros((n_total + n_seg, 2), dtype=torch.float32, device=dev)
        lvl = torch.zeros((max(lvl_at, 1), 2), dtype=torch.float32, device=dev)
    # Grid x of the first design's launches at levels 0..D (one block a
    # segment at D).
    blocks = [max(max(1, -(-([e] + lv)[d] // BLOCK)) for e, lv in zip(e_pad, levels_at))
              for d in range(depth + 1)]
    return ScanGroup(
        cols=cols_all.contiguous(), vals=torch.cat(vals).contiguous(), indptr=tuple(indptrs),
        segs=segs.contiguous(), tiles=tiles, marks=marks, mark_rows=mark_rows,
        totals=torch.empty((n_tiles, 2), dtype=torch.float32, device=dev),
        ends=torch.empty((int(marks.shape[0]), 2), dtype=torch.float32, device=dev),
        plan=plan, rows=rows, out=out, levels=lvl, blocks=tuple(blocks),
        x_slots=tuple(int(s) for s in x_slots), n_x=tuple(int(n) for n in n_x),
        n_rows=tuple(n_rows), e_pad=tuple(e_pad), windows=windows,
    )


def _check_columns(indptrs, cols, n_x, b) -> None:
    """Raise ``IndexError`` where a live entry's column lies outside its
    x (one host sync): the kernel reads x at it unchecked."""
    bad = []
    for ip, c, n in zip(indptrs, cols, n_x):
        c = c.view(b, -1)
        live = torch.arange(c.shape[1], device=c.device)[None, :] < ip[:, -1:]
        bad.append((((c < 0) | (c >= int(n))) & live).sum())
    n_bad = int(torch.stack(bad).sum()) if bad else 0
    if n_bad:
        raise IndexError(f"scan_group: {n_bad} column(s) outside their x")


def _outputs(group: ScanGroup, y: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    b = group.windows or 1
    ys = y.split_with_sizes([b * r for r in group.n_rows])
    if group.windows is None:
        return tuple(ys)
    return tuple(t.view(b, -1) for t in ys)


def _check_xs(group: ScanGroup, xs: Sequence[torch.Tensor]) -> None:
    if len(xs) <= max(group.x_slots) or len(xs) > MAX_X:
        raise ValueError(f"csr_scan_spmv: the group reads {max(group.x_slots) + 1} x slots")
    lead = () if group.windows is None else (group.windows,)
    for slot, n in zip(group.x_slots, group.n_x):
        if tuple(xs[slot].shape) != lead + (n,):
            raise ValueError(f"csr_scan_spmv: x slot {slot} must be {lead + (n,)}")


def csr_scan_spmv_plain(group: ScanGroup, xs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """JAX's ``csr_rowsum`` of every matrix of the group, in plain
    PyTorch: the products (0 past a window's live entries, which no row
    reads), ``compensated_scan``, the row differences."""
    _check_xs(group, xs)
    b = group.windows or 1
    ys, at = [], 0
    for m, (ip, e, slot, n) in enumerate(zip(group.indptr, group.e_pad, group.x_slots,
                                             group.n_x)):
        cols = group.cols[at: at + b * e].view(b, e).to(torch.int64)
        vals = group.vals[at: at + b * e].view(b, e)
        at += b * e
        live = torch.arange(e, device=cols.device)[None, :] < ip[:, -1:]
        x = xs[slot].reshape(b, n)
        prod = vals * torch.gather(x, 1, torch.where(live, cols, 0))
        hi, lo = compensated_scan(torch.where(live, prod, torch.zeros_like(prod)))
        zero = torch.zeros((b, 1), dtype=torch.float32, device=hi.device)
        hi, lo = torch.cat([zero, hi], 1), torch.cat([zero, lo], 1)
        a_, b_ = ip[:, :-1], ip[:, 1:]
        y = ((torch.gather(hi, 1, b_) - torch.gather(hi, 1, a_))
             + (torch.gather(lo, 1, b_) - torch.gather(lo, 1, a_)))
        ys.append(y if group.windows is not None else y[0])
    return tuple(ys)


def csr_scan_spmv(group: ScanGroup, xs: Sequence[torch.Tensor],
                  design: Optional[str] = None,
                  stamps: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """Every matrix's products of the step, ``csr_rowsum`` of JAX's csr
    route: [rows] each, [B, rows] for a stacked group. CPU tensors run
    the plain version; CUDA tensors launch the kernel once (counted in
    ``csr_scan_spmv.launches``) or raise: there is no fallback for a
    CUDA tensor. ``design``: "step" (scan_step, the default wherever the
    group has a plan) or "levels" (the first design's launches, a
    comparison; the group needs its scratch, ``scan_group(...,
    levels=True)``). ``stamps``: a zeroed int64 tensor of
    ``STEP_STAMPS`` on the card, where scan_step writes the global time
    (ns) at each phase (a measurement; None on the main path). A group
    is used by one stream at a time (its scratch is the window's own)."""
    dev = xs[0].device
    if dev.type == "cpu":
        return csr_scan_spmv_plain(group, xs)
    if dev.type != "cuda":
        raise ValueError(f"csr_scan_spmv: unsupported device {dev}")
    design = design or ("step" if group.plan is not None else "levels")
    if design not in DESIGNS or (design == "step" and group.plan is None) or (
            design == "levels" and group.out is None):
        raise ValueError(f"csr_scan_spmv: the group has no {design!r} design")
    _check_xs(group, xs)
    for x in xs:
        if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"csr_scan_spmv: every x must be a contiguous float32 tensor on "
                             f"{dev}")
    if group.segs.device != dev:
        raise ValueError(f"csr_scan_spmv: the group's tensors must lie on {dev}")
    n_y = sum(r * (group.windows or 1) for r in group.n_rows)
    y = torch.empty(n_y, dtype=torch.float32, device=dev)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    x_ptrs = [x.data_ptr() for x in xs] + [0] * (MAX_X - len(xs))
    stream = torch._C._cuda_getCurrentRawStream(index)
    lib = load_library()
    if design == "step":
        plan = group.plan
        rc = lib.mr_csr_scan_step(STEP_ARGS.pack(
            group.cols.data_ptr(), group.vals.data_ptr(), group.segs.data_ptr(),
            int(group.segs.shape[0]), *x_ptrs, group.tiles.data_ptr(), int(group.tiles.shape[0]),
            group.marks.data_ptr(), int(group.marks.shape[0]), group.mark_rows.data_ptr(),
            group.totals.data_ptr(), group.ends.data_ptr(),
            y.data_ptr(), plan.grid, plan.per, plan.held, plan.smem,
            0 if stamps is None else stamps.data_ptr(), index, stream))
    else:
        depth = len(group.blocks) - 1
        blocks = list(group.blocks) + [0] * (MAX_LEVELS + 1 - len(group.blocks))
        rc = lib.mr_csr_scan(ARGS.pack(
            group.cols.data_ptr(), group.vals.data_ptr(), group.segs.data_ptr(),
            int(group.segs.shape[0]), *x_ptrs, group.out.data_ptr(), group.levels.data_ptr(),
            group.rows.data_ptr(), n_y, y.data_ptr(), depth, *blocks, index, stream))
    if rc != 0:
        raise RuntimeError(f"csr_scan_spmv launch failed: {lib.mr_csr_scan_error_string(rc).decode()}")
    csr_scan_spmv.launches += 1
    csr_scan_spmv.by_design[design] += 1
    csr_scan_spmv.products += len(group.x_slots) * (group.windows or 1)
    return _outputs(group, y)


# Calls of the kernel (scan_step: one launch; the first design: 2 D + 2
# launches on one stream), the same by design, and the products they
# computed, a stacked group's per window (plain ints; csr_scan_spmv is
# the one place that launches it).
csr_scan_spmv.launches = 0
csr_scan_spmv.by_design = Counter()
csr_scan_spmv.products = 0


def build_command(out: Path) -> List[str]:
    """The nvcc command that builds the kernel library into ``out``
    (``-Xptxas -v`` reports registers, shared memory and spills;
    ``-fmad=false``: TwoSum is exact only without contraction)."""
    return [
        nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
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
    with _lib_lock:
        if _lib is None:
            build_library()
            lib = ctypes.CDLL(str(LIB_PATH))
            lib.mr_csr_scan_words.restype = ctypes.c_int
            lib.mr_csr_scan_words.argtypes = []
            if lib.mr_csr_scan_words() != ARGS.size // 8:
                raise RuntimeError("csr_scan_spmv: the library's argument block is not the "
                                   "wrapper's")
            lib.mr_csr_scan.restype = ctypes.c_int
            lib.mr_csr_scan.argtypes = [ctypes.c_char_p]  # ARGS, packed
            lib.mr_csr_scan_step.restype = ctypes.c_int
            lib.mr_csr_scan_step.argtypes = [ctypes.c_char_p]  # STEP_ARGS, packed
            lib.mr_csr_scan_config.restype = ctypes.c_int
            lib.mr_csr_scan_config.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]
            lib.mr_csr_scan_error_string.restype = ctypes.c_char_p
            lib.mr_csr_scan_error_string.argtypes = [ctypes.c_int]
            _lib = lib
    return _lib
