"""K2 / K4: the coverage matvec pair of the kind and packed power
iterations, as a hand-written CUDA kernel (``csrc/pattern_pair.cu``)
with its plain PyTorch version beside it.

It replaces three device programs that XLA wrote for the TPU in
``microrank_tpu/rank_backends/jax_tpu.py`` ``_partition_setup``: the
kind branch's ``cov_pair`` (K2: an int8 0/1 pattern [V, K]), the packed
branch's coverage pair (K4: a big-endian bitmap [V, ceil(T/8)],
``np.packbits`` order), and the packed_blocked branch's (K8: K4's
function in f32, which XLA computed over column blocks of the bitmap so
that the unpacked matrix never exceeds ``packed_block_bytes``). Per partition, with op the identity or
round-to-nearest-even to bf16 of the f32 product:

    y_fwd[r] = sum_c M[r, c] * op(rv[c] * w_len[c])
    y_bwd[c] = sum_r op(sv[r] * w_cov[r]) * M[r, c]
    x_ss[r]  = op(sv[r] * w_out[r])      (packed only: K1's call-graph operand)

Two steps:

* ``pattern_group`` — once per window: each partition's pattern in the
  kernel's one layout (a big-endian bitmap whose rows are padded with
  zero bytes to a multiple of ``ROW_ALIGN`` bytes; an int8 pattern is
  packed to it on its own device, nonzero -> 1), its loop-invariant
  weight vectors, the kernel's scratch (tile partials and arrival
  counters) and, on the CPU, the plain version's 0/1 f32 matrices —
  or, with ``band_bytes`` (packed_blocked), none: the plain version then
  unpacks one band of whole column tiles at a time, at most
  ``band_bytes`` of f32 (one tile where a tile alone is larger).
* ``pattern_pair_group`` — every step: on CUDA tensors one launch
  computes both directions of every partition (counted in
  ``pattern_pair_group.launches``, the matvecs in ``.products``) or
  raises; on CPU tensors it runs ``pattern_pair_plain``, which repeats
  the kernel's arithmetic in the kernel's order, so both give the same
  bits.

The order of each sum follows the kernel's tiles of ``TILE_R`` rows x
``TILE_C`` columns. y_fwd[r]: in each column tile, lane l (of 32) sums
the tile's columns 16l .. 16l + 15 in ascending order, the shuffle tree
16, 8, 4, 2, 1 sums the lanes, and the column tiles' sums fold left to
right. y_bwd[c]: in each row tile, rows in ascending order, then the row
tiles' sums fold top to bottom. Both depend on the index alone, so
equal rows and equal columns give bitwise-equal sums, and a band of
whole column tiles computes its columns' y_bwd and its tiles' part of
the y_fwd fold exactly as the whole matrix does. What bounds the kernel
on the card is in the note at the top of the CUDA source.

Memory on the card: the kernel never unpacks. ``pattern_group`` copies
each bitmap into the kernel's row layout (``_bitmap_rows``), so the
window's bitmaps sit on the card twice, and the scratch holds
n_rt * n_ct * (TILE_R + TILE_C) floats per partition, about 31% of a
bitmap's bytes. At the most that auto sends here (bitmaps of a quarter
of the 2 GiB dense budget, 512 MiB) that is about 1.2 GiB, which fits.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..utils.build import BUILD_DIR, is_stale, run_build, tmp_output
from .spmv import nvcc

WARP = 32
# The kernel's tile (csrc kTileRows x kTileCols): one block each. Tile
# boundaries fix the order of every sum, so the plain version and the
# kernel must agree on them.
TILE_R = 128
TILE_C = 512
LANE_COLS = TILE_C // WARP  # fwd columns one lane sums in a tile
ROW_ALIGN = 16  # bitmap rows are padded to this many bytes (one load)
BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)  # np.packbits: column 8k + j is bit 7 - j
# mr_pattern_pair's layout argument, kept from its older signature: 1 (the
# bitmap) is the one value it accepts.
LAYOUT_BITS = 1
SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "pattern_pair.cu"
LIB_PATH = BUILD_DIR / "libmr_pattern_pair.so"
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


class PatternPart(NamedTuple):
    """One partition's pattern and its loop-invariant vectors."""

    pattern: torch.Tensor          # uint8[V, multiple of ROW_ALIGN >= ceil(n_cols/8)] bitmap
    w_len: torch.Tensor            # float32[n_cols]
    w_cov: torch.Tensor            # float32[V]
    w_out: Optional[torch.Tensor]  # float32[V]: x_ss is computed when given
    part: torch.Tensor             # float32[n_rt * n_ct * (TILE_R + TILE_C)] tile partials
    counters: torch.Tensor         # int32[n_rt + n_ct] stripe arrivals, 0 between launches
    dense: Optional[torch.Tensor]  # float32[V, n_cols] 0/1, the plain version's (CPU)
    n_cols: int
    band_cols: int = 0             # plain version's band of whole column tiles; 0: whole


class PatternGroup(NamedTuple):
    """The partitions one launch computes."""

    parts: Tuple[PatternPart, ...]


def unpack_bits(bits: torch.Tensor, n_cols: int, dtype=torch.float32) -> torch.Tensor:
    """uint8[V, C] -> dtype[V, n_cols]: the inverse of ``np.packbits(...,
    axis=1)`` (big-endian bit order), as ``jax_tpu.unpack_bits``. A plain
    helper for the plain version, the tests and chip_smoke's yardstick;
    the kernel never builds this matrix."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=bits.device)
    b = (bits[:, :, None] >> shifts) & 1
    return b.reshape(bits.shape[0], bits.shape[1] * 8)[:, :n_cols].to(dtype)


def pack_bits(cells: torch.Tensor, n_cols: int) -> torch.Tensor:
    """[V, >= n_cols] cells (nonzero -> 1) -> the kernel's layout: a
    uint8 big-endian bitmap (``np.packbits(..., axis=1)`` order) whose rows
    are padded with zero bytes to a multiple of ROW_ALIGN, on the cells'
    device."""
    v = cells.shape[0]
    width = _row_bytes(n_cols)
    m = torch.zeros((v, width * 8), dtype=torch.uint8, device=cells.device)
    m[:, :n_cols] = cells[:, :n_cols] != 0
    weights = torch.tensor(BIT_WEIGHTS, dtype=torch.uint8, device=cells.device)
    return (m.view(v, width, 8) * weights).sum(-1, dtype=torch.uint8)


def _row_bytes(n_cols: int) -> int:
    return -(-n_cols // (8 * ROW_ALIGN)) * ROW_ALIGN


def _bitmap_rows(pat: torch.Tensor, n_cols: int) -> torch.Tensor:
    """A bitmap copied into the kernel's layout: its first ceil(n_cols/8)
    bytes per row, zero-padded to a multiple of ROW_ALIGN."""
    n_bytes = -(-n_cols // 8)
    out = torch.zeros((pat.shape[0], _row_bytes(n_cols)), dtype=torch.uint8, device=pat.device)
    out[:, :n_bytes] = pat[:, :n_bytes]
    return out


def _n_row_tiles(n_rows: int) -> int:
    return max(1, -(-n_rows // TILE_R))


def _n_col_tiles(n_cols: int) -> int:
    return max(1, -(-n_cols // TILE_C))


def pattern_group(
    patterns: Sequence[torch.Tensor],
    w_lens: Sequence[torch.Tensor],
    w_covs: Sequence[torch.Tensor],
    w_outs: Sequence[Optional[torch.Tensor]],
    n_cols: Sequence[int],
    bits: bool,
    band_bytes: Optional[int] = None,
) -> PatternGroup:
    """The per-window half of the pair for 1 or 2 partitions on one
    device: checks shapes and types once, brings every pattern to the
    kernel's bitmap layout (``bits``: the patterns are bitmaps already,
    else int8 0/1 bytes), allocates the scratch, and on the CPU builds the
    plain version's 0/1 matrices — unless ``band_bytes`` is given and a
    partition's unpacked f32 matrix would exceed it: its plain version
    then works in bands of whole column tiles within ``band_bytes``."""
    if not 1 <= len(patterns) <= 2:
        raise ValueError("pattern_group: 1 or 2 partitions")
    want = torch.uint8 if bits else torch.int8
    dev = patterns[0].device
    parts = []
    for pat, w_len, w_cov, w_out, k in zip(patterns, w_lens, w_covs, w_outs, n_cols):
        k = int(k)
        v = pat.shape[0]
        if pat.dtype != want or pat.dim() != 2:
            raise TypeError(f"pattern_group: patterns must be 2-d {want}")
        if pat.shape[1] < (-(-k // 8) if bits else k):
            raise ValueError(f"pattern_group: a pattern row holds fewer than {k} columns")
        if w_len.shape != (k,) or w_cov.shape != (v,) or (
            w_out is not None and w_out.shape != (v,)
        ):
            raise ValueError("pattern_group: weight vectors must match the pattern")
        vecs = [w_len, w_cov] + ([] if w_out is None else [w_out])
        if any(t.dtype != torch.float32 for t in vecs):
            raise TypeError("pattern_group: weight vectors must be float32")
        if any(t.device != dev for t in [pat, *vecs]):
            raise ValueError("pattern_group: every tensor must lie on one device")
        pat = _bitmap_rows(pat, k) if bits else pack_bits(pat, k)
        n_rt, n_ct = _n_row_tiles(v), _n_col_tiles(k)
        band = 0
        if band_bytes is not None and 4 * v * k > band_bytes:
            band = max(1, band_bytes // (4 * max(v, 1) * TILE_C)) * TILE_C
        parts.append(PatternPart(
            pattern=pat,
            w_len=w_len.contiguous(),
            w_cov=w_cov.contiguous(),
            w_out=None if w_out is None else w_out.contiguous(),
            part=torch.zeros(n_rt * n_ct * (TILE_R + TILE_C), dtype=torch.float32, device=dev),
            counters=torch.zeros(n_rt + n_ct, dtype=torch.int32, device=dev),
            dense=unpack_bits(pat, k) if dev.type == "cpu" and not band else None,
            n_cols=k,
            band_cols=band,
        ))
    return PatternGroup(parts=tuple(parts))


def _op(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    # torch's float32 -> bfloat16 conversion rounds to nearest even.
    return x.to(torch.bfloat16).to(torch.float32) if bf16 else x


def fwd_plain(
    m: torch.Tensor, a: torch.Tensor, y: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """y[r] = sum_c m[r, c] * a[c] in the kernel's order: in each column
    tile of TILE_C, lane l sums columns LANE_COLS * l .. in order and the
    shuffle tree 16, 8, 4, 2, 1 sums the lanes; then the column tiles'
    sums fold left to right. Zero cells add +0.0, which the kernel
    selects instead: the same bits. ``y``: the fold of the column tiles
    left of ``m``, when ``m`` is a band of whole tiles of a wider
    matrix."""
    v, k = m.shape
    n_ct = _n_col_tiles(k)
    prod = torch.zeros((v, n_ct * TILE_C), dtype=torch.float32, device=m.device)
    prod[:, :k] = m * a
    prod = prod.view(v, n_ct, WARP, LANE_COLS)
    lanes = torch.zeros((v, n_ct, WARP), dtype=torch.float32, device=m.device)
    for j in range(LANE_COLS):
        lanes = lanes + prod[..., j]
    off = WARP // 2
    while off:
        lanes = lanes[..., :off] + lanes[..., off: 2 * off]
        off //= 2
    if y is None:
        y = torch.zeros(v, dtype=torch.float32, device=m.device)
    for j in range(n_ct):
        y = y + lanes[:, j, 0]
    return y


def bwd_plain(m: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y[c] = sum_r b[r] * m[r, c] in the kernel's order: rows in order
    inside each row tile of TILE_R, then the row tiles' sums folded top
    to bottom."""
    v, k = m.shape
    n_rt = _n_row_tiles(v)
    prod = torch.zeros((n_rt * TILE_R, k), dtype=torch.float32, device=m.device)
    prod[:v] = b[:, None] * m
    prod = prod.view(n_rt, TILE_R, k)
    acc = torch.zeros((n_rt, k), dtype=torch.float32, device=m.device)
    for i in range(TILE_R):
        acc = acc + prod[:, i]
    y = torch.zeros(k, dtype=torch.float32, device=m.device)
    for j in range(n_rt):
        y = y + acc[j]
    return y


def pattern_pair_plain(
    group: PatternGroup,
    rvs: Sequence[torch.Tensor],
    svs: Sequence[torch.Tensor],
    bf16: bool = False,
) -> Tuple[Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]], ...]:
    """The kernel's arithmetic in plain PyTorch: per partition (y_fwd,
    y_bwd, x_ss or None)."""
    _check_vectors(group, rvs, svs)
    out = []
    for p, rv, sv in zip(group.parts, rvs, svs):
        a, b = _op(rv * p.w_len, bf16), _op(sv * p.w_cov, bf16)
        if p.band_cols:
            y_fwd, y_bwd = _pair_in_bands(p, a, b)
        else:
            m = p.dense if p.dense is not None else unpack_bits(p.pattern, p.n_cols)
            y_fwd, y_bwd = fwd_plain(m, a), bwd_plain(m, b)
        x_ss = None if p.w_out is None else _op(sv * p.w_out, bf16)
        out.append((y_fwd, y_bwd, x_ss))
    return tuple(out)


def _pair_in_bands(p: PatternPart, a: torch.Tensor, b: torch.Tensor):
    """The plain pair of one partition, unpacking ``p.band_cols`` columns
    (whole TILE_C tiles) at a time: the fwd fold carries from band to
    band, each band gives its own columns' y_bwd."""
    y_fwd = torch.zeros(p.pattern.shape[0], dtype=torch.float32, device=a.device)
    y_bwd = []
    for c0 in range(0, p.n_cols, p.band_cols):
        k = min(p.band_cols, p.n_cols - c0)
        m = unpack_bits(p.pattern[:, c0 // 8: c0 // 8 + -(-k // 8)], k)
        y_fwd = fwd_plain(m, a[c0: c0 + k], y_fwd)
        y_bwd.append(bwd_plain(m, b))
    return y_fwd, torch.cat(y_bwd)


def _check_vectors(group: PatternGroup, rvs, svs) -> None:
    if not len(rvs) == len(svs) == len(group.parts):
        raise ValueError("pattern_pair: one rv and one sv per partition")
    for p, rv, sv in zip(group.parts, rvs, svs):
        if rv.shape != (p.n_cols,) or sv.shape != (p.pattern.shape[0],):
            raise ValueError(
                f"pattern_pair: rv must hold {p.n_cols} and sv "
                f"{p.pattern.shape[0]} floats"
            )


def pattern_pair_group(
    group: PatternGroup,
    rvs: Sequence[torch.Tensor],
    svs: Sequence[torch.Tensor],
    bf16: bool = False,
) -> Tuple[Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]], ...]:
    """Per partition (y_fwd, y_bwd, x_ss or None), as views of one flat
    output. CPU tensors run the plain version; CUDA tensors launch the
    kernel once or raise — there is no fallback for a CUDA tensor. A
    group is used by one stream at a time (its scratch is shared)."""
    # Checks kept cheap: this runs once per power-iteration step.
    dev = rvs[0].device
    if dev.type == "cpu":
        return pattern_pair_plain(group, rvs, svs, bf16)
    if dev.type != "cuda":
        raise ValueError(f"pattern_pair: unsupported device {dev}")
    _check_vectors(group, rvs, svs)
    for x in (*rvs, *svs):
        if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(
                f"pattern_pair: every vector must be a contiguous float32 vector on {dev}"
            )
    if any(p.pattern.device != dev for p in group.parts):
        raise ValueError(f"pattern_pair: the group's tensors must lie on {dev}")
    sizes = []
    for p in group.parts:
        v = p.pattern.shape[0]
        sizes += [v, p.n_cols, 0 if p.w_out is None else v]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    outs = flat.split_with_sizes(sizes)
    ptrs, ints = [], []
    for i, (p, rv, sv) in enumerate(zip(group.parts, rvs, svs)):
        y_fwd, y_bwd, x_ss = outs[3 * i: 3 * i + 3]
        ptrs += [
            p.pattern.data_ptr(), rv.data_ptr(), p.w_len.data_ptr(),
            sv.data_ptr(), p.w_cov.data_ptr(),
            None if p.w_out is None else p.w_out.data_ptr(),
            y_fwd.data_ptr(), y_bwd.data_ptr(),
            None if p.w_out is None else x_ss.data_ptr(),
            p.part.data_ptr(), p.counters.data_ptr(),
        ]
        ints += [p.pattern.shape[1], p.pattern.shape[0], p.n_cols]
    lib = load_library()
    rc = lib.mr_pattern_pair(
        (ctypes.c_void_p * len(ptrs))(*ptrs),
        (ctypes.c_int64 * len(ints))(*ints),
        len(group.parts), LAYOUT_BITS, int(bool(bf16)),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"pattern_pair launch failed: {lib.mr_pattern_error_string(rc).decode()}"
        )
    pattern_pair_group.launches += 1
    pattern_pair_group.products += 2 * len(group.parts)
    return tuple(
        (outs[3 * i], outs[3 * i + 1], outs[3 * i + 2] if p.w_out is not None else None)
        for i, p in enumerate(group.parts)
    )


# Counts of the kernel's launches and of the matvecs they computed (two
# per partition; plain ints, pattern_pair_group is the one place that
# launches).
pattern_pair_group.launches = 0
pattern_pair_group.products = 0


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
    ptr = ctypes.c_void_p
    lib.mr_pattern_pair.restype = ctypes.c_int
    lib.mr_pattern_pair.argtypes = [
        ctypes.POINTER(ptr), ctypes.POINTER(ctypes.c_int64),  # ptrs, ints
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,       # n_parts, bits, bf16
        ctypes.c_int, ptr,                                    # device, stream
    ]
    lib.mr_pattern_error_string.restype = ctypes.c_char_p
    lib.mr_pattern_error_string.argtypes = [ctypes.c_int]
    return lib


__all__ = [
    "ROW_ALIGN",
    "TILE_C",
    "TILE_R",
    "PatternGroup",
    "PatternPart",
    "bwd_plain",
    "fwd_plain",
    "pack_bits",
    "pattern_group",
    "pattern_pair_group",
    "pattern_pair_plain",
    "unpack_bits",
]
