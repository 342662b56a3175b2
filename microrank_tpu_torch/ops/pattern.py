"""K2 / K4: the coverage matvec pair of the kind and packed power
iterations, as a hand-written CUDA kernel (``csrc/pattern_pair.cu``)
with its plain PyTorch version beside it.

It replaces three device programs that XLA wrote for the TPU in
``microrank_tpu/rank_backends/jax_tpu.py`` ``_partition_setup``: the
kind branch's ``cov_pair`` (K2: a 0/1 pattern [V, K] over the collapsed
kind columns, f32, bf16 or int8 operands), the packed branch's coverage
pair (K4: a big-endian bitmap [V, ceil(T/8)], ``np.packbits`` order),
and the packed_blocked branch's (K8: K4's function in f32, which XLA
computed over column blocks of the bitmap so that the unpacked matrix
never exceeds ``packed_block_bytes``; a kernel of its own,
``pattern_pair_blocked``, for a group built with ``blocked=True``).
Per partition, with op by
precision (``PRECISIONS``): the identity ("f32"), round-to-nearest-even
to bf16 of the f32 product ("bf16"), or JAX's ``quantize_i8`` ("int8":
q = clip(round(x / scale), -127, 127), int32 sums, one f32 multiply by
the scale per output):

    y_fwd[r] = sum_c M[r, c] * op(rv[c] * w_len[c])
    y_bwd[c] = sum_r op(sv[r] * w_cov[r]) * M[r, c]
    x_ss[r]  = op(sv[r] * w_out[r])      (packed only: K1's call-graph operand)

Steps:

* ``pattern_group`` — once per window: each partition's bitmap (the
  kind build's ``cov_bits`` or the packed build's) copied into the
  kernel's one layout (rows padded with zero bytes to a multiple of
  ``ROW_ALIGN`` bytes), its loop-invariant weight vectors, the kernel's
  scratch (tile partials and arrival counters, and the int8 scales'
  running maxima) and, on the CPU, the plain version's 0/1 f32 matrices
  — or, with ``band_bytes`` (packed_blocked), none: the plain version
  then unpacks one band of whole column tiles at a time, at most
  ``band_bytes`` of f32 (one tile where a tile alone is larger).
* ``quantize_scales`` — the four operands' scales of given vectors
  (``scale = amax > 0 ? amax / 127 : 1``, amax = max |x * w| with
  subnormal products flushed to 0), one launch of ``quantize_amax`` on
  CUDA tensors (counted in ``quantize_scales.launches``),
  ``quantize_scales_plain`` on CPU ones. The rank program launches it
  no more: the first step's scales come from the set-up's launch
  (``ops.setup.rank_setup(..., scale_group=group)``, the same function
  of the start vectors it writes), every later step's from the
  power-iteration step that writes the vectors (``ops.step.StepWindow``),
  in the same pass; it stays for the tests and chip_smoke's turns.
* ``pattern_pair_group`` — every step: on CUDA tensors one launch
  computes both directions of every partition (counted in
  ``pattern_pair_group.launches``, K8's in ``.blocked_launches`` too,
  with its fold launch in ``.fold_launches``, the matvecs in
  ``.products``) or raises; on CPU tensors it runs ``pattern_pair_plain``, which repeats
  the kernel's arithmetic in the kernel's order, so both give the same
  bits.

A stacked group of B windows (``pattern_group`` of [B, V, C] bitmaps,
K18) runs every kernel above with a window axis: one launch of the pair
(or of K8 and its fold) a step for all B, ``quantize_amax`` (as the
set-up's scales) with a scale per operand and window ([B, 4]), each
window's scratch its own; a window's bits are those of its own group.

The order of each f32 sum follows the kernel's tiles of ``TILE_R`` rows
x ``TILE_C`` columns. y_fwd[r]: in each column tile, lane l (of 32) sums
the tile's columns 16l .. 16l + 15 in ascending order, the shuffle tree
16, 8, 4, 2, 1 sums the lanes, and the column tiles' sums fold left to
right. y_bwd[c]: in each row tile, rows in ascending order, then the row
tiles' sums fold top to bottom. Both depend on the index alone, so
equal rows and equal columns give bitwise-equal sums, and a band of
whole column tiles computes its columns' y_bwd and its tiles' part of
the y_fwd fold exactly as the whole matrix does. int8 sums are exact in
any order. K8's kernel keeps these orders, skipping the zero cells that
the tile kernel adds as +0.0, so the same plain version holds both.
What bounds each kernel on the card is in the notes of the CUDA source.

Memory on the card: the kernel never unpacks. ``pattern_group`` copies
each bitmap into the kernel's row layout (``_bitmap_rows``), so the
window's bitmaps sit on the card twice, and the scratch holds
n_rt * n_ct * (TILE_R + TILE_C) floats per partition, about 31% of a
bitmap's bytes. At the most that auto sends here (bitmaps of a quarter
of the 2 GiB dense budget, 512 MiB) that is about 1.2 GiB, which fits.
K8's kernel (what auto sends there) keeps only the fwd partials,
n_rt * TILE_R * blocked_ld(n_ct) floats per partition, about 6% of a
bitmap's bytes, where the partition has BLOCKED_TARGET_BLOCKS column
tiles or more (the giant windows); with fewer, the bwd partials too.
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
# Operand precisions, in the order of the kernel's ``precision`` code.
PRECISIONS = ("f32", "bf16", "int8")
MAX_VECS = 4  # int8 operands a step quantizes: 2 partitions x 2 directions
FLT_MIN = torch.finfo(torch.float32).tiny  # the least normal float32
# K8's kernel takes a block per column tile and group of row tiles; the
# groups are sized for about this many blocks per partition: two per SM
# of an H100 (132 SMs). It moves no bit, only the load's spread.
BLOCKED_TARGET_BLOCKS = 264
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
    # The tile kernel's: float32[n_rt * n_ct * (TILE_R + TILE_C)] tile
    # partials and int32[n_rt + n_ct] stripe arrivals, 0 between
    # launches. The blocked kernel's (K8): float32 fwd partials
    # [n_rt * TILE_R, blocked_ld(n_ct)], row-major (``blocked_partials_plain``;
    # when n_ct > 1), then bwd partials [n_rt, n_ct * TILE_C] (when a
    # column tile's row tiles are cut into groups), and no counters (its
    # folds are a launch of their own).
    part: torch.Tensor
    counters: torch.Tensor
    dense: Optional[torch.Tensor]  # float32[V, n_cols] 0/1, the plain version's (CPU)
    n_cols: int
    band_cols: int = 0             # plain version's band of whole column tiles; 0: whole
    rows_per_block: int = 0        # K8: row tiles a block walks (0: the tile kernel's group)


class PatternGroup(NamedTuple):
    """The partitions one launch computes."""

    parts: Tuple[PatternPart, ...]
    # quantize_amax's scratch: the running maxima, then the arrival
    # count (int32[MAX_VECS + 1], 0 between launches).
    amax_scratch: torch.Tensor
    # K8 (packed_blocked): launch the blocked kernel, f32 only.
    blocked: bool = False
    # Stacked windows: every part's tensors carry a leading window axis
    # of this length (pattern [B, V, row bytes], w_len [B, n_cols], w_cov
    # and w_out [B, V], dense [B, V, n_cols], the scratch B windows'),
    # the vectors and outputs are [B, .], the int8 scales [B, 4], and one
    # launch computes every window (the tile kernel in every precision,
    # or K8's). None: one window, 1-d.
    windows: Optional[int] = None


def unpack_bits(bits: torch.Tensor, n_cols: int, dtype=torch.float32) -> torch.Tensor:
    """uint8[..., V, C] -> dtype[..., V, n_cols]: the inverse of
    ``np.packbits(..., axis=-1)`` (big-endian bit order), as
    ``jax_tpu.unpack_bits``. A plain helper for the plain version, the
    tests and chip_smoke's yardstick; the kernel never builds this
    matrix."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=bits.device)
    b = (bits[..., None] >> shifts) & 1
    return b.reshape(*bits.shape[:-1], bits.shape[-1] * 8)[..., :n_cols].to(dtype)


def _row_bytes(n_cols: int) -> int:
    return -(-n_cols // (8 * ROW_ALIGN)) * ROW_ALIGN


def _bitmap_rows(pat: torch.Tensor, n_cols: int) -> torch.Tensor:
    """A bitmap copied into the kernel's layout: its first ceil(n_cols/8)
    bytes per row, zero-padded to a multiple of ROW_ALIGN."""
    n_bytes = -(-n_cols // 8)
    out = torch.zeros((*pat.shape[:-1], _row_bytes(n_cols)), dtype=torch.uint8, device=pat.device)
    out[..., :n_bytes] = pat[..., :n_bytes]
    return out


def _n_row_tiles(n_rows: int) -> int:
    return max(1, -(-n_rows // TILE_R))


def _n_col_tiles(n_cols: int) -> int:
    return max(1, -(-n_cols // TILE_C))


def blocked_ld(n_ct: int) -> int:
    """Floats per row of the blocked kernel's fwd partials: n_ct rounded
    up to 4, so that every row starts 16-byte aligned."""
    return -(-n_ct // 4) * 4


def blocked_rows_per_block(n_rt: int, n_ct: int) -> int:
    """Row tiles one block of K8's kernel walks: all of them where the
    partition has BLOCKED_TARGET_BLOCKS column tiles or more, else groups
    of fewer, so that about that many blocks share the work."""
    groups = min(n_rt, max(1, -(-BLOCKED_TARGET_BLOCKS // n_ct)))
    return -(-n_rt // groups)


def _scratch(v: int, k: int, blocked: bool, dev, windows: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(partials, counters) of one partition, zeroed (PatternPart.part /
    .counters), ``windows`` windows' back to back (K8: each window's
    fwd partials then bwd partials, csrc ``blocked_scratch``)."""
    n_rt, n_ct = _n_row_tiles(v), _n_col_tiles(k)
    if blocked:
        groups = -(-n_rt // blocked_rows_per_block(n_rt, n_ct))
        n_part = (n_rt * TILE_R * blocked_ld(n_ct) if n_ct > 1 else 0) + (
            n_rt * n_ct * TILE_C if groups > 1 else 0)
        n_count = 0
    else:
        n_part, n_count = n_rt * n_ct * (TILE_R + TILE_C), n_rt + n_ct
    return (torch.zeros(max(windows * n_part, 1), dtype=torch.float32, device=dev),
            torch.zeros(windows * n_count, dtype=torch.int32, device=dev))


def pattern_group(
    patterns: Sequence[torch.Tensor],
    w_lens: Sequence[torch.Tensor],
    w_covs: Sequence[torch.Tensor],
    w_outs: Sequence[Optional[torch.Tensor]],
    n_cols: Sequence[int],
    band_bytes: Optional[int] = None,
    blocked: bool = False,
) -> PatternGroup:
    """The per-window half of the pair for 1 or 2 partitions on one
    device: checks shapes and types once, copies every bitmap (uint8,
    ``np.packbits`` order along rows) into the kernel's row layout,
    allocates the scratch, and on the CPU builds the plain version's 0/1
    matrices — unless ``band_bytes`` is given and a partition's unpacked
    f32 matrix would exceed it: its plain version then works in bands of
    whole column tiles within ``band_bytes``. ``blocked`` (packed_blocked):
    the group launches K8's kernel, with its own scratch.

    Stacked windows: 3-d patterns [B, V, C] with [B, .] weight vectors
    (one B for all parts) make a group of B windows (``windows``), with
    or without ``blocked``; ``band_bytes`` then bounds each window's band
    (the caller divides the budget by B, as JAX's ``divide_block_budget``,
    so that a band of all B windows stays within it)."""
    if not 1 <= len(patterns) <= 2:
        raise ValueError("pattern_group: 1 or 2 partitions")
    dev = patterns[0].device
    windows = patterns[0].shape[0] if patterns[0].dim() == 3 else None
    lead = () if windows is None else (windows,)
    parts = []
    for pat, w_len, w_cov, w_out, k in zip(patterns, w_lens, w_covs, w_outs, n_cols):
        k = int(k)
        v = pat.shape[-2] if pat.dim() >= 2 else 0
        if pat.dtype != torch.uint8 or pat.dim() != 2 + len(lead) or pat.shape[:-2] != lead:
            raise TypeError("pattern_group: patterns must be 2-d uint8 bitmaps (3-d when stacked)")
        if pat.shape[-1] < -(-k // 8):
            raise ValueError(f"pattern_group: a pattern row holds fewer than {k} columns")
        if w_len.shape != lead + (k,) or w_cov.shape != lead + (v,) or (
            w_out is not None and w_out.shape != lead + (v,)
        ):
            raise ValueError("pattern_group: weight vectors must match the pattern")
        vecs = [w_len, w_cov] + ([] if w_out is None else [w_out])
        if any(t.dtype != torch.float32 for t in vecs):
            raise TypeError("pattern_group: weight vectors must be float32")
        if any(t.device != dev for t in [pat, *vecs]):
            raise ValueError("pattern_group: every tensor must lie on one device")
        pat = _bitmap_rows(pat, k)
        n_rt, n_ct = _n_row_tiles(v), _n_col_tiles(k)
        part, counters = _scratch(v, k, blocked, dev, windows or 1)
        band = 0
        if band_bytes is not None and 4 * v * k > band_bytes:
            band = max(1, band_bytes // (4 * max(v, 1) * TILE_C)) * TILE_C
        parts.append(PatternPart(
            pattern=pat,
            w_len=w_len.contiguous(),
            w_cov=w_cov.contiguous(),
            w_out=None if w_out is None else w_out.contiguous(),
            part=part,
            counters=counters,
            dense=unpack_bits(pat, k) if dev.type == "cpu" and not band else None,
            n_cols=k,
            band_cols=band,
            rows_per_block=blocked_rows_per_block(n_rt, n_ct) if blocked else 0,
        ))
    return PatternGroup(
        parts=tuple(parts),
        amax_scratch=torch.zeros(MAX_VECS * (windows or 1) + 1, dtype=torch.int32, device=dev),
        blocked=blocked,
        windows=windows,
    )


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """x with every subnormal value (|x| < FLT_MIN) replaced by +0, as
    XLA's CPU flushes them where JAX's ``quantize_i8`` runs; NaN stays
    NaN. The kernels flush by the same compare (``flush_subnormal`` in
    ``csrc/pattern_pair.cu`` and ``csrc/power_step.cu``)."""
    return torch.where(x.abs() < FLT_MIN, 0.0, x)


def quantize_scale(x: torch.Tensor) -> torch.Tensor:
    """JAX's ``quantize_i8`` scale of one vector: max|x| / 127 over x
    with its subnormals flushed, that quotient flushed to 0 when it is
    subnormal (as XLA's CPU flushes it), or 1 when the max is not above
    0 (all zeros or subnormals, or NaN), float32 0-d; of each row of a
    stacked group's [B, n] vectors, [B] (``quantize_i8`` under vmap).
    The divisor is a tensor of x's device, so every device divides."""
    zero = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    amax = flush_subnormal(x).abs().amax(-1) if x.shape[-1] else zero
    return torch.where(
        amax > 0, flush_subnormal(amax / torch.full_like(zero, 127.0)), zero + 1.0
    )


def quantize_with(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clip(round(x / scale), -127, 127) as int32 over x with its
    subnormals flushed (round half to even, as jnp.round and the
    kernel's rintf); ``scale`` 0-d, or [B] for [B, n] vectors. A 0
    operand is 0 on every scale: on a flushed scale of 0, where every
    other operand goes to +-127, XLA's int8 cast turns its 0 / 0 into 0
    too."""
    f = flush_subnormal(x)
    q = torch.clamp(torch.round(f / scale[..., None]), -127.0, 127.0)
    return torch.where(f == 0, 0.0, q).to(torch.int32)


def quantize_i8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The port of ``jax_tpu.quantize_i8``: (q int8, scale float32 0-d)."""
    scale = quantize_scale(x)
    return quantize_with(x, scale).to(torch.int8), scale


def quantize_scales_plain(
    group: PatternGroup, rvs: Sequence[torch.Tensor], svs: Sequence[torch.Tensor]
) -> torch.Tensor:
    """The scales of a step's int8 operands, float32 [2 * n_parts]: per
    partition the fwd operand rv * w_len's, then the bwd operand
    sv * w_cov's; [B, 2 * n_parts] for a stacked group, each window's
    from its own vectors."""
    _check_vectors(group, rvs, svs)
    return torch.stack([
        quantize_scale(x)
        for p, rv, sv in zip(group.parts, rvs, svs)
        for x in (rv * p.w_len, sv * p.w_cov)
    ], -1)


def quantize_scales(
    group: PatternGroup, rvs: Sequence[torch.Tensor], svs: Sequence[torch.Tensor]
) -> torch.Tensor:
    """``quantize_scales_plain``'s result: CPU tensors run it; CUDA
    tensors launch ``quantize_amax`` once (both partitions, both
    directions, every window of a stacked group) or raise."""
    dev = rvs[0].device
    if dev.type == "cpu":
        return quantize_scales_plain(group, rvs, svs)
    _check_cuda(group, rvs, svs, dev)
    ptrs, ns = [], []
    for p, rv, sv in zip(group.parts, rvs, svs):
        ptrs += [rv.data_ptr(), p.w_len.data_ptr(), sv.data_ptr(), p.w_cov.data_ptr()]
        ns += [p.n_cols, p.pattern.shape[-2]]
    lead = () if group.windows is None else (group.windows,)
    scales = torch.empty(lead + (len(ns),), dtype=torch.float32, device=dev)
    lib = load_library()
    rc = lib.mr_quantize_amax(
        (ctypes.c_void_p * len(ptrs))(*ptrs),
        (ctypes.c_int64 * len(ns))(*ns),
        len(ns), group.windows or 1, scales.data_ptr(), group.amax_scratch.data_ptr(),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"quantize_amax launch failed: {lib.mr_pattern_error_string(rc).decode()}"
        )
    quantize_scales.launches += 1
    return scales


# Launches of quantize_amax (a plain int; quantize_scales is the one
# place that launches it).
quantize_scales.launches = 0


def _op(x: torch.Tensor, precision: str) -> torch.Tensor:
    # torch's float32 -> bfloat16 conversion rounds to nearest even.
    return x.to(torch.bfloat16).to(torch.float32) if precision == "bf16" else x


def fwd_tile_sums(m: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """float32[..., V, n_ct]: each row's sum over each column tile of
    TILE_C in the kernels' order: lane l sums columns LANE_COLS * l .. in
    order and the shuffle tree 16, 8, 4, 2, 1 sums the lanes. Zero cells
    add +0.0, which the kernels select or skip instead: the same bits.
    Leading axes (stacked windows) pair m [..., V, K] with a [..., K]."""
    *lead, v, k = m.shape
    n_ct = _n_col_tiles(k)
    prod = torch.zeros((*lead, v, n_ct * TILE_C), dtype=torch.float32, device=m.device)
    prod[..., :k] = m * a.unsqueeze(-2)
    prod = prod.view(*lead, v, n_ct, WARP, LANE_COLS)
    lanes = torch.zeros((*lead, v, n_ct, WARP), dtype=torch.float32, device=m.device)
    for j in range(LANE_COLS):
        lanes = lanes + prod[..., j]
    off = WARP // 2
    while off:
        lanes = lanes[..., :off] + lanes[..., off: 2 * off]
        off //= 2
    return lanes[..., 0]


def fwd_plain(
    m: torch.Tensor, a: torch.Tensor, y: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """y[r] = sum_c m[r, c] * a[c] in the kernel's order: the column
    tiles' sums (``fwd_tile_sums``) fold left to right. ``y``: the fold
    of the column tiles left of ``m``, when ``m`` is a band of whole
    tiles of a wider matrix."""
    tiles = fwd_tile_sums(m, a)
    if y is None:
        y = torch.zeros(m.shape[:-1], dtype=torch.float32, device=m.device)
    for j in range(tiles.shape[-1]):
        y = y + tiles[..., j]
    return y


def bwd_plain(m: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y[c] = sum_r b[r] * m[r, c] in the kernel's order: rows in order
    inside each row tile of TILE_R, then the row tiles' sums folded top
    to bottom. Leading axes as ``fwd_tile_sums``'s."""
    *lead, v, k = m.shape
    n_rt = _n_row_tiles(v)
    prod = torch.zeros((*lead, n_rt * TILE_R, k), dtype=torch.float32, device=m.device)
    prod[..., :v, :] = b.unsqueeze(-1) * m
    prod = prod.view(*lead, n_rt, TILE_R, k)
    acc = torch.zeros((*lead, n_rt, k), dtype=torch.float32, device=m.device)
    for i in range(TILE_R):
        acc = acc + prod[..., i, :]
    y = torch.zeros((*lead, k), dtype=torch.float32, device=m.device)
    for j in range(n_rt):
        y = y + acc[..., j, :]
    return y


def pattern_pair_plain(
    group: PatternGroup,
    rvs: Sequence[torch.Tensor],
    svs: Sequence[torch.Tensor],
    precision: str = "f32",
    scales: Optional[torch.Tensor] = None,
) -> Tuple[Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]], ...]:
    """The kernel's arithmetic in plain PyTorch: per partition (y_fwd,
    y_bwd, x_ss or None). int8 takes the step's ``scales``
    (``quantize_scales``; [B, 4] for a stacked group)."""
    _check_vectors(group, rvs, svs)
    _check_precision(group, precision, scales)
    out = []
    for i, (p, rv, sv) in enumerate(zip(group.parts, rvs, svs)):
        if precision == "int8":
            m = (p.dense if p.dense is not None else unpack_bits(p.pattern, p.n_cols)).to(torch.int32)
            sc, sr = scales[..., 2 * i], scales[..., 2 * i + 1]
            qa, qb = quantize_with(rv * p.w_len, sc), quantize_with(sv * p.w_cov, sr)
            y_fwd = sc[..., None] * (m * qa.unsqueeze(-2)).sum(-1, dtype=torch.int32).to(
                torch.float32)
            y_bwd = sr[..., None] * (qb.unsqueeze(-1) * m).sum(-2, dtype=torch.int32).to(
                torch.float32)
            out.append((y_fwd, y_bwd, None))
            continue
        a, b = _op(rv * p.w_len, precision), _op(sv * p.w_cov, precision)
        if p.band_cols:
            y_fwd, y_bwd = _pair_in_bands(p, a, b)
        else:
            m = p.dense if p.dense is not None else unpack_bits(p.pattern, p.n_cols)
            y_fwd, y_bwd = fwd_plain(m, a), bwd_plain(m, b)
        x_ss = None if p.w_out is None else _op(sv * p.w_out, precision)
        out.append((y_fwd, y_bwd, x_ss))
    return tuple(out)


def blocked_partials_plain(
    group: PatternGroup, rvs: Sequence[torch.Tensor]
) -> Tuple[Optional[torch.Tensor], ...]:
    """Per partition, the fwd partials as K8's kernel leaves them in
    ``PatternPart.part`` after a launch: float32[n_rt * TILE_R,
    blocked_ld(n_ct)], row r's tile sums (``fwd_tile_sums``) in columns
    0 .. n_ct - 1, zeros elsewhere (rows past V, the padding columns);
    None for a partition of one column tile (its rows are written
    directly). Bands of whole column tiles where the part has them."""
    if len(rvs) != len(group.parts) or any(
        rv.shape != (p.n_cols,) for p, rv in zip(group.parts, rvs)
    ):
        raise ValueError("blocked_partials_plain: one rv of n_cols floats per partition")
    out = []
    for p, rv in zip(group.parts, rvs):
        v, n_ct = p.pattern.shape[0], _n_col_tiles(p.n_cols)
        if n_ct == 1:
            out.append(None)
            continue
        a = rv * p.w_len
        band = p.band_cols or n_ct * TILE_C
        tiles = []
        for c0 in range(0, p.n_cols, band):
            k = min(band, p.n_cols - c0)
            m = unpack_bits(p.pattern[:, c0 // 8: c0 // 8 + -(-k // 8)], k)
            tiles.append(fwd_tile_sums(m, a[c0: c0 + k]))
        sums = torch.zeros((_n_row_tiles(v) * TILE_R, blocked_ld(n_ct)),
                           dtype=torch.float32, device=rv.device)
        sums[:v, :n_ct] = torch.cat(tiles, dim=1)
        out.append(sums)
    return tuple(out)


def _pair_in_bands(p: PatternPart, a: torch.Tensor, b: torch.Tensor):
    """The plain pair of one partition, unpacking ``p.band_cols`` columns
    (whole TILE_C tiles) at a time, of every window of a stacked group
    at once: the fwd fold carries from band to band, each band gives its
    own columns' y_bwd."""
    y_fwd = torch.zeros(p.pattern.shape[:-1], dtype=torch.float32, device=a.device)
    y_bwd = []
    for c0 in range(0, p.n_cols, p.band_cols):
        k = min(p.band_cols, p.n_cols - c0)
        m = unpack_bits(p.pattern[..., c0 // 8: c0 // 8 + -(-k // 8)], k)
        y_fwd = fwd_plain(m, a[..., c0: c0 + k], y_fwd)
        y_bwd.append(bwd_plain(m, b))
    return y_fwd, torch.cat(y_bwd, -1)


def _check_vectors(group: PatternGroup, rvs, svs) -> None:
    if not len(rvs) == len(svs) == len(group.parts):
        raise ValueError("pattern_pair: one rv and one sv per partition")
    lead = () if group.windows is None else (group.windows,)
    for p, rv, sv in zip(group.parts, rvs, svs):
        if rv.shape != lead + (p.n_cols,) or sv.shape != lead + (p.pattern.shape[-2],):
            raise ValueError(
                f"pattern_pair: rv must hold {p.n_cols} and sv "
                f"{p.pattern.shape[-2]} floats" + (f" in each of {lead[0]} windows" if lead else "")
            )


def _check_precision(group: PatternGroup, precision: str, scales) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"pattern_pair: unknown precision {precision!r} (expected {PRECISIONS})")
    if precision != "int8":
        return
    # JAX quantizes only the kind pattern's operands: no x_ss, no bands.
    if any(p.w_out is not None or p.band_cols for p in group.parts):
        raise ValueError("pattern_pair: int8 runs the kind pattern only (no w_out, no bands)")
    lead = () if group.windows is None else (group.windows,)
    if scales is None or scales.shape != lead + (2 * len(group.parts),) or (
        scales.dtype != torch.float32
    ):
        raise ValueError("pattern_pair: int8 needs the step's float32 scales (quantize_scales)")


def _check_cuda(group: PatternGroup, rvs, svs, dev) -> None:
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


def pattern_pair_group(
    group: PatternGroup,
    rvs: Sequence[torch.Tensor],
    svs: Sequence[torch.Tensor],
    precision: str = "f32",
    scales: Optional[torch.Tensor] = None,
) -> Tuple[Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]], ...]:
    """Per partition (y_fwd, y_bwd, x_ss or None), as views of one flat
    output. CPU tensors run the plain version; CUDA tensors launch the
    kernel once or raise — there is no fallback for a CUDA tensor: the
    tile kernel, or K8's blocked kernel (f32 only) for a ``blocked``
    group. int8 takes the step's ``scales`` from ``quantize_scales``. A
    group is used by one stream at a time (its scratch is shared). A
    stacked group (``windows``) takes [B, .] vectors and gives [B, .]
    outputs, every window in the same launch."""
    # Checks kept cheap: this runs once per power-iteration step.
    dev = rvs[0].device
    if group.blocked and precision != "f32":
        raise ValueError(f"pattern_pair: a blocked group runs f32 only, not {precision!r}")
    if dev.type == "cpu":
        return pattern_pair_plain(group, rvs, svs, precision, scales)
    _check_cuda(group, rvs, svs, dev)
    _check_precision(group, precision, scales)
    if scales is not None and (scales.device != dev or not scales.is_contiguous()):
        raise ValueError(f"pattern_pair: the scales must be contiguous on {dev}")
    n_win = group.windows or 1
    sizes = []
    for p in group.parts:
        v = p.pattern.shape[-2]
        sizes += [v, p.n_cols, 0 if p.w_out is None else v]
    flat = torch.empty(n_win * sum(sizes), dtype=torch.float32, device=dev)
    outs = flat.split_with_sizes([n_win * n for n in sizes])
    if group.windows is not None:
        outs = [t.view(n_win, -1) for t in outs]
    ptrs, ints = [], []
    for i, (p, rv, sv) in enumerate(zip(group.parts, rvs, svs)):
        y_fwd, y_bwd, x_ss = outs[3 * i: 3 * i + 3]
        ptrs += [
            p.pattern.data_ptr(), rv.data_ptr(), p.w_len.data_ptr(),
            sv.data_ptr(), p.w_cov.data_ptr(),
            None if p.w_out is None else p.w_out.data_ptr(),
            None if scales is None else scales.view(-1)[2 * i:].data_ptr(),
            y_fwd.data_ptr(), y_bwd.data_ptr(),
            None if p.w_out is None else x_ss.data_ptr(),
            p.part.data_ptr(), p.counters.data_ptr(),
        ]
        ints += [p.pattern.shape[-1], p.pattern.shape[-2], p.n_cols]
        if group.blocked:
            ints.append(p.rows_per_block)
    lib = load_library()
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_ints = (ctypes.c_int64 * len(ints))(*ints)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if group.blocked:
        rc = lib.mr_pattern_pair_blocked(c_ptrs, c_ints, len(group.parts), n_win, index, stream)
    else:
        rc = lib.mr_pattern_pair(c_ptrs, c_ints, len(group.parts),
                                 PRECISIONS.index(precision), n_win, index, stream)
    if rc != 0:
        raise RuntimeError(
            f"pattern_pair launch failed: {lib.mr_pattern_error_string(rc).decode()}"
        )
    pattern_pair_group.launches += 1
    if group.blocked:
        pattern_pair_group.blocked_launches += 1
        pattern_pair_group.fold_launches += blocked_folds(group)
    pattern_pair_group.products += 2 * len(group.parts) * n_win
    return tuple(
        (outs[3 * i], outs[3 * i + 1], outs[3 * i + 2] if p.w_out is not None else None)
        for i, p in enumerate(group.parts)
    )


def blocked_part_folds(n_rows: int, n_cols: int) -> bool:
    """Whether K8 folds partials of a partition of ``n_rows`` x
    ``n_cols``: more than one column tile (fwd partials), or its row
    tiles walked in more than one group (bwd partials). A small bitmap
    has neither."""
    n_rt, n_ct = _n_row_tiles(n_rows), _n_col_tiles(n_cols)
    return n_ct > 1 or blocked_rows_per_block(n_rt, n_ct) < n_rt


def blocked_folds(group: PatternGroup) -> bool:
    """Whether K8's launch over ``group`` is followed by its fold launch
    (``mr_pattern_pair_blocked``): when any partition folds
    (``blocked_part_folds``)."""
    return group.blocked and any(
        blocked_part_folds(p.pattern.shape[-2], p.n_cols) for p in group.parts
    )


# Counts of the pair's calls (one launch of the tile kernel or of K8's
# blocked kernel each), of K8's blocked kernel's launches and of its fold
# launches (one after it where a partition has more than one column
# tile or group of row tiles), and of the matvecs computed (two per
# partition and window; plain ints, pattern_pair_group is the one place
# that launches).
pattern_pair_group.launches = 0
pattern_pair_group.blocked_launches = 0
pattern_pair_group.fold_launches = 0
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
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,       # n_parts, precision, n_windows
        ctypes.c_int, ptr,                                    # device, stream
    ]
    lib.mr_pattern_pair_blocked.restype = ctypes.c_int
    lib.mr_pattern_pair_blocked.argtypes = [
        ctypes.POINTER(ptr), ctypes.POINTER(ctypes.c_int64),  # ptrs, ints
        ctypes.c_int32, ctypes.c_int32,                       # n_parts, n_windows
        ctypes.c_int, ptr,                                    # device, stream
    ]
    lib.mr_quantize_amax.restype = ctypes.c_int
    lib.mr_quantize_amax.argtypes = [
        ctypes.POINTER(ptr), ctypes.POINTER(ctypes.c_int64),  # ptrs, lengths
        ctypes.c_int32, ctypes.c_int32, ptr, ptr,             # n_vecs, n_windows, scales, scratch
        ctypes.c_int, ptr,                                    # device, stream
    ]
    lib.mr_pattern_error_string.restype = ctypes.c_char_p
    lib.mr_pattern_error_string.argtypes = [ctypes.c_int]
    return lib


__all__ = [
    "PRECISIONS",
    "ROW_ALIGN",
    "TILE_C",
    "TILE_R",
    "PatternGroup",
    "PatternPart",
    "blocked_folds",
    "blocked_ld",
    "blocked_part_folds",
    "blocked_rows_per_block",
    "blocked_partials_plain",
    "bwd_plain",
    "flush_subnormal",
    "fwd_plain",
    "fwd_tile_sums",
    "pattern_group",
    "pattern_pair_group",
    "pattern_pair_plain",
    "quantize_i8",
    "quantize_scales",
    "quantize_scales_plain",
    "unpack_bits",
]
