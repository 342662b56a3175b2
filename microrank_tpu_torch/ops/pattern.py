"""K2 / K4: the coverage matvec pair of the kind and packed power
iterations, as a hand-written CUDA kernel (``csrc/pattern_pair.cu``)
with its plain PyTorch version beside it.

It replaces two device programs that XLA wrote for the TPU in
``microrank_tpu/rank_backends/jax_tpu.py`` ``_partition_setup``: the
kind branch's ``cov_pair`` (K2: an int8 0/1 pattern [V, K]) and the
packed branch's coverage pair (K4: a big-endian bitmap [V, ceil(T/8)],
``np.packbits`` order). Per partition, with op the identity or
round-to-nearest-even to bf16 of the f32 product:

    y_fwd[r] = sum_c M[r, c] * op(rv[c] * w_len[c])
    y_bwd[c] = sum_r op(sv[r] * w_cov[r]) * M[r, c]
    x_ss[r]  = op(sv[r] * w_out[r])      (packed only: K1's call-graph operand)

Two steps:

* ``pattern_group`` — once per window: each partition's pattern and
  loop-invariant weight vectors, with the kernel's scratch (chunk sums
  and arrival counters) and, on the CPU, the plain version's 0/1 f32
  matrices.
* ``pattern_pair_group`` — every step: on CUDA tensors one launch
  computes both directions of every partition (counted in
  ``pattern_pair_group.launches``, the matvecs in ``.products``) or
  raises; on CPU tensors it runs ``pattern_pair_plain``, which repeats
  the kernel's arithmetic in the kernel's order, so both give the same
  bits.

The order of each sum: y_fwd[r] adds, in each tile of ``TILE`` columns,
the set columns lane by lane (lane l owns the tile's group l of 8
columns, ascending), then the shuffle tree 16, 8, 4, 2, 1; tile j's sum
goes to slot j % ``SLOTS``, each slot sums its tiles in order, and the
slots fold in order. y_bwd[c] adds rows in ascending order inside
chunks of ``ROW_CHUNK`` rows, then folds the chunks left to right. Both depend on the index alone, so equal rows and equal columns
give bitwise-equal sums. What bounds the kernel on the card is in the
note at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..utils.build import BUILD_DIR, is_stale, run_build, tmp_output
from .spmv import nvcc

WARP = 32
GROUP = 8  # columns per group: one bitmap byte (csrc kGroup)
# Rows per bwd chunk (csrc kRowChunk). Chunk boundaries fix the order of
# every column sum: the plain version and the kernel must agree on it.
ROW_CHUNK = 64
# Columns per fwd tile (one group per lane: kWarp groups in csrc), and
# the slots (csrc: warps of a block) tile j is summed in: j % SLOTS. Both
# fix the order of every row sum, as ROW_CHUNK does for the columns.
TILE = WARP * GROUP
SLOTS = 8
SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "pattern_pair.cu"
LIB_PATH = BUILD_DIR / "libmr_pattern_pair.so"
_lib: Optional[ctypes.CDLL] = None


class PatternPart(NamedTuple):
    """One partition's pattern and its loop-invariant vectors."""

    pattern: torch.Tensor          # uint8[V, >= ceil(n_cols/8)] bits, or int8[V, 8 * ceil(n_cols/8)]
    w_len: torch.Tensor            # float32[n_cols]
    w_cov: torch.Tensor            # float32[V]
    w_out: Optional[torch.Tensor]  # float32[V]: x_ss is computed when given
    part: torch.Tensor             # float32[n_chunks * n_groups * 8] bwd chunk sums
    counters: torch.Tensor         # int32[n_groups] arrivals, 0 between launches
    dense: Optional[torch.Tensor]  # float32[V, n_cols] 0/1, the plain version's (CPU)
    n_cols: int


class PatternGroup(NamedTuple):
    """The partitions one launch computes; ``bits``: the patterns are
    big-endian bitmaps (K4), else int8 bytes (K2)."""

    parts: Tuple[PatternPart, ...]
    bits: bool


def unpack_bits(bits: torch.Tensor, n_cols: int, dtype=torch.float32) -> torch.Tensor:
    """uint8[V, C] -> dtype[V, n_cols]: the inverse of ``np.packbits(...,
    axis=1)`` (big-endian bit order), as ``jax_tpu.unpack_bits``. A plain
    helper for the plain version, the tests and chip_smoke's yardstick;
    the kernel never builds this matrix."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=bits.device)
    b = (bits[:, :, None] >> shifts) & 1
    return b.reshape(bits.shape[0], bits.shape[1] * 8)[:, :n_cols].to(dtype)


def dense_pattern(pattern: torch.Tensor, n_cols: int, bits: bool) -> torch.Tensor:
    """The 0/1 float32 [V, n_cols] matrix of a pattern."""
    if bits:
        return unpack_bits(pattern, n_cols)
    return (pattern[:, :n_cols] != 0).to(torch.float32)


def _n_chunks(n_rows: int) -> int:
    return max(1, -(-n_rows // ROW_CHUNK))


def _n_tiles(n_cols: int) -> int:
    return max(1, -(-n_cols // TILE))


def pattern_group(
    patterns: Sequence[torch.Tensor],
    w_lens: Sequence[torch.Tensor],
    w_covs: Sequence[torch.Tensor],
    w_outs: Sequence[Optional[torch.Tensor]],
    n_cols: Sequence[int],
    bits: bool,
) -> PatternGroup:
    """The per-window half of the pair for 1 or 2 partitions on one
    device: checks shapes and types once, allocates the scratch, and on
    the CPU builds the plain version's 0/1 matrices."""
    if not 1 <= len(patterns) <= 2:
        raise ValueError("pattern_group: 1 or 2 partitions")
    want = torch.uint8 if bits else torch.int8
    dev = patterns[0].device
    parts = []
    for pat, w_len, w_cov, w_out, k in zip(patterns, w_lens, w_covs, w_outs, n_cols):
        k = int(k)
        v = pat.shape[0]
        n_groups = -(-k // GROUP)
        if pat.dtype != want or pat.dim() != 2:
            raise TypeError(f"pattern_group: patterns must be 2-d {want}")
        if pat.shape[1] < (n_groups if bits else k):
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
        pat = pat.contiguous()
        if not bits and (pat.shape[1] % GROUP or pat.data_ptr() % GROUP):
            # The kernel reads an int8 group with one 8-byte load: pad the
            # rows to whole groups (zeros, past n_cols) in a fresh tensor.
            padded = torch.zeros((v, n_groups * GROUP), dtype=pat.dtype, device=dev)
            padded[:, :k] = pat[:, :k]
            pat = padded
        parts.append(PatternPart(
            pattern=pat,
            w_len=w_len.contiguous(),
            w_cov=w_cov.contiguous(),
            w_out=None if w_out is None else w_out.contiguous(),
            part=torch.zeros(_n_chunks(v) * n_groups * GROUP,
                             dtype=torch.float32, device=dev),
            counters=torch.zeros(n_groups, dtype=torch.int32, device=dev),
            dense=dense_pattern(pat, k, bits) if dev.type == "cpu" else None,
            n_cols=k,
        ))
    return PatternGroup(parts=tuple(parts), bits=bool(bits))


def _op(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    # torch's float32 -> bfloat16 conversion rounds to nearest even.
    return x.to(torch.bfloat16).to(torch.float32) if bf16 else x


def fwd_plain(m: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """y[r] = sum_c m[r, c] * a[c] in the kernel's order: in each tile of
    TILE columns, lane l sums its group's 8 columns in order and the
    shuffle tree sums the lanes; tile j joins slot j % SLOTS, whose sum
    runs over its tiles in order; then the slots fold in order. Zero
    cells add +0.0, which the kernel skips: the same bits."""
    v, k = m.shape
    rounds = max(1, -(-_n_tiles(k) // SLOTS))
    prod = torch.zeros((v, rounds * SLOTS * TILE), dtype=torch.float32, device=m.device)
    prod[:, :k] = m * a
    prod = prod.view(v, rounds, SLOTS, WARP, GROUP)
    lanes = torch.zeros((v, rounds, SLOTS, WARP), dtype=torch.float32, device=m.device)
    for j in range(GROUP):
        lanes = lanes + prod[..., j]
    off = WARP // 2
    while off:
        lanes = lanes[..., :off] + lanes[..., off: 2 * off]
        off //= 2
    slots = torch.zeros((v, SLOTS), dtype=torch.float32, device=m.device)
    for i in range(rounds):
        slots = slots + lanes[:, i, :, 0]
    y = torch.zeros(v, dtype=torch.float32, device=m.device)
    for j in range(SLOTS):
        y = y + slots[:, j]
    return y


def bwd_plain(m: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y[c] = sum_r b[r] * m[r, c] in the kernel's order: rows in order
    inside chunks of ROW_CHUNK, then the chunks folded left to right."""
    v, k = m.shape
    n_chunks = _n_chunks(v)
    prod = torch.zeros((n_chunks * ROW_CHUNK, k), dtype=torch.float32, device=m.device)
    prod[:v] = b[:, None] * m
    prod = prod.view(n_chunks, ROW_CHUNK, k)
    acc = torch.zeros((n_chunks, k), dtype=torch.float32, device=m.device)
    for i in range(ROW_CHUNK):
        acc = acc + prod[:, i]
    y = torch.zeros(k, dtype=torch.float32, device=m.device)
    for j in range(n_chunks):
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
        m = p.dense if p.dense is not None else dense_pattern(p.pattern, p.n_cols, group.bits)
        y_fwd = fwd_plain(m, _op(rv * p.w_len, bf16))
        y_bwd = bwd_plain(m, _op(sv * p.w_cov, bf16))
        x_ss = None if p.w_out is None else _op(sv * p.w_out, bf16)
        out.append((y_fwd, y_bwd, x_ss))
    return tuple(out)


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
        ints += [p.pattern.stride(0), p.pattern.shape[0], p.n_cols]
    lib = load_library()
    rc = lib.mr_pattern_pair(
        (ctypes.c_void_p * len(ptrs))(*ptrs),
        (ctypes.c_int64 * len(ints))(*ints),
        len(group.parts), int(group.bits), int(bool(bf16)),
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
    if _lib is not None:
        return _lib
    build_library()
    lib = ctypes.CDLL(str(LIB_PATH))
    ptr = ctypes.c_void_p
    lib.mr_pattern_pair.restype = ctypes.c_int
    lib.mr_pattern_pair.argtypes = [
        ctypes.POINTER(ptr), ctypes.POINTER(ctypes.c_int64),  # ptrs, ints
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,       # n_parts, bits, bf16
        ctypes.c_int, ptr,                                    # device, stream
    ]
    lib.mr_pattern_error_string.restype = ctypes.c_char_p
    lib.mr_pattern_error_string.argtypes = [ctypes.c_int]
    _lib = lib
    return lib


__all__ = [
    "GROUP",
    "ROW_CHUNK",
    "PatternGroup",
    "PatternPart",
    "bwd_plain",
    "dense_pattern",
    "fwd_plain",
    "pattern_group",
    "pattern_pair_group",
    "pattern_pair_plain",
    "unpack_bits",
]
