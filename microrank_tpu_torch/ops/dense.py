"""K12: the dense kernel family's products ("dense", "dense_bf16"), as a
hand-written CUDA kernel (``csrc/dense_mv.cu``) with its plain PyTorch
version beside it.

It replaces what XLA compiles for the TPU in
``microrank_tpu/rank_backends/jax_tpu.py:361-403``: the transition
matrices densified once (``densify`` :262), then every step
``p_sr @ rv + alpha * p_ss @ sv`` and ``p_rs @ sv`` per partition by
``jnp.dot``; ``dense_bf16`` stores the matrices in bf16, rounds each
step's vector to bf16 and accumulates in f32.

* ``densify`` — once a window, tensor ops (the window's layout work, as
  ``device_subset``'s other layouts): zeros, then the COO entries added
  in (``index_put_(..., accumulate=True)``, as JAX's ``.at[].add``). The
  padding entries carry value 0 at index (0, 0), so adding them leaves a
  real entry there as it is, where an overwrite would erase it. Each
  row's stride is padded with zero columns to a multiple of 32 lanes x
  one 16-byte load (``row_multiple``).
* ``dense_group`` — both partitions' six matrices (p_sr, p_ss, p_rs of
  each; f32, or bf16 cast from the f32 ones as JAX casts), with the x
  slot each reads (``STEP_X_SLOTS`` of ``rank_backends.torch_cuda``).
  A stacked group's matrices are [B, rows, ld], each window's its own.
* ``dense_matvecs`` — every step: on CUDA tensors one launch for the six
  products of every window (counted in ``dense_matvecs.launches``) or
  it raises; on CPU tensors ``dense_matvecs_plain``, which repeats the
  kernel's order of sums (each lane's ``kVec`` running sums over its
  columns, left to right; the lane's sums; K1's shuffle tree), so both
  give the same bits and equal rows give equal sums.

What bounds the kernel on the card, and what it does about it, is in
the note at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..graph.structures import PartitionGraph, WindowGraph
from ..utils.build import BUILD_DIR, is_stale, run_build, tmp_output
from .spmv import WARP, nvcc

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "dense_mv.cu"
LIB_PATH = BUILD_DIR / "libmr_dense_mv.so"
MAX_MATS = 6  # matrices a launch (csrc/dense_mv.cu kMaxMats)
MAX_X = 4     # x slots a launch (kMaxX)
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def vec_width(bf16: bool) -> int:
    """Columns of one 16-byte load: 4 f32 or 8 bf16."""
    return 8 if bf16 else 4


def row_multiple(bf16: bool) -> int:
    """A matrix row's stride is a multiple of this many columns: one
    16-byte load for each of a warp's 32 lanes."""
    return WARP * vec_width(bf16)


def _round_up(n: int, multiple: int) -> int:
    return -(-int(n) // multiple) * multiple


def densify(g: PartitionGraph, multiple: int = 1):
    """The partition's dense transition matrices (JAX's ``densify``):
    (p_ss [V, V], p_sr [V, T], p_rs [T, V]), float32, each row's stride
    padded with zero columns to a multiple of ``multiple``. A stacked
    group's partition ([B, E] entries) gives [B, rows, ld] matrices."""
    v, t = int(g.cov_unique.shape[-1]), int(g.kind.shape[-1])
    lead = tuple(g.kind.shape[:-1])
    dev = g.kind.device

    def scatter(rows, cols, vals, n_rows, n_cols):
        out = torch.zeros(lead + (n_rows, _round_up(n_cols, multiple)),
                          dtype=torch.float32, device=dev)
        index = (rows.to(torch.int64), cols.to(torch.int64))
        if lead:
            win = torch.arange(lead[0], device=dev)[:, None].expand(rows.shape)
            index = (win,) + index
        # Added, not written: the padding entries (value 0) all land on
        # (0, 0), which may also hold a real entry.
        return out.index_put_(index, vals, accumulate=True)

    return (
        scatter(g.ss_child, g.ss_parent, g.ss_val, v, v),
        scatter(g.inc_op, g.inc_trace, g.sr_val, v, t),
        scatter(g.inc_trace, g.inc_op, g.rs_val, t, v),
    )


class DenseGroup(NamedTuple):
    """One step's six products as one launch reads them."""

    mats: Tuple[torch.Tensor, ...]  # [(B,) rows, ld], f32 or bf16, contiguous
    x_slots: Tuple[int, ...]        # the x each matrix reads
    n_cols: Tuple[int, ...]         # each matrix's columns (its x's length)
    bf16: bool
    windows: Optional[int] = None   # B for a stacked group, None for one window


def dense_group(graph: WindowGraph, bf16: bool, x_slots: Sequence[int]) -> DenseGroup:
    """Both partitions' matrices in the step's order (p_sr, p_ss, p_rs of
    the normal partition, then of the abnormal one), f32 or, with
    ``bf16``, cast to bf16 from the f32 ones (each f32 matrix freed once
    cast)."""
    lead = tuple(graph.normal.kind.shape[:-1])
    mats, n_cols = [], []
    for g in (graph.normal, graph.abnormal):
        p_ss, p_sr, p_rs = densify(g, row_multiple(bf16))
        dense = [p_sr, p_ss, p_rs]
        del p_ss, p_sr, p_rs
        for i in range(3):
            mats.append(dense[i].to(torch.bfloat16) if bf16 else dense[i])
            dense[i] = None
        v, t = int(g.cov_unique.shape[-1]), int(g.kind.shape[-1])
        n_cols += [t, v, v]
    return DenseGroup(tuple(mats), tuple(int(s) for s in x_slots), tuple(n_cols), bool(bf16),
                      lead[0] if lead else None)


def _outputs_shape(group: DenseGroup, m: int) -> Tuple[int, ...]:
    lead = () if group.windows is None else (group.windows,)
    return lead + (int(group.mats[m].shape[-2]),)


def _check_xs(group: DenseGroup, xs: Sequence[torch.Tensor]) -> None:
    lead = () if group.windows is None else (group.windows,)
    if len(xs) <= max(group.x_slots) or len(xs) > MAX_X:
        raise ValueError(f"dense_matvecs: the group reads {max(group.x_slots) + 1} x slots "
                         f"(at most {MAX_X})")
    for slot, n in zip(group.x_slots, group.n_cols):
        if tuple(xs[slot].shape) != lead + (n,):
            raise ValueError(f"dense_matvecs: x slot {slot} must be {lead + (n,)}")


def dense_matvecs_plain(group: DenseGroup, xs: Sequence[torch.Tensor]
                        ) -> Tuple[torch.Tensor, ...]:
    """The kernel's arithmetic in plain PyTorch: per row, lane l's sum j
    (of ``vec_width`` sums) adds the products of columns
    (32 i + l) * vec + j for i = 0, 1, ... in order (each product and
    sum rounded alone; x past its length and the padding columns 0; in
    bf16, x rounded to bf16 and the bf16 matrix widened, exactly); then
    the lane adds its sums left to right, and the lanes fold by the
    shuffle tree 16, 8, 4, 2, 1."""
    _check_xs(group, xs)
    vec = vec_width(group.bf16)
    outs = []
    for mat, slot, n in zip(group.mats, group.x_slots, group.n_cols):
        ld = mat.shape[-1]
        lead = tuple(mat.shape[:-2])
        n_rows, n_iter = mat.shape[-2], ld // (WARP * vec)
        x = torch.nn.functional.pad(xs[slot], (0, ld - n))
        if group.bf16:
            x = x.to(torch.bfloat16).to(torch.float32)
        m4 = mat.view(lead + (n_rows, n_iter, WARP, vec))
        x4 = x.view(lead + (1, n_iter, WARP, vec))
        acc = torch.zeros(lead + (n_rows, WARP, vec), dtype=torch.float32, device=mat.device)
        for i in range(n_iter):
            acc = acc + m4[..., i, :, :].to(torch.float32) * x4[..., i, :, :]
        lanes = acc[..., 0]
        for j in range(1, vec):
            lanes = lanes + acc[..., j]
        off = WARP // 2
        while off:
            lanes = lanes[..., :off] + lanes[..., off: 2 * off]
            off //= 2
        outs.append(lanes[..., 0])
    return tuple(outs)


# The argument block of ``mr_dense_mv`` (csrc ``Word``): each of six
# matrices' pointer, window stride, y offset, rows, columns, ld and x
# slot; four x pointers and their window strides; y, the matrices, the
# windows, bf16, the device and the stream.
ARGS = struct.Struct(f"<{MAX_MATS * 7 + 2 * MAX_X + 6}q")


def check_group(group: DenseGroup, dev) -> None:
    """What the kernel takes on trust about the matrices, checked once a
    window: contiguous, of the group's dtype, on ``dev``, 16-byte
    aligned, each row's stride a multiple of ``row_multiple``, one window
    axis for all."""
    dtype = torch.bfloat16 if group.bf16 else torch.float32
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not 1 <= len(group.mats) <= MAX_MATS or len(group.mats) != len(group.x_slots):
        raise ValueError(f"dense_matvecs: 1 to {MAX_MATS} matrices, one x slot each")
    lead = () if group.windows is None else (group.windows,)
    for mat, n in zip(group.mats, group.n_cols):
        if (mat.device != dev or mat.dtype != dtype or not mat.is_contiguous()
                or mat.data_ptr() % 16 or tuple(mat.shape[:-2]) != lead
                or mat.shape[-1] % row_multiple(group.bf16) or n > mat.shape[-1]):
            raise ValueError(
                f"dense_matvecs: every matrix must be a contiguous, 16-byte aligned "
                f"{dtype} [{', '.join(map(str, lead + ('rows', 'ld')))}] tensor on {dev}, "
                f"its ld a multiple of {row_multiple(group.bf16)} and at least its columns"
            )


def dense_matvecs(group: DenseGroup, xs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """``mats[m] @ xs[x_slots[m]]`` for every matrix m of the group, as
    views of one flat y ([B, rows] each for a stacked group). CPU tensors
    run the plain version; CUDA tensors launch the kernel once (counted
    in ``dense_matvecs.launches``, the products in ``.products``) or
    raise: there is no fallback for a CUDA tensor. The matrices are
    checked once a window (``check_group``, by ``device_subset``), the
    vectors here."""
    dev = xs[0].device
    if dev.type == "cpu":
        return dense_matvecs_plain(group, xs)
    if dev.type != "cuda":
        raise ValueError(f"dense_matvecs: unsupported device {dev}")
    _check_xs(group, xs)
    for x in xs:
        if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"dense_matvecs: every x must be a contiguous float32 tensor on "
                             f"{dev}")
    windows = group.windows or 1
    rows = [int(m.shape[-2]) for m in group.mats]
    y = torch.empty(windows * sum(rows), dtype=torch.float32, device=dev)
    words, at = [], 0
    for mat, r, n, slot in zip(group.mats, rows, group.n_cols, group.x_slots):
        ld = int(mat.shape[-1])
        words += [mat.data_ptr(), r * ld, at, r, n, ld, slot]
        at += windows * r
    words += [0] * (7 * (MAX_MATS - len(group.mats)))
    words += [x.data_ptr() for x in xs] + [0] * (MAX_X - len(xs))
    words += [int(x.shape[-1]) for x in xs] + [0] * (MAX_X - len(xs))
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    lib = load_library()
    rc = lib.mr_dense_mv(ARGS.pack(
        *words, y.data_ptr(), len(group.mats), windows, int(group.bf16), index,
        torch._C._cuda_getCurrentRawStream(index)))
    if rc != 0:
        raise RuntimeError(f"dense_matvecs launch failed: {lib.mr_dense_error_string(rc).decode()}")
    dense_matvecs.launches += 1
    dense_matvecs.products += len(group.mats) * windows
    outs = y.split_with_sizes([windows * r for r in rows])
    return tuple(o.view(_outputs_shape(group, m)) for m, o in enumerate(outs))


# Launches of the dense kernel and the products they computed, a stacked
# group's per window (plain ints; dense_matvecs is the one place that
# launches it).
dense_matvecs.launches = 0
dense_matvecs.products = 0


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
            lib = ctypes.CDLL(str(LIB_PATH))
            lib.mr_dense_mv_words.restype = ctypes.c_int
            lib.mr_dense_mv_words.argtypes = []
            if lib.mr_dense_mv_words() != ARGS.size // 8:
                raise RuntimeError("dense_matvecs: the library's argument block is not the "
                                   "wrapper's")
            lib.mr_dense_mv.restype = ctypes.c_int
            lib.mr_dense_mv.argtypes = [ctypes.c_char_p]  # ARGS, packed
            lib.mr_dense_error_string.restype = ctypes.c_char_p
            lib.mr_dense_error_string.argtypes = [ctypes.c_int]
            _lib = lib
    return _lib
