"""K1: the COO segment-sum SpMV, as a hand-written CUDA kernel
(``csrc/coo_spmv.cu``) with its plain PyTorch version beside it.

It replaces the TPU kernel ``microrank_tpu/ops/pallas_spmv.py``
``coo_segment_sum_pallas`` / ``coo_matvec_pallas``: the same function,
``y[r] = sum over entries e with rows[e] == r of vals[e] * x[cols[e]]``.

Two steps:

* ``row_layout`` — once per window, outside the power-iteration loop: a
  stable sort of the entries by row (one row's entries keep the build's
  order, whatever that order was) plus ``indptr[n_rows + 1]``, with the
  columns and values gathered into that order. Entries at or past
  ``n_live`` are padding (value 0) and move to a sentinel row past the
  end, where no warp reads them.
* ``coo_spmv`` — every step: on a CUDA tensor it launches the kernel
  (one warp per row, fixed-order lane sums and shuffle tree, no
  atomics) or raises; on a CPU tensor it runs ``coo_spmv_plain``, which
  repeats the kernel's arithmetic in the kernel's order, so both give
  the same bits.

What bounds the kernel on the card, and what it does about it, is in
the note at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes
import shutil
from pathlib import Path
from typing import List, NamedTuple, Optional, Union

import torch

from ..utils.build import BUILD_DIR, is_stale, run_build, tmp_output

WARP = 32
SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "coo_spmv.cu"
LIB_PATH = BUILD_DIR / "libmr_coo_spmv.so"
_lib: Optional[ctypes.CDLL] = None


class RowLayout(NamedTuple):
    """A COO matrix laid out by row for ``coo_spmv``."""

    indptr: torch.Tensor  # int32[n_rows + 1]: row r is [indptr[r], indptr[r+1])
    cols: torch.Tensor    # int32[E] column per entry, row-sorted
    vals: torch.Tensor    # float32[E] value per entry, row-sorted
    lane: torch.Tensor    # int64[E] row * 32 + (position in row) % 32
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
    skey = key[perm]
    in_row = torch.arange(e, device=rows.device) - starts[skey]
    return RowLayout(
        indptr=starts[: n_rows + 1].to(torch.int32),
        cols=cols[perm],
        vals=vals[perm],
        lane=skey * WARP + in_row % WARP,
        perm=perm,
        n_rows=int(n_rows),
    )


def coo_spmv_plain(layout: RowLayout, x: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: per-lane sums in
    position order (a sequential index_add on the CPU), then the same
    shuffle tree (16, 8, 4, 2, 1). Padding entries land in the sentinel
    row's lanes, which are dropped."""
    prod = layout.vals * x.index_select(0, layout.cols)
    part = torch.zeros(
        (layout.n_rows + 1) * WARP, dtype=torch.float32, device=x.device
    ).index_add_(0, layout.lane, prod)
    part = part[: layout.n_rows * WARP].view(layout.n_rows, WARP)
    off = WARP // 2
    while off:
        part = part[:, :off] + part[:, off: 2 * off]
        off //= 2
    return part[:, 0].contiguous()


def coo_spmv(layout: RowLayout, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x over a row layout. A CPU ``x`` runs the plain version;
    a CUDA ``x`` launches the kernel (counted in ``coo_spmv.launches``)
    or raises — there is no fallback for a CUDA tensor."""
    if x.device.type == "cpu":
        return coo_spmv_plain(layout, x)
    if x.device.type != "cuda":
        raise ValueError(f"coo_spmv: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("coo_spmv: x must be a contiguous float32 vector")
    for name, t, dtype in (
        ("indptr", layout.indptr, torch.int32),
        ("cols", layout.cols, torch.int32),
        ("vals", layout.vals, torch.float32),
    ):
        if t.device != x.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"coo_spmv: {name} must be a contiguous {dtype} tensor on "
                f"{x.device}"
            )
    if layout.indptr.shape[0] != layout.n_rows + 1:
        raise ValueError("coo_spmv: indptr must have n_rows + 1 entries")
    if layout.n_rows >= 2**31 or x.shape[0] >= 2**31:
        raise ValueError("coo_spmv: extents must fit int32")
    y = torch.empty(layout.n_rows, dtype=torch.float32, device=x.device)
    if layout.n_rows == 0:
        return y
    lib = load_library()
    rc = lib.mr_coo_spmv(
        layout.indptr.data_ptr(),
        layout.cols.data_ptr(),
        layout.vals.data_ptr(),
        x.data_ptr(),
        y.data_ptr(),
        layout.n_rows,
        x.shape[0],
        x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"coo_spmv launch failed: {lib.mr_cuda_error_string(rc).decode()}"
        )
    coo_spmv.launches += 1
    return y


coo_spmv.launches = 0


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
    if _lib is not None:
        return _lib
    build_library()
    lib = ctypes.CDLL(str(LIB_PATH))
    ptr = ctypes.c_void_p
    lib.mr_coo_spmv.restype = ctypes.c_int
    lib.mr_coo_spmv.argtypes = [
        ptr, ptr, ptr, ptr, ptr,      # indptr, cols, vals, x, y
        ctypes.c_int32, ctypes.c_int32,  # n_rows, n_x
        ctypes.c_int,                 # device
        ptr,                          # stream
    ]
    lib.mr_cuda_error_string.restype = ctypes.c_char_p
    lib.mr_cuda_error_string.argtypes = [ctypes.c_int]
    _lib = lib
    return lib
