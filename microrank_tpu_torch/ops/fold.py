"""The rank program's per-window sums in one fixed order, as a
hand-written CUDA kernel (``csrc/row_fold.cu``) with its plain PyTorch
version beside it.

It computes the sums over a padded axis in the set-up and the finish
that JAX computes in XLA (``microrank_tpu/rank_backends/jax_tpu.py:44``
``preference_vector``'s two normalization sums, ``:882``
``_partition_finish``'s total). A sum over a padded axis must not depend
on the pad: a window ranked alone ([T] at its own pad) and the same
window in a stacked group ([B, T] at the group's widest pad) must give
the same bits. A torch reduction pairs the values by the tensor's shape,
so it cannot promise that.

``fold_rows(x, n)`` sums each row's live prefix ``x[r, :n[r]]`` by a
pairwise tree: leaf i of the row, a node at level L covering
[j * 2^L, (j + 1) * 2^L), its value the left child's plus the right
child's, or the left child's alone where the right child starts at or
past n. The tree's shape is a function of n alone and padding is never
read, so the sum is the same on any pad. On CPU tensors it runs
``fold_rows_plain``, which builds the same tree level by level; on CUDA
tensors it launches the kernel (counted in ``fold_rows.launches``) or
raises: there is no fallback for a CUDA tensor.

On the main path the set-up and epilogue kernels (``ops/setup.py``,
``ops/epilogue.py``) fold these sums inside their own launches, with
the same tree (``csrc/tree_fold.cuh``); their plain versions call
``fold_rows``, which is also the tree's standalone yardstick.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional

import torch

from ..utils.build import BUILD_DIR, is_stale, run_build, tmp_output
from .spmv import nvcc

TILE = 4096  # elements one block folds (csrc/row_fold.cu kTile)
MAX_WIDTH = TILE * TILE  # a row's tiles are folded by one block
SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "row_fold.cu"
# The tree's device code, shared with the set-up and epilogue kernels.
TREE_HEADER = SOURCE.with_name("tree_fold.cuh")
LIB_PATH = BUILD_DIR / "libmr_row_fold.so"
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _lengths(x: torch.Tensor, n: Optional[torch.Tensor]) -> torch.Tensor:
    width = x.shape[-1]
    if n is None:
        return torch.full(x.shape[:1], width, dtype=torch.int64, device=x.device)
    return n.to(torch.int64).clamp(0, width)


def fold_rows_plain(x: torch.Tensor, n: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's tree in plain PyTorch: ``x`` [R, W] float32, ``n``
    [R] each row's live length (None: W). Level by level, pair j of a
    level adds its right child to its left child where the right child
    starts before the row's length, else keeps the left child; values
    at or past n are never added. Returns [R] float32."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError("fold_rows: x must be a float32 [rows, width] matrix")
    n = _lengths(x, n)[:, None]
    width = x.shape[1]
    v = torch.where(torch.arange(width, device=x.device) < n, x, 0.0)
    size = 1 << max(width - 1, 0).bit_length()
    v = torch.nn.functional.pad(v, (0, size - width))
    span = 1
    while v.shape[1] > 1:
        left, right = v[:, 0::2], v[:, 1::2]
        right_start = (2 * torch.arange(left.shape[1], device=x.device) + 1) * span
        v = torch.where(right_start < n, left + right, left)
        span *= 2
    return v[:, 0]


def fold_rows(x: torch.Tensor, n: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each row's sum of its first ``n[r]`` values in the tree order
    (``fold_rows_plain``): ``x`` [R, W] float32 (made contiguous), ``n``
    [R] int32 on x's device (None: every row's width). CPU tensors run
    the plain version; CUDA tensors launch the kernel once or raise."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError("fold_rows: x must be a float32 [rows, width] matrix")
    dev = x.device
    if dev.type == "cpu":
        return fold_rows_plain(x, n)
    if dev.type != "cuda":
        raise ValueError(f"fold_rows: unsupported device {dev}")
    n_rows, width = x.shape
    if not 1 <= n_rows <= 65535 or width > MAX_WIDTH:
        raise ValueError(f"fold_rows: 1 to 65535 rows of at most {MAX_WIDTH} values")
    if n is not None and (n.device != dev or n.dtype != torch.int32 or n.shape != (n_rows,)):
        raise ValueError(f"fold_rows: n must be int32 [{n_rows}] on {dev}")
    x = x.contiguous()
    n = None if n is None else n.contiguous()
    out = torch.empty(n_rows, dtype=torch.float32, device=dev)
    tiles = max(1, -(-width // TILE))
    partial = count = None
    if tiles > 1:
        partial = torch.empty(n_rows * tiles, dtype=torch.float32, device=dev)
        count = torch.zeros(n_rows, dtype=torch.int32, device=dev)
    lib = load_library()
    rc = lib.mr_fold_rows(
        x.data_ptr(), None if n is None else n.data_ptr(), n_rows, width,
        None if partial is None else partial.data_ptr(),
        None if count is None else count.data_ptr(), out.data_ptr(),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"fold_rows launch failed: {lib.mr_fold_error_string(rc).decode()}")
    fold_rows.launches += 1
    return out


# Launches of the fold kernel (a plain int; fold_rows is the one place
# that launches it).
fold_rows.launches = 0


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
    if not is_stale(LIB_PATH, [SOURCE, TREE_HEADER]):
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
    lib.mr_fold_rows.restype = ctypes.c_int
    lib.mr_fold_rows.argtypes = [
        ptr, ptr, i32, i32,               # x, n, n_rows, width
        ptr, ptr, ptr,                    # partial, count, out
        ctypes.c_int, ptr,                # device, stream
    ]
    lib.mr_fold_error_string.restype = ctypes.c_char_p
    lib.mr_fold_error_string.argtypes = [ctypes.c_int]
    return lib
