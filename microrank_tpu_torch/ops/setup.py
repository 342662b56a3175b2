"""K6's set-up: a rank program's preference and initial vectors, as a
hand-written CUDA kernel (``csrc/rank_setup.cu``) with its plain PyTorch
version beside it.

It replaces what XLA compiles for the TPU in
``microrank_tpu/rank_backends/jax_tpu.py:44`` ``preference_vector`` and
the initial vectors of ``:285`` ``_partition_setup``. Per partition
(normal, then abnormal, which carries the anomaly) and per window:

* ``pref`` — the personalized preference vector on the padded trace
  axis (reference: pagerank.py:68-85; paper Eq (7) behind
  ``preference="paper"``), its two normalization sums over the live
  columns in the fixed order of ``ops/fold.py`` (weighted by each
  column's multiplicity when kind-collapsed);
* ``sv0`` — ``1 / (n_ops + n_traces)`` on the present ops, else 0;
* ``rv0`` — the same value on the live trace columns, else 0.

``rank_setup(normal, abnormal, cfg)`` gives both partitions' triples:
on CPU tensors from ``rank_setup_plain`` (the port's eager code as it
stood, op for op, its sums ``fold_rows``); on CUDA tensors from one
cooperative launch of the kernel for both partitions and, for a stacked
group of B windows ([B, T] partitions, [B] counts), every window,
counted in ``rank_setup.launches`` — or it raises: there is no fallback
for a CUDA tensor. Nothing here waits for the card: the grid's size
comes from an occupancy query made once per card (``kernel_config``).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ..config import PageRankConfig
from ..graph.structures import PartitionGraph
from ..utils.build import BUILD_DIR, is_stale, run_build, tmp_output
from .fold import MAX_WIDTH, TREE_HEADER, fold_rows
from .spmv import nvcc
from .step import f32_value

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "rank_setup.cu"
LIB_PATH = BUILD_DIR / "libmr_rank_setup.so"
PREFERENCES = ("reference", "paper")
TILE = 4096  # trace columns a work item (csrc/tree_fold.cuh kTile)
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()

# A partition's (pref, sv0, rv0).
Setup = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _f32(value: float, device) -> torch.Tensor:
    # A fill on the device, not torch.tensor: a copy from pageable host
    # memory waits for the stream.
    return torch.full((), value, dtype=torch.float32, device=device)


def preference_vector(g: PartitionGraph, anomaly: bool, cfg: PageRankConfig) -> torch.Tensor:
    """Personalized preference vector on the padded trace axis
    (reference: pagerank.py:68-85; paper Eq (7) behind
    preference="paper"). On a kind-collapsed graph a column stands for
    ``kind`` identical traces, so the two normalization sums weight each
    column by its multiplicity. A stacked group's partition ([B, T],
    ``n_*`` [B]) gives each window's vector from its own ``n_*``. The
    two sums are one ``fold_rows`` call over the live columns, in an
    order fixed by the live count alone, so a window's bits are the same
    at its own pad and in a group's."""
    t_pad = g.kind.shape[-1]
    dev = g.kind.device
    collapsed = g.n_cols >= 0
    n_live = torch.where(collapsed, g.n_cols, g.n_traces)[..., None]
    live = torch.arange(t_pad, device=dev) < n_live
    kind = g.kind.to(torch.float32)
    tlen = g.tracelen.to(torch.float32)
    mult = torch.where(collapsed[..., None], kind, 1.0)
    inv_kind = torch.where(live, 1.0 / kind, 0.0)
    inv_len = torch.where(live, 1.0 / tlen, 0.0)
    terms = torch.stack([mult * inv_kind, mult * inv_len])  # [2, (B,) T]
    lengths = n_live.to(torch.int32).reshape(-1).repeat(2)
    sums = fold_rows(terms.reshape(-1, t_pad), lengths).view(terms.shape[:-1] + (1,))
    kind_sum, num_sum = sums[0], sums[1]

    if not anomaly:
        pref = inv_kind / kind_sum
    elif cfg.preference == "reference":
        # The code's anomalous form (deviates from paper Eq (7)):
        # phi / num_sum / (kind/kind_sum*phi + 1/n).
        phi = _f32(cfg.phi, dev)
        pref = phi / num_sum / (kind / kind_sum * phi + inv_len)
    elif cfg.preference == "paper":
        phi = _f32(cfg.phi, dev)
        pref = phi * inv_len / num_sum + (1.0 - phi) * inv_kind / kind_sum
    else:
        raise ValueError(f"unknown preference form {cfg.preference!r}")
    return torch.where(live, pref, 0.0)


def partition_setup_plain(g: PartitionGraph, anomaly: bool, cfg: PageRankConfig) -> Setup:
    """One partition's iteration ingredients: (pref, sv0, rv0)."""
    dev = g.kind.device
    t_pad = g.kind.shape[-1]
    n_total = (g.n_ops + g.n_traces).to(torch.float32)[..., None]
    n_live_cols = torch.where(g.n_cols < 0, g.n_traces, g.n_cols)[..., None]
    trace_live = torch.arange(t_pad, device=dev) < n_live_cols
    pref = preference_vector(g, anomaly, cfg)
    init = 1.0 / n_total
    sv = torch.where(g.op_present, init, 0.0)
    rv = torch.where(trace_live, init, 0.0)
    return pref, sv, rv


def rank_setup_plain(normal: PartitionGraph, abnormal: PartitionGraph,
                     cfg: PageRankConfig) -> Tuple[Setup, Setup]:
    """Both partitions' set-up in plain PyTorch: the normal partition's
    preference without the anomaly, the abnormal one's with it."""
    return partition_setup_plain(normal, False, cfg), partition_setup_plain(abnormal, True, cfg)


class KernelConfig(NamedTuple):
    """What the set-up kernel gets on one card (``mr_rank_setup_config``)."""

    cooperative: bool     # the card takes a cooperative launch
    blocks_per_sm: int    # resident blocks of the kernel an SM (occupancy)
    sms: int
    threads: int          # threads a block
    tile: int             # columns a work item

    @property
    def max_blocks(self) -> int:
        """The largest grid the card holds resident: the cooperative limit."""
        return self.blocks_per_sm * self.sms


_configs: Dict[int, KernelConfig] = {}


def kernel_config(device) -> KernelConfig:
    """The set-up kernel's occupancy on ``device`` (a CUDA device), asked
    once per card and kept."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _configs:
        lib = load_library()
        out = (ctypes.c_int32 * 5)()
        rc = lib.mr_rank_setup_config(index, out)
        if rc != 0:
            raise RuntimeError(
                f"rank_setup: device query failed: {lib.mr_rank_setup_error_string(rc).decode()}"
            )
        cfg = KernelConfig(bool(out[0]), *out[1:])
        if not cfg.cooperative or cfg.max_blocks < 1:
            raise RuntimeError(
                f"rank_setup: {torch.cuda.get_device_name(index)} takes no cooperative launch "
                f"of the set-up kernel (cooperative={cfg.cooperative}, "
                f"blocks an SM={cfg.blocks_per_sm}); its grid barrier needs one"
            )
        _configs[index] = cfg
    return _configs[index]


def as_kernel_field(t: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    """``t`` as a kernel reads it: contiguous, of ``dtype``; ``t`` itself
    when it already is (no call into the dispatcher: the wrapper's
    host cost is its calls)."""
    if t.dtype == dtype and t.is_contiguous():
        return t
    return t.to(dtype).contiguous()


def _check(normal: PartitionGraph, abnormal: PartitionGraph) -> Tuple[int, int]:
    """The two partitions' shapes as the kernel reads them: (windows, V)."""
    lead = tuple(normal.kind.shape[:-1])
    if len(lead) > 1:
        raise ValueError("rank_setup: partitions are [T], or [B, T] for a group of B windows")
    v = normal.op_present.shape[-1]
    dev = normal.kind.device
    for g in (normal, abnormal):
        if any(t.device != dev for t in (g.kind, g.tracelen, g.n_cols, g.n_traces, g.n_ops,
                                         g.op_present)):
            raise ValueError(f"rank_setup: every field must lie on {dev}")
        if (tuple(g.kind.shape[:-1]) != lead or g.tracelen.shape != g.kind.shape
                or g.op_present.shape != lead + (v,)
                or any(tuple(t.shape) != lead for t in (g.n_cols, g.n_traces, g.n_ops))):
            raise ValueError("rank_setup: the partitions' shapes do not match")
        if g.op_present.dtype != torch.bool:
            raise ValueError("rank_setup: op_present must be bool")
        if g.kind.shape[-1] > MAX_WIDTH:
            raise ValueError(f"rank_setup: at most {MAX_WIDTH} trace columns")
    return (lead[0] if lead else 1), v


def rank_setup(normal: PartitionGraph, abnormal: PartitionGraph,
               cfg: PageRankConfig) -> Tuple[Setup, Setup]:
    """``rank_setup_plain``'s results: CPU tensors run it; CUDA tensors
    launch the set-up kernel once for both partitions (and every window
    of a stacked group) or raise. The vectors are views of one fresh
    allocation, each contiguous."""
    dev = normal.kind.device
    if dev.type == "cpu":
        return rank_setup_plain(normal, abnormal, cfg)
    if dev.type != "cuda":
        raise ValueError(f"rank_setup: unsupported device {dev}")
    if cfg.preference not in PREFERENCES:
        raise ValueError(f"unknown preference form {cfg.preference!r}")
    windows, v = _check(normal, abnormal)
    lead = tuple(normal.kind.shape[:-1])
    parts = (normal, abnormal)
    t_pads = [int(g.kind.shape[-1]) for g in parts]
    tiles = [-(-t // TILE) for t in t_pads]
    # pref, rv0 (t_pad each), sv0 (v) per partition, then the tile nodes.
    sizes = [windows * n for t in t_pads for n in (t, t, v)] + [2 * windows * sum(tiles)]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    views = flat.split(sizes)
    if lead:
        views = [t.view(lead + (-1,)) for t in views[:-1]] + [views[-1]]
    outs = [(views[3 * p], views[3 * p + 2], views[3 * p + 1]) for p in range(2)]
    ptrs, keep = [], []
    for g, (pref, sv0, rv0) in zip(parts, outs):
        fields = [as_kernel_field(t) for t in (g.kind, g.tracelen, g.n_cols, g.n_traces,
                                               g.n_ops)]
        fields.append(as_kernel_field(g.op_present, torch.bool))
        keep += fields
        ptrs += [t.data_ptr() for t in fields] + [pref.data_ptr(), rv0.data_ptr(),
                                                  sv0.data_ptr()]
    kcfg = kernel_config(dev)
    lib = load_library()
    rc = lib.mr_rank_setup(
        (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int32 * 2)(*t_pads), windows, v,
        f32_value(cfg.phi), int(cfg.preference == "paper"),
        views[-1].data_ptr() if sizes[-1] else None, kcfg.max_blocks,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"rank_setup launch failed: {lib.mr_rank_setup_error_string(rc).decode()}"
        )
    rank_setup.launches += 1
    return outs[0], outs[1]


# Launches of the set-up kernel (a plain int; rank_setup is the one place
# that launches it).
rank_setup.launches = 0


def build_command(out: Path) -> List[str]:
    """The nvcc command that builds the kernel library into ``out``
    (``-Xptxas -v`` reports registers, shared memory and spills;
    ``-fmad=false`` keeps every multiply and add its own rounding, as
    the plain version's ops round)."""
    return [
        nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v", "-o", str(out), str(SOURCE),
    ]


def build_library() -> str:
    """Compile the kernel library if it is missing or older than its
    sources; returns the compiler's report ("" when up to date)."""
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
    lib.mr_rank_setup_config.restype = ctypes.c_int
    lib.mr_rank_setup_config.argtypes = [ctypes.c_int, ctypes.POINTER(i32)]
    lib.mr_rank_setup.restype = ctypes.c_int
    lib.mr_rank_setup.argtypes = [
        ctypes.POINTER(ptr), ctypes.POINTER(i32), i32, i32,   # ptrs, t_pads, windows, v
        ctypes.c_float, i32, ptr, ctypes.c_int64,            # phi, paper, partial, max_blocks
        ctypes.c_int, ptr,                                   # device, stream
    ]
    lib.mr_rank_setup_error_string.restype = ctypes.c_char_p
    lib.mr_rank_setup_error_string.argtypes = [ctypes.c_int]
    return lib
