"""K6's epilogue: a rank program's finish, spectrum and tie-aware top-k,
as a hand-written CUDA kernel (``csrc/rank_epilogue.cu``) with its plain
PyTorch version beside it.

It replaces what XLA compiles for the TPU in
``microrank_tpu/rank_backends/jax_tpu.py``: ``:882``
``_partition_finish``, ``:971`` ``spectrum_counters``, ``:1006``
``window_spectrum`` (the 13 formulas of
``microrank_tpu/spectrum/formulas.py``), ``:1046`` ``top_k_tiebroken``
and ``:1068`` ``_finish_topk``. From each partition's final carry sv:

* the finish: ``score = sv / max(sv)``, ``weight = score * total /
  n_ops`` with ``total`` the present scores' sum in the fixed order of
  ``ops/fold.py`` (reference: pagerank.py:93-112);
* the spectrum counters {ef, nf, ep, np} (reference: online_rca.py:43-69,
  the asymmetric only-in-normal branch included) and the configured
  formula; -inf where no partition holds the op;
* the top-k by score descending, op index ascending on exact ties
  (``-0.0`` and ``+0.0`` equal, NaN last), k = min(n_rows, V), and
  ``n_valid = min(#valid, k)``.

``rank_epilogue(normal, abnormal, sv_n, sv_a, cfg)`` gives an
``Epilogue``: on CPU tensors from ``rank_epilogue_plain`` (the port's
eager code as it stood, op for op; its sums ``fold_rows``, its order a
stable ``torch.sort``); on CUDA tensors from one launch of the kernel, a
block a window of a stacked group, counted in
``rank_epilogue.launches`` — or it raises: there is no fallback for a
CUDA tensor. Nothing here waits for the card.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, NamedTuple, Optional

import torch

from ..config import SpectrumConfig
from ..graph.structures import PartitionGraph
from ..spectrum.formulas import FORMULAS, spectrum_scores
from ..utils.build import BUILD_DIR, is_stale, run_build, tmp_output
from .fold import MAX_WIDTH, TREE_HEADER, fold_rows
from .setup import as_kernel_field
from .spmv import nvcc
from .step import f32_value

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "rank_epilogue.cu"
LIB_PATH = BUILD_DIR / "libmr_rank_epilogue.so"
SMEM_KEYS = 1024  # top-k keys the kernel sorts in shared memory (kSmemKeys)
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()

# The kernel's formula ids (csrc/rank_epilogue.cu ``Method``), one a
# name of spectrum/formulas.py; "simplematcing" (sic, the reference's
# key) is "simplematching".
_METHOD_ORDER = ("dstar2", "ochiai", "jaccard", "sorensendice", "m1", "m2", "goodman",
                 "tarantula", "russellrao", "hamann", "dice", "simplematching", "rogers")
METHOD_IDS = {name: i for i, name in enumerate(_METHOD_ORDER)}
METHOD_IDS["simplematcing"] = METHOD_IDS["simplematching"]
assert set(METHOD_IDS) == set(FORMULAS)


def method_id(method: str) -> int:
    """The kernel's id of a spectrum method name; raises on an unknown
    name as ``spectrum_scores`` does."""
    try:
        return METHOD_IDS[method]
    except KeyError:
        raise ValueError(f"unknown spectrum method {method!r}") from None


class Epilogue(NamedTuple):
    """A rank program's epilogue: the finish of both partitions and the
    ranking ([B, ...] for a stacked group of B windows)."""

    n_weight: torch.Tensor    # float32 [(B,) V]
    a_weight: torch.Tensor
    score_n: torch.Tensor     # float32 [(B,) V], sv / max(sv)
    score_a: torch.Tensor
    top_idx: torch.Tensor     # int32 [(B,) k]
    top_scores: torch.Tensor  # float32 [(B,) k]
    n_valid: torch.Tensor     # int32 [(B,)]


def partition_finish(g: PartitionGraph, sv):
    """Final normalize + the reference's rescale (pagerank.py:93-112):
    returns (weight[V], score[V]), [B, V] for a stacked group. The sum
    over the op axis is one ``fold_rows`` call, in the fixed order of
    the preference vector's sums."""
    score = sv / sv.amax(-1, keepdim=True)
    present = torch.where(g.op_present, score, 0.0)
    total = fold_rows(present.reshape(-1, present.shape[-1])).view(present.shape[:-1] + (1,))
    weight = score * total / g.n_ops.to(torch.float32)[..., None]
    return weight, score


def spectrum_counters(a_weight, a_graph: PartitionGraph, n_weight, n_graph: PartitionGraph,
                      cfg: SpectrumConfig):
    """The spectrum counters {ef, nf, ep, np} over the shared op vocab
    (reference: online_rca.py:43-69, incl. the asymmetric only-in-normal
    branch at :65-66). Returns (ef, nf, ep, np_, valid)."""
    eps = torch.full((), cfg.eps, dtype=torch.float32, device=a_weight.device)
    a_present = a_graph.op_present
    n_present = n_graph.op_present
    a_cov = a_graph.cov_unique.to(torch.float32)
    n_cov = n_graph.cov_unique.to(torch.float32)
    a_len = a_graph.n_traces.to(torch.float32)[..., None]
    n_len = n_graph.n_traces.to(torch.float32)[..., None]

    ef = torch.where(a_present, a_weight * a_cov, eps)
    nf = torch.where(a_present, a_weight * (a_len - a_cov), eps)
    ep = torch.where(
        a_present,
        torch.where(n_present, n_weight * n_cov, eps),
        (1.0 + n_weight) * n_cov,
    )
    np_ = torch.where(
        a_present,
        torch.where(n_present, n_weight * (n_len - n_cov), eps),
        n_len - n_cov,
    )
    valid = a_present | n_present
    return ef, nf, ep, np_, valid


def window_spectrum(a_weight, a_graph, n_weight, n_graph, cfg: SpectrumConfig):
    """Spectrum counters + formula; invalid ops score -inf. Returns
    (scores[V], valid[V])."""
    ef, nf, ep, np_, valid = spectrum_counters(a_weight, a_graph, n_weight, n_graph, cfg)
    scores = spectrum_scores(ef, nf, ep, np_, cfg.method)
    return torch.where(valid, scores, float("-inf")), valid


def top_k_tiebroken(scores, k: int):
    """Top-k by score descending, op index ascending on EXACT ties —
    what JAX's two-key ``lax.sort`` gives. ``torch.topk`` is not
    tie-stable; a stable ascending sort of the negated scores keeps
    equal keys in index order. ``+ 0.0`` turns -0.0 into +0.0 so the two
    zeros cannot split. Returns (top_scores[k], top_idx[k]), along the
    last axis ([B, k] for a stacked group's scores)."""
    neg = -(scores + 0.0)
    neg_sorted, idx_sorted = torch.sort(neg, dim=-1, stable=True)
    return -neg_sorted[..., :k], idx_sorted[..., :k].to(torch.int32)


def finish_topk(normal: PartitionGraph, abnormal: PartitionGraph, n_weight, a_weight,
                spectrum_cfg: SpectrumConfig):
    """Spectrum + top-k tail: (top_idx int32[k], top_scores float32[k],
    n_valid int32)."""
    scores, valid = window_spectrum(a_weight, abnormal, n_weight, normal, spectrum_cfg)
    k = min(spectrum_cfg.n_rows, scores.shape[-1])
    top_scores, top_idx = top_k_tiebroken(scores, k)
    n_valid = torch.clamp(valid.sum(-1), max=k).to(torch.int32)
    return top_idx, top_scores, n_valid


def rank_epilogue_plain(normal: PartitionGraph, abnormal: PartitionGraph, sv_n, sv_a,
                        spectrum_cfg: SpectrumConfig) -> Epilogue:
    """The epilogue in plain PyTorch."""
    n_weight, score_n = partition_finish(normal, sv_n)
    a_weight, score_a = partition_finish(abnormal, sv_a)
    top_idx, top_scores, n_valid = finish_topk(normal, abnormal, n_weight, a_weight,
                                               spectrum_cfg)
    return Epilogue(n_weight, a_weight, score_n, score_a, top_idx, top_scores, n_valid)


def _check(normal: PartitionGraph, abnormal: PartitionGraph, sv_n, sv_a):
    """The epilogue's inputs as the kernel reads them: (lead, V)."""
    lead = tuple(sv_n.shape[:-1])
    v = sv_n.shape[-1]
    if len(lead) > 1:
        raise ValueError("rank_epilogue: vectors are [V], or [B, V] for a group of B windows")
    if not 1 <= v <= MAX_WIDTH:
        raise ValueError(f"rank_epilogue: 1 to {MAX_WIDTH} ops")
    if lead and not 1 <= lead[0] <= 65535:
        raise ValueError("rank_epilogue: 1 to 65535 windows")
    dev = sv_n.device
    for g, sv in ((normal, sv_n), (abnormal, sv_a)):
        if sv.shape != sv_n.shape or sv.dtype != torch.float32 or sv.device != dev:
            raise ValueError(f"rank_epilogue: sv must be float32 {tuple(sv_n.shape)} on {dev}")
        if (g.op_present.shape != sv.shape or g.cov_unique.shape != sv.shape
                or tuple(g.n_traces.shape) != lead or tuple(g.n_ops.shape) != lead):
            raise ValueError("rank_epilogue: the partitions' shapes do not match sv")
        if g.op_present.dtype != torch.bool:
            raise ValueError("rank_epilogue: op_present must be bool")
        if any(t.device != dev for t in (g.op_present, g.cov_unique, g.n_traces, g.n_ops)):
            raise ValueError(f"rank_epilogue: every field must lie on {dev}")
    return lead, v


def rank_epilogue(normal: PartitionGraph, abnormal: PartitionGraph, sv_n: torch.Tensor,
                  sv_a: torch.Tensor, spectrum_cfg: SpectrumConfig) -> Epilogue:
    """``rank_epilogue_plain``'s results: CPU tensors run it; CUDA tensors
    launch the epilogue kernel once (a block a window) or raise. The
    outputs are views of one fresh allocation, each contiguous."""
    dev = sv_n.device
    if dev.type == "cpu":
        return rank_epilogue_plain(normal, abnormal, sv_n, sv_a, spectrum_cfg)
    if dev.type != "cuda":
        raise ValueError(f"rank_epilogue: unsupported device {dev}")
    method = method_id(spectrum_cfg.method)
    lead, v = _check(normal, abnormal, sv_n, sv_a)
    windows = lead[0] if lead else 1
    k = min(spectrum_cfg.n_rows, v)
    if k < 1:
        raise ValueError("rank_epilogue: k = min(n_rows, V) must be at least 1")
    k_pad = 1 << (k - 1).bit_length()
    tiles = -(-v // 4096)
    # weight, score of each partition, the canonical scores, the tile
    # nodes, top_idx, top_scores, n_valid.
    n = windows * v
    sizes = [n, n, n, n, n, windows * 2 * tiles if tiles > 1 else 0,
             windows * k, windows * k, windows]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    (w_n, s_n, w_a, s_a, scores, nodes, top_idx, top_scores, n_valid) = flat.split(sizes)
    keys = None
    if k_pad > SMEM_KEYS:
        keys = torch.empty(windows * k_pad, dtype=torch.int64, device=dev)
    fields = []
    for g, sv, w, s in ((normal, sv_n, w_n, s_n), (abnormal, sv_a, w_a, s_a)):
        fields += [as_kernel_field(sv, torch.float32), as_kernel_field(g.op_present, torch.bool),
                   *(as_kernel_field(t) for t in (g.cov_unique, g.n_traces, g.n_ops)), w, s]
    ptrs = [t.data_ptr() for t in fields] + [
        scores.data_ptr(), nodes.data_ptr() if tiles > 1 else None,
        None if keys is None else keys.data_ptr(),
        top_idx.data_ptr(), top_scores.data_ptr(), n_valid.data_ptr(),
    ]
    lib = load_library()
    rc = lib.mr_rank_epilogue(
        (ctypes.c_void_p * len(ptrs))(*ptrs), windows, v, k, k_pad, method,
        f32_value(spectrum_cfg.eps),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"rank_epilogue launch failed: {lib.mr_rank_epilogue_error_string(rc).decode()}"
        )
    rank_epilogue.launches += 1
    top_idx, n_valid = top_idx.view(torch.int32), n_valid.view(torch.int32)
    if not lead:
        return Epilogue(w_n, w_a, s_n, s_a, top_idx, top_scores, n_valid.view(()))
    vec, top = lead + (v,), lead + (k,)
    return Epilogue(w_n.view(vec), w_a.view(vec), s_n.view(vec), s_a.view(vec),
                    top_idx.view(top), top_scores.view(top), n_valid)


# Launches of the epilogue kernel (a plain int; rank_epilogue is the one
# place that launches it).
rank_epilogue.launches = 0


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
    i32 = ctypes.c_int32
    lib.mr_rank_epilogue.restype = ctypes.c_int
    lib.mr_rank_epilogue.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), i32, i32, i32, i32,  # ptrs, windows, v, k, k_pad
        i32, ctypes.c_float,                                  # method, eps
        ctypes.c_int, ctypes.c_void_p,                        # device, stream
    ]
    lib.mr_rank_epilogue_error_string.restype = ctypes.c_char_p
    lib.mr_rank_epilogue_error_string.argtypes = [ctypes.c_int]
    return lib
