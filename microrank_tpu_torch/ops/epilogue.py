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
stable ``torch.sort``); on CUDA tensors from one launch for every window
of a stacked group, counted in ``rank_epilogue.launches`` — or it
raises: there is no fallback for a CUDA tensor. ``epilogue_plan``
(pure) picks the launch's form: a block of 1,024 threads a window
holding its inputs in shared memory (up to 8,192 ops), a cluster of
such blocks a window (up to 8 x 8,192), else the first design; and the
top-k's: a warp-select for k <= 32; past it, where k reaches
``SORT_SHARE`` of the vocabulary (k = V among them), a sort of each
block's keys whole in shared memory, merged across a cluster by merge
path; else a radix select. The host
side is one check, one allocation and one call with one packed
argument block (``ARGS``). Nothing here waits for the card.

K13, every formula in one launch: ``rank_epilogue_all_methods`` gives
an ``Epilogue`` whose top-k is [(B,) M, k], row m the ranking of
``spectrum.formulas.METHODS[m]`` (JAX's ``rank_window_all_methods_core``,
``jax_tpu.py:1373``), each row bitwise the one-method launch's for its
formula; plain version ``finish_topk_all_methods`` (the counters once,
then each formula's scores and top-k). Its launches count in
``rank_epilogue.launches`` with every other, and by kind in
``rank_epilogue.by_kind`` ("one_method", "checked", "all_methods").

K14, the checked program: ``rank_epilogue_checked`` gives the same
``Epilogue`` and each window's check word (int32 [(B,)]): JAX's checkify
checks of ``jax_tpu.py:1415`` / ``:1450`` as bits, set by the same one
launch (a flag argument: an unchecked launch runs as before).
``CHECK_MESSAGES`` holds JAX's message of each bit; ``check_word_plain``
is the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import threading
from collections import Counter
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

import torch

from ..config import SpectrumConfig
from ..graph.structures import PartitionGraph
from ..spectrum.formulas import FORMULAS, METHODS, spectrum_scores
from ..utils.build import BUILD_DIR, is_stale, run_build, tmp_output
from .fold import MAX_WIDTH, TREE_HEADER, fold_rows
from .setup import as_kernel_field, f32_bits
from .spmv import nvcc

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "rank_epilogue.cu"
LIB_PATH = BUILD_DIR / "libmr_rank_epilogue.so"
# The formulas, sort keys and warp networks it shares with K15
# (``ops/explain.py``).
COMMON_HEADER = SOURCE.with_name("rank_common.cuh")
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
# K13's rows are METHODS in order, which is the kernel's formula order.
assert [METHOD_IDS[m] for m in METHODS] == list(range(len(METHODS)))


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
    top_idx: torch.Tensor     # int32 [(B,) k]; every formula (K13): [(B,) M, k]
    top_scores: torch.Tensor  # float32 [(B,) k]; every formula: [(B,) M, k]
    n_valid: torch.Tensor     # int32 [(B,)]


# K14's bits, in JAX's order of checks, with JAX's messages
# (jax_tpu.py:1431-1439, :1474-1488): a live top score (rank < n_valid)
# not finite; n_valid outside [0, k]; a live residual (step < n_iters)
# not finite (the traced program only).
CHECK_NONFINITE_SCORE, CHECK_N_VALID, CHECK_NONFINITE_RESIDUAL = 1, 2, 4
CHECK_MESSAGES = (
    (CHECK_NONFINITE_SCORE,
     "non-finite ranked score inside the device program "
     "(preference vector or spectrum formula produced NaN/inf)"),
    (CHECK_N_VALID, "n_valid outside [0, k]"),
    (CHECK_NONFINITE_RESIDUAL,
     "non-finite power-iteration residual inside the device program "
     "(the ranking vectors diverged)"),
)


def check_word_plain(top_scores, n_valid, residuals=None, n_iters=None) -> torch.Tensor:
    """K14's check word of each window in plain PyTorch, int32 [(B,)]:
    ``top_scores`` [(B,) k], ``n_valid`` [(B,)]; with ``residuals``
    [(B,) 2, I] and ``n_iters`` [(B,)] the residual check too."""
    k = top_scores.shape[-1]
    dev = top_scores.device
    live = torch.arange(k, device=dev) < n_valid[..., None]
    word = (live & ~torch.isfinite(top_scores)).any(-1).to(torch.int32) * CHECK_NONFINITE_SCORE
    word = word | ((n_valid < 0) | (n_valid > k)).to(torch.int32) * CHECK_N_VALID
    if residuals is not None:
        live_it = torch.arange(residuals.shape[-1], device=dev) < n_iters[..., None, None]
        bad = (live_it & ~torch.isfinite(residuals)).flatten(-2).any(-1)
        word = word | bad.to(torch.int32) * CHECK_NONFINITE_RESIDUAL
    return word


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


def finish_topk_all_methods(normal: PartitionGraph, abnormal: PartitionGraph, n_weight,
                            a_weight, spectrum_cfg: SpectrumConfig):
    """K13's tail: the counters once, then each formula of ``METHODS``
    in order, its scores (-inf where no partition holds the op) and its
    top-k, each as ``finish_topk`` takes them (``spectrum_cfg.method``
    is not read). Returns (top_idx int32[(B,) M, k], top_scores
    float32[(B,) M, k], n_valid int32[(B,)])."""
    ef, nf, ep, np_, valid = spectrum_counters(a_weight, abnormal, n_weight, normal,
                                               spectrum_cfg)
    k = min(spectrum_cfg.n_rows, valid.shape[-1])
    tops = [top_k_tiebroken(torch.where(valid, spectrum_scores(ef, nf, ep, np_, m),
                                        float("-inf")), k) for m in METHODS]
    n_valid = torch.clamp(valid.sum(-1), max=k).to(torch.int32)
    return (torch.stack([idx for _, idx in tops], -2),
            torch.stack([scores for scores, _ in tops], -2), n_valid)


def rank_epilogue_plain(normal: PartitionGraph, abnormal: PartitionGraph, sv_n, sv_a,
                        spectrum_cfg: SpectrumConfig, all_methods: bool = False) -> Epilogue:
    """The epilogue in plain PyTorch (``all_methods``: every formula's
    top-k, K13's)."""
    n_weight, score_n = partition_finish(normal, sv_n)
    a_weight, score_a = partition_finish(abnormal, sv_a)
    tail = finish_topk_all_methods if all_methods else finish_topk
    top_idx, top_scores, n_valid = tail(normal, abnormal, n_weight, a_weight, spectrum_cfg)
    return Epilogue(n_weight, a_weight, score_n, score_a, top_idx, top_scores, n_valid)


TILE = 4096          # ops a tile of the finish's tree (csrc/tree_fold.cuh kTile)
SLICE_MAX = 2 * TILE  # ops a block of the window forms holds (kSliceMax)
WARP_K = 32           # k up to this: the warp-select (kWarpK)
# Past the warp-select, k at or past this share of the vocabulary sorts
# every key in shared memory instead of selecting (the radix passes find
# what is nearly known: most live keys are wanted). Fixed from
# chip_smoke's k13 sweep (``selection_sweep``; PERF.md §6): the
# least k / V from which on the sort ran no slower than the radix select,
# one formula and K13, at the config-5 kind window (V 3,072).
SORT_SHARE = 0.125

# The forms of a launch (csrc ``Form``): a block a window; a cluster of
# blocks a window, each a slice of whole tiles; the first design (a
# block of 256 threads a window streaming through global memory: past
# what a cluster holds, and for comparison).
FORMS = ("block", "cluster", "first")


class KernelConfig(NamedTuple):
    """What the epilogue kernels get on one card (``mr_rank_epilogue_config``)."""

    sms: int
    slice_max: int    # ops a block holds (kSliceMax)
    cluster_max: int  # blocks a window's cluster may have on this card
    warp_k: int       # k up to this: the warp-select (kWarpK)
    smem_keys: int    # keys block 0 sorts in shared memory (kSmemKeys)
    tile: int


# An H100 SXM: the CPU tests' card.
H100 = KernelConfig(132, SLICE_MAX, 8, WARP_K, SMEM_KEYS, TILE)


def row_bytes(n: int, elt: int) -> int:
    """Shared memory of an input row of ``n`` elements of ``elt`` bytes
    (16 bytes of room for its alignment; csrc ``row_bytes``)."""
    return (n * elt + 31) // 16 * 16


def window_smem(slice_: int, sort_keys: int = 0) -> int:
    """A window block's dynamic shared memory (csrc ``window_smem``): the
    key list (``SMEM_KEYS`` keys, or the sort's ``sort_keys`` where
    more), then sv and cov_unique (4 bytes) and op_present (1 byte) of
    both partitions."""
    return (max(SMEM_KEYS, sort_keys) * 8 + 4 * row_bytes(slice_, 4)
            + 2 * row_bytes(slice_, 1))


class EpiloguePlan(NamedTuple):
    """One launch of the epilogue, as the host plans it (``epilogue_plan``)."""

    form: str      # one of FORMS
    select: str    # one of SELECTS, or the first design's "first"
    cluster: int   # blocks a window
    slice: int     # ops a block (the window forms)
    k_pad: int     # the least power of two >= k (the radix select's sort)
    smem: int      # a block's dynamic shared memory, bytes
    sort_keys: int = 0  # "sort": the list a block sorts (a power of two >= its slice)


# The top-k's selections past the first design: the warp-select (k <=
# warp_k), the sort of every key, the radix select.
SELECTS = ("warp", "sort", "radix")


def epilogue_plan(v: int, k: int, windows: int, card: KernelConfig,
                  first_design: bool = False, select: Optional[str] = None) -> EpiloguePlan:
    """The epilogue's launch for ``windows`` windows of ``v`` ops and a
    top-``k`` on ``card``: a block a window while ``v`` fits a block's
    shared memory (``card.slice_max`` ops); else a cluster of the least
    power of two blocks that holds it, at most ``card.cluster_max``, each
    a slice of whole tiles; past that (and with ``first_design``) the
    first design. The top-k: the warp-select for k <= ``card.warp_k``;
    past it the sort where k >= ``SORT_SHARE`` * v (a block's list the
    least power of two >= its slice, at least 32), else a radix select
    (keys sorted in scratch past ``card.smem_keys``). ``select`` ("sort"
    or "radix", past the warp-select) overrides the share: a
    measurement's. Pure: the C library checks the same rules again."""
    if not 1 <= v <= MAX_WIDTH or not 1 <= k <= v or not 1 <= windows <= 65535:
        raise ValueError(f"epilogue_plan: 1 to {MAX_WIDTH} ops, 1 <= k <= ops and 1 to 65535 "
                         f"windows (got {v}, {k}, {windows})")
    if select not in (None, "sort", "radix"):
        raise ValueError(f"epilogue_plan: select is 'sort' or 'radix' (got {select!r})")
    k_pad = 1 << (k - 1).bit_length()
    if first_design or v > card.cluster_max * card.slice_max:
        return EpiloguePlan("first", "first", 1, v, k_pad, 0)
    if k <= card.warp_k:
        select = "warp"
    elif select is None:
        select = "sort" if k >= SORT_SHARE * v else "radix"
    if v <= card.slice_max:
        form, cluster, slice_ = "block", 1, v
    else:
        form = "cluster"
        cluster = 1 << (-(-v // card.slice_max) - 1).bit_length()
        slice_ = card.tile * -(-(-(-v // card.tile)) // cluster)
    sort_keys = max(32, 1 << (slice_ - 1).bit_length()) if select == "sort" else 0
    return EpiloguePlan(form, select, cluster, slice_, k_pad, window_smem(slice_, sort_keys),
                        sort_keys)


_configs: Dict[int, KernelConfig] = {}


def kernel_config(device) -> KernelConfig:
    """The epilogue kernels' limits on ``device`` (a CUDA device), asked
    once per card and kept."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _configs:
        lib = load_library()
        out = (ctypes.c_int32 * 8)()
        rc = lib.mr_rank_epilogue_config(index, out)
        if rc != 0:
            raise RuntimeError(f"rank_epilogue: device query failed: "
                               f"{lib.mr_rank_epilogue_error_string(rc).decode()}")
        cfg = KernelConfig(*out[:6])
        if (cfg.slice_max, cfg.warp_k, cfg.smem_keys, cfg.tile) != (
                SLICE_MAX, WARP_K, SMEM_KEYS, TILE) or out[6] != ARGS.size // 8 or out[7] != STAMPS:
            raise RuntimeError("rank_epilogue: the library's limits or argument block are not "
                               "the wrapper's")
        _configs[index] = cfg
    return _configs[index]


def _check(normal: PartitionGraph, abnormal: PartitionGraph, sv_n, sv_a):
    """The epilogue's inputs as the kernel reads them: (lead, V)."""
    shape = sv_n.shape
    lead = shape[:-1]
    v = shape[-1]
    if len(lead) > 1:
        raise ValueError("rank_epilogue: vectors are [V], or [B, V] for a group of B windows")
    if not 1 <= v <= MAX_WIDTH:
        raise ValueError(f"rank_epilogue: 1 to {MAX_WIDTH} ops")
    if lead and not 1 <= lead[0] <= 65535:
        raise ValueError("rank_epilogue: 1 to 65535 windows")
    index = sv_n.get_device()
    for g, sv in ((normal, sv_n), (abnormal, sv_a)):
        if sv.shape != shape or sv.dtype != torch.float32 or sv.get_device() != index:
            raise ValueError(f"rank_epilogue: sv must be float32 {tuple(shape)} on "
                             f"{sv_n.device}")
        if (g.op_present.shape != shape or g.cov_unique.shape != shape
                or g.n_traces.shape != lead or g.n_ops.shape != lead):
            raise ValueError("rank_epilogue: the partitions' shapes do not match sv")
        if g.op_present.dtype != torch.bool:
            raise ValueError("rank_epilogue: op_present must be bool")
        if (g.op_present.get_device() != index or g.cov_unique.get_device() != index
                or g.n_traces.get_device() != index or g.n_ops.get_device() != index):
            raise ValueError(f"rank_epilogue: every field must lie on {sv_n.device}")
    return tuple(lead), v


# The argument block of ``mr_rank_epilogue_launch`` (csrc ``Word``): each
# partition's seven pointers, the first design's scores and nodes, keys,
# top_idx, top_scores, n_valid, stamps, K14's check words, residuals,
# n_iters and steps, then windows, v, k, k_pad, method, the method rows
# (1, or every formula: K13), eps's float32 bits, form, cluster, slice,
# smem, the sort's list (0: no sort), device, stream.
ARGS = struct.Struct("<39q")
# The phases the window form stamps (csrc kStamps): its start, the slice
# loaded, the maxima, the scores, the totals, the spectrum, the block's
# selection, the top-k written.
STAMPS = 8


@functools.lru_cache(maxsize=256)
def _plan(v: int, k: int, windows: int, index: int, first_design: bool,
          select: Optional[str] = None) -> EpiloguePlan:
    return epilogue_plan(v, k, windows, kernel_config(index), first_design, select)


def _check_trace(residuals, n_iters, lead, dev) -> None:
    """The residual trace K14 reads: float32 [(B,) 2, I] and int32
    [(B,)], contiguous, on ``dev``."""
    if (residuals.dim() != len(lead) + 2 or tuple(residuals.shape[:-2]) != lead
            or residuals.shape[-2] != 2 or residuals.dtype != torch.float32
            or not residuals.is_contiguous() or residuals.device != dev
            or tuple(n_iters.shape) != lead or n_iters.dtype != torch.int32
            or not n_iters.is_contiguous() or n_iters.device != dev):
        raise ValueError(f"rank_epilogue: the checked residuals are float32 {lead + (2, 'I')} "
                         f"and n_iters int32 {lead}, contiguous on {dev}")


def rank_epilogue(normal: PartitionGraph, abnormal: PartitionGraph, sv_n: torch.Tensor,
                  sv_a: torch.Tensor, spectrum_cfg: SpectrumConfig,
                  first_design: bool = False,
                  stamps: Optional[torch.Tensor] = None,
                  select: Optional[str] = None) -> Epilogue:
    """``rank_epilogue_plain``'s results: CPU tensors run it; CUDA tensors
    launch the epilogue once (every window of a group), in the form
    ``epilogue_plan`` picks, or raise. ``first_design``: the first
    design's kernel (a comparison, off the main path). ``select``: the
    selection past the warp-select, "sort" or "radix", in place of the
    plan's (a comparison, off the main path). ``stamps``: an
    int64 tensor of ``STAMPS`` on the card, where the window form writes
    the SM cycle count at each phase of the first window (a measurement;
    None on the main path). The outputs are views of one fresh
    allocation, each contiguous. The host side is one check of the
    fields, one allocation, and one call with one packed argument
    block."""
    return _rank_epilogue(normal, abnormal, sv_n, sv_a, spectrum_cfg, first_design, stamps,
                          select=select)[0]


def rank_epilogue_checked(normal: PartitionGraph, abnormal: PartitionGraph,
                          sv_n: torch.Tensor, sv_a: torch.Tensor,
                          spectrum_cfg: SpectrumConfig,
                          residuals: Optional[torch.Tensor] = None,
                          n_iters: Optional[torch.Tensor] = None,
                          first_design: bool = False):
    """``rank_epilogue`` and K14's check word of each window, int32
    [(B,)], from the same one launch (CPU tensors: the plain versions),
    over the residual trace ``residuals`` [(B,) 2, I] and ``n_iters``
    where given (JAX's traced checked program), else over the ranking
    alone. Returns (Epilogue, check words)."""
    return _rank_epilogue(normal, abnormal, sv_n, sv_a, spectrum_cfg, first_design, None,
                          True, residuals, n_iters)


def rank_epilogue_all_methods(normal: PartitionGraph, abnormal: PartitionGraph,
                              sv_n: torch.Tensor, sv_a: torch.Tensor,
                              spectrum_cfg: SpectrumConfig,
                              first_design: bool = False,
                              select: Optional[str] = None) -> Epilogue:
    """K13: ``rank_epilogue`` with every formula's top-k, [(B,) M, k] in
    ``METHODS`` order (``spectrum_cfg.method`` is not read), from one
    launch with a methods axis (CPU tensors: ``rank_epilogue_plain(...,
    all_methods=True)``); the weights, scores and n_valid are the
    one-method launch's. ``first_design``: the first design's kernel
    with the same axis (a comparison, as for ``rank_epilogue``);
    ``select`` as for ``rank_epilogue``."""
    return _rank_epilogue(normal, abnormal, sv_n, sv_a, spectrum_cfg, first_design, None,
                          all_methods=True, select=select)[0]


def _rank_epilogue(normal, abnormal, sv_n, sv_a, spectrum_cfg, first_design, stamps,
                   check: bool = False, residuals=None, n_iters=None, all_methods: bool = False,
                   select: Optional[str] = None):
    """The epilogue (and, with ``check``, the check words; else None)."""
    dev = sv_n.device
    if check and all_methods:
        raise ValueError("rank_epilogue: the checked program ranks one formula")
    if dev.type == "cpu":
        out = rank_epilogue_plain(normal, abnormal, sv_n, sv_a, spectrum_cfg, all_methods)
        word = (check_word_plain(out.top_scores, out.n_valid, residuals, n_iters)
                if check else None)
        return out, word
    if dev.type != "cuda":
        raise ValueError(f"rank_epilogue: unsupported device {dev}")
    method = 0 if all_methods else method_id(spectrum_cfg.method)
    rows = len(METHODS) if all_methods else 1
    lead, v = _check(normal, abnormal, sv_n, sv_a)
    if residuals is not None:
        _check_trace(residuals, n_iters, lead, dev)
    windows = lead[0] if lead else 1
    k = min(spectrum_cfg.n_rows, v)
    if k < 1:
        raise ValueError("rank_epilogue: k = min(n_rows, V) must be at least 1")
    index = dev.index
    plan = _plan(v, k, windows, index, first_design, select)
    first = plan.form == "first"
    tiles = -(-v // TILE)
    # weight, score of each partition, top_idx, top_scores (a row a
    # formula), n_valid; K14's check words; the first design's canonical
    # scores and tile nodes (a row's own).
    n = windows * v
    m = windows * rows
    sizes = (n, n, n, n, m * k, m * k, windows, windows if check else 0)
    if first:
        sizes += (m * v, m * 2 * tiles if tiles > 1 else 0)
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    w_n, s_n, w_a, s_a, top_idx, top_scores, n_valid, word = (
        torch.split_with_sizes(flat, sizes)[:8])
    at = flat.data_ptr()
    ptrs = []
    for size in sizes:
        ptrs.append(at if size else 0)
        at += 4 * size
    keys = None
    if plan.k_pad > SMEM_KEYS:
        keys = torch.empty(m * plan.k_pad, dtype=torch.int64, device=dev)
    # The fields as the kernel reads them (a converted copy is held here
    # until the call has taken its pointer).
    words, fields = [], []
    for g, sv, out in ((normal, sv_n, ptrs[0:2]), (abnormal, sv_a, ptrs[2:4])):
        part = [as_kernel_field(sv, torch.float32), as_kernel_field(g.op_present, torch.bool),
                as_kernel_field(g.cov_unique), as_kernel_field(g.n_traces),
                as_kernel_field(g.n_ops)]
        fields += part
        words += [f.data_ptr() for f in part] + [out[0], out[1]]
    lib = load_library()
    rc = lib.mr_rank_epilogue_launch(ARGS.pack(
        *words, ptrs[8] if first else 0, ptrs[9] if first else 0,
        0 if keys is None else keys.data_ptr(), ptrs[4], ptrs[5],
        ptrs[6], 0 if stamps is None else stamps.data_ptr(), ptrs[7],
        0 if residuals is None else residuals.data_ptr(),
        0 if residuals is None else n_iters.data_ptr(),
        0 if residuals is None else residuals.shape[-1], windows, v, k, plan.k_pad, method,
        rows, f32_bits(spectrum_cfg.eps),
        FORMS.index(plan.form), plan.cluster, plan.slice, plan.smem, plan.sort_keys, index,
        torch._C._cuda_getCurrentRawStream(index)))
    if rc != 0:
        raise RuntimeError(
            f"rank_epilogue launch failed: {lib.mr_rank_epilogue_error_string(rc).decode()}"
        )
    rank_epilogue.launches += 1
    rank_epilogue.by_kind["all_methods" if all_methods else "checked" if check
                          else "one_method"] += 1
    top_idx, n_valid = top_idx.view(torch.int32), n_valid.view(torch.int32)
    word = word.view(torch.int32).view(lead) if check else None
    top = lead + ((rows,) if all_methods else ()) + (k,)
    top_idx, top_scores = top_idx.view(top), top_scores.view(top)
    if not lead:
        return Epilogue(w_n, w_a, s_n, s_a, top_idx, top_scores, n_valid.view(())), word
    return Epilogue(w_n.view(windows, v), w_a.view(windows, v), s_n.view(windows, v),
                    s_a.view(windows, v), top_idx, top_scores, n_valid), word


# Launches of the epilogue kernel (a plain int; _rank_epilogue is the one
# place that launches it), and the same launches by kind: "one_method",
# "checked" (K14), "all_methods" (K13).
rank_epilogue.launches = 0
rank_epilogue.by_kind = Counter()


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
    if not is_stale(LIB_PATH, [SOURCE, TREE_HEADER, COMMON_HEADER]):
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
    lib.mr_rank_epilogue_config.restype = ctypes.c_int
    lib.mr_rank_epilogue_config.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]
    lib.mr_rank_epilogue_launch.restype = ctypes.c_int
    lib.mr_rank_epilogue_launch.argtypes = [ctypes.c_char_p]  # ARGS, packed
    lib.mr_rank_epilogue_error_string.restype = ctypes.c_char_p
    lib.mr_rank_epilogue_error_string.argtypes = [ctypes.c_int]
    return lib
