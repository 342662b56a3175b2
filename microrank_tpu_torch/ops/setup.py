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

K19, the warm start (JAX's ``_warm_override``, ``jax_tpu.py:1151``):
``rank_setup(..., init=(sv_n, rv_n, sv_a, rv_a))`` writes a mapped init
(``rank_backends.warm.map_warm_state``) in place of sv0 / rv0 where its
side's masked maximum is > 0 (sv on the present ops, rv on the live
columns), the cold vector where not: the same launch's warm instance on
the card, ``warm_override_plain`` after the cold set-up on the CPU.
``warm_flags=True`` launches K19's first design (flag bits) instead: a
comparison, off the main path.

The first step's int8 scales (JAX's ``quantize_i8``, ``jax_tpu.py:96``,
of the int8 ``cov_pair``'s operands): ``rank_setup(...,
scale_group=group)`` also returns, per partition, the scale of the fwd
operand rv0 * w_len and of the bwd operand sv0 * w_cov (the pattern
group's weights), [4] or [B, 4] for a stacked group, in
``ops.pattern.quantize_scales_plain``'s order and bits: the same launch
on the card (its kScales instances), ``quantize_scales_plain`` of the
plain set-up's vectors on the CPU. On the card it launches the set-up
or raises; it never falls back to the scale launch.

``rank_setup(normal, abnormal, cfg)`` gives both partitions' triples:
on CPU tensors from ``rank_setup_plain`` (the port's eager code as it
stood, op for op, its sums ``fold_rows``); on CUDA tensors from one
launch for both partitions and, for a stacked group of B windows ([B, T]
partitions, [B] counts), every window, counted in
``rank_setup.launches`` — or it raises: there is no fallback for a CUDA
tensor. ``setup_plan`` (pure) picks the launch's form: a block (rows of
one tile of 4,096 columns) or a cluster of blocks (up to 8 tiles) a
row, no grid barrier; a cooperative grid for longer rows (the giant
windows); the first design only when asked (``first_design=True``, a
comparison). The wrapper's host side is one check of the fields, one
allocation and one call with one packed argument block (``ARGS``).
Nothing here waits for the card: the occupancy is asked once per card
(``kernel_config``).
"""

from __future__ import annotations

import ctypes
import functools
import struct
import threading
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..config import PageRankConfig
from ..graph.structures import PartitionGraph
from ..utils.build import BUILD_DIR, is_stale, run_build, tmp_output
from .fold import MAX_WIDTH, TREE_HEADER, fold_rows
from .pattern import FLT_MIN, PatternGroup, quantize_scales_plain
from .spmv import nvcc

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


def warm_override_plain(g: PartitionGraph, sv_cold: torch.Tensor, rv_cold: torch.Tensor,
                        sv_init: torch.Tensor, rv_init: torch.Tensor):
    """One partition's start vectors under a warm init (JAX's
    ``_warm_override`` ``pick``): the init masked (sv to the present
    ops, rv to the live columns), each side the masked init where its
    max is > 0, else its cold vector. The max is compared as XLA's CPU
    compares it: a subnormal max counts as 0 (so at least ``FLT_MIN``),
    and a NaN max fails. Returns (sv, rv)."""
    t_pad = g.kind.shape[-1]
    n_live = torch.where(g.n_cols < 0, g.n_traces, g.n_cols)
    sv = torch.where(g.op_present, sv_init, 0.0)
    rv = torch.where(torch.arange(t_pad, device=rv_init.device) < n_live, rv_init, 0.0)
    return (sv if bool(sv.max() >= FLT_MIN) else sv_cold,
            rv if bool(rv.max() >= FLT_MIN) else rv_cold)


def rank_setup_plain(normal: PartitionGraph, abnormal: PartitionGraph,
                     cfg: PageRankConfig, init=None,
                     scale_group: Optional[PatternGroup] = None):
    """Both partitions' set-up in plain PyTorch: the normal partition's
    preference without the anomaly, the abnormal one's with it; with a
    warm ``init`` (sv_n, rv_n, sv_a, rv_a), its start vectors
    (``warm_override_plain``); with a ``scale_group``, the start vectors'
    int8 scales after the two partitions (``quantize_scales_plain``)."""
    out = partition_setup_plain(normal, False, cfg), partition_setup_plain(abnormal, True, cfg)
    if init is not None:
        warm = []
        for g, (pref, sv, rv), sv_i, rv_i in zip((normal, abnormal), out, init[0::2],
                                                 init[1::2]):
            sv, rv = warm_override_plain(g, sv, rv, sv_i, rv_i)
            warm.append((pref, sv, rv))
        out = tuple(warm)
    if scale_group is None:
        return out
    (_, sv_n, rv_n), (_, sv_a, rv_a) = out
    return out + (quantize_scales_plain(scale_group, (rv_n, rv_a), (sv_n, sv_a)),)


class KernelConfig(NamedTuple):
    """What the set-up kernels get on one card (``mr_rank_setup_config``)."""

    cooperative: bool     # the card takes a cooperative launch
    sms: int
    first_per_sm: int     # resident blocks an SM: the first design's (256 threads)
    grid_per_sm: int      # the grid form's (1024 threads, HOLD_MAX held tiles)
    tile: int             # columns a tile (csrc kTile)
    hold_max: int         # tiles a block of the grid form holds (kHoldMax)
    cluster_max: int      # tiles a row of the rows form (kClusterMax)
    keys: int = 6         # the keyed grid instances' words a row and block (kKeys)

    @property
    def first_blocks(self) -> int:
        """The first design's largest resident grid (its cooperative limit)."""
        return self.first_per_sm * self.sms

    @property
    def grid_blocks(self) -> int:
        """The grid form's largest resident grid."""
        return self.grid_per_sm * self.sms


# What an H100 SXM gives (132 SMs; one 1024-thread block an SM with the
# held tiles; 5 blocks of the first design): the CPU tests' card.
H100 = KernelConfig(True, 132, 5, 1, TILE, 6, 8, 6)

# The forms of a launch (csrc ``Form``): a block or a cluster of blocks a
# (partition, window) row; a cooperative grid holding the live tiles;
# the first design.
FORMS = ("rows", "grid", "first")


class SetupPlan(NamedTuple):
    """One launch of the set-up, as the host plans it (``setup_plan``)."""

    form: str         # one of FORMS
    cluster: int      # rows: blocks a row (1: a plain launch, a block a row)
    grid: int         # blocks launched
    hold: int         # grid: tiles a block holds across the barrier
    tree_items: int   # tiles over both partitions' rows (2 nodes each)


def setup_plan(t_pads: Sequence[int], windows: int, v: int, card: KernelConfig,
               first_design: bool = False) -> SetupPlan:
    """The set-up's launch for trace pads ``t_pads`` (normal, abnormal),
    ``windows`` windows and ``v`` ops on ``card``: rows of at most
    ``card.cluster_max`` tiles of ``TILE`` columns take a cluster of C
    blocks a row, C the least power of two that holds the widest row (a
    row of one tile: a block, no cluster); longer rows a cooperative grid
    of at most ``card.grid_blocks`` blocks, each holding up to
    ``card.hold_max`` of its tiles across the barrier. ``first_design``:
    the first design's grid (a block a tile item, then a block an sv0
    tile, at most ``card.first_blocks``). Pure: the C library checks the
    same rules again."""
    t_pads = [int(t) for t in t_pads]
    if (len(t_pads) != 2 or min(t_pads) < 0 or max(t_pads) > MAX_WIDTH or windows < 1
            or v < 0):
        raise ValueError(f"setup_plan: two trace pads of 0 to {MAX_WIDTH}, windows >= 1 and "
                         f"v >= 0 (got {t_pads}, {windows}, {v})")
    tiles = [-(-t // card.tile) for t in t_pads]
    tree_items = windows * sum(tiles)
    if first_design:
        items = tree_items + 2 * windows * -(-v // card.tile)
        if card.first_blocks < 1:
            raise ValueError("setup_plan: the card holds no block of the first design")
        return SetupPlan("first", 1, min(items, card.first_blocks), 0, tree_items)
    most = max(tiles)
    if most <= card.cluster_max:
        cluster = 1 << max(most - 1, 0).bit_length()
        return SetupPlan("rows", cluster, 2 * windows * cluster, 0, tree_items)
    if card.grid_blocks < 1:
        raise ValueError("setup_plan: the card holds no block of the grid form")
    grid = min(tree_items, card.grid_blocks)
    return SetupPlan("grid", 1, grid, min(-(-tree_items // grid), card.hold_max), tree_items)


_configs: Dict[int, KernelConfig] = {}


def kernel_config(device) -> KernelConfig:
    """The set-up kernels' occupancy on ``device`` (a CUDA device), asked
    once per card and kept."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _configs:
        lib = load_library()
        out = (ctypes.c_int32 * 10)()
        rc = lib.mr_rank_setup_config(index, out)
        if rc != 0:
            raise RuntimeError(
                f"rank_setup: device query failed: {lib.mr_rank_setup_error_string(rc).decode()}"
            )
        if out[4] != TILE or out[7] != ARGS.size // 8 or out[8] != STAMPS:
            raise RuntimeError("rank_setup: the library's tile or argument block is not the "
                               "wrapper's")
        cfg = KernelConfig(bool(out[0]), *out[1:7], out[9])
        if not cfg.cooperative or cfg.first_blocks < 1 or cfg.grid_blocks < 1:
            raise RuntimeError(
                f"rank_setup: {torch.cuda.get_device_name(index)} takes no cooperative launch "
                f"of the set-up's grid (cooperative={cfg.cooperative}, blocks an SM="
                f"{cfg.first_per_sm}, {cfg.grid_per_sm}); the giant windows' rows need one"
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
    kind = normal.kind
    lead = kind.shape[:-1]
    if len(lead) > 1:
        raise ValueError("rank_setup: partitions are [T], or [B, T] for a group of B windows")
    v = normal.op_present.shape[-1]
    index = kind.get_device()
    for g in (normal, abnormal):
        fields = (g.kind, g.tracelen, g.n_cols, g.n_traces, g.n_ops, g.op_present)
        if any(t.get_device() != index for t in fields):
            raise ValueError(f"rank_setup: every field must lie on {kind.device}")
        if (g.kind.shape[:-1] != lead or g.tracelen.shape != g.kind.shape
                or g.op_present.shape != lead + (v,) or g.n_cols.shape != lead
                or g.n_traces.shape != lead or g.n_ops.shape != lead):
            raise ValueError("rank_setup: the partitions' shapes do not match")
        if g.op_present.dtype != torch.bool:
            raise ValueError("rank_setup: op_present must be bool")
        if g.kind.shape[-1] > MAX_WIDTH:
            raise ValueError(f"rank_setup: at most {MAX_WIDTH} trace columns")
    return (lead[0] if lead else 1), v


# The argument block of ``mr_rank_setup_launch`` (csrc ``Word``): each
# partition's nine pointers and trace pad, then windows, v, phi's float32
# bits, paper, form, cluster, grid, hold, partial, stamps, device,
# stream, K19's four init vectors (or 0), the grid form's words (keys or
# flags), the int8 scales' four weight vectors (or 0) and output, and
# K19's flag design (0 or 1).
ARGS = struct.Struct("<43q")
# The phases a launch stamps (csrc kStamps): the rows form its start,
# its columns in registers, its tile's nodes, the row's sums, its
# writes; the grid form its start, phase 1, sv0, the barrier, phase 2.
STAMPS = 5


@functools.lru_cache(maxsize=256)
def _plan(t_n: int, t_a: int, windows: int, v: int, index: int,
          first_design: bool) -> SetupPlan:
    return setup_plan((t_n, t_a), windows, v, kernel_config(index), first_design)


@functools.lru_cache(maxsize=64)
def f32_bits(value: float) -> int:
    """The bits of ``value`` rounded to float32, as an int."""
    return struct.unpack("<i", struct.pack("<f", value))[0]


def _check_init(normal: PartitionGraph, abnormal: PartitionGraph, init) -> None:
    """A warm init as the kernel reads it: one window; four contiguous
    float32 vectors on the partitions' device, [V], [T_n], [V], [T_a]."""
    if normal.kind.dim() != 1:
        raise ValueError("rank_setup: a warm init ranks one window (JAX dispatches warm "
                         "windows one at a time)")
    if len(init) != 4:
        raise ValueError("rank_setup: init is (sv_n, rv_n, sv_a, rv_a)")
    v = normal.op_present.shape[-1]
    want = (v, normal.kind.shape[-1], v, abnormal.kind.shape[-1])
    for t, n in zip(init, want):
        if (t.shape != (n,) or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != normal.kind.device):
            raise ValueError(f"rank_setup: init vectors must be contiguous float32 {want} on "
                             f"{normal.kind.device}")


def _check_scale_group(normal: PartitionGraph, abnormal: PartitionGraph,
                       group: PatternGroup) -> None:
    """The int8 scales' weights as the kernel reads them: the pattern
    group of both partitions (kind, no ``w_out``), its windows the
    partitions', each part's w_len [(B,) T] and w_cov [(B,) V] contiguous
    float32 on the partitions' device."""
    lead = tuple(normal.kind.shape[:-1])
    if len(group.parts) != 2 or group.windows != (lead[0] if lead else None):
        raise ValueError("rank_setup: the scales take a pattern group of both partitions and "
                         "the partitions' windows")
    v = normal.op_present.shape[-1]
    for g, part in zip((normal, abnormal), group.parts):
        for w, n in ((part.w_len, g.kind.shape[-1]), (part.w_cov, v)):
            if (w.shape != lead + (n,) or w.dtype != torch.float32 or not w.is_contiguous()
                    or w.device != normal.kind.device):
                raise ValueError(f"rank_setup: the scales' weights must be contiguous float32 "
                                 f"{lead + (n,)} on {normal.kind.device}")
        if part.w_out is not None:
            raise ValueError("rank_setup: int8 scales are the kind pattern's (no w_out)")


def rank_setup(normal: PartitionGraph, abnormal: PartitionGraph,
               cfg: PageRankConfig, first_design: bool = False,
               stamps: Optional[torch.Tensor] = None, init=None,
               scale_group: Optional[PatternGroup] = None, warm_flags: bool = False):
    """``rank_setup_plain``'s results: CPU tensors run it; CUDA tensors
    launch the set-up once for both partitions (and every window of a
    stacked group), in the form ``setup_plan`` picks, or raise.
    ``first_design``: the first design's kernel (a comparison, off the
    main path). ``stamps``: an int64 tensor of ``STAMPS`` on the card,
    where the rows and grid forms write the SM cycle count at each phase
    of their first block (a measurement; None on the main path). ``init``:
    K19's mapped (sv_n, rv_n, sv_a, rv_a) of one window, launched by the
    rows or grid form's warm instance (the first design has none);
    ``warm_flags``: by K19's first design (a comparison). ``scale_group``:
    the int8 pattern group whose weights make the first step's operands;
    its scales ([4], or [B, 4]) come after the two partitions' triples.
    The vectors are views of one fresh allocation, each contiguous. The
    host side is one check of the fields, one allocation, and one call
    with one packed argument block."""
    dev = normal.kind.device
    if init is not None:
        _check_init(normal, abnormal, init)
        if first_design:
            raise ValueError("rank_setup: the first design has no warm instance")
    elif warm_flags:
        raise ValueError("rank_setup: K19's flag design takes a warm init")
    if scale_group is not None:
        _check_scale_group(normal, abnormal, scale_group)
        if first_design or warm_flags:
            raise ValueError("rank_setup: the first designs give no int8 scales")
    if dev.type == "cpu":
        return rank_setup_plain(normal, abnormal, cfg, init, scale_group)
    if dev.type != "cuda":
        raise ValueError(f"rank_setup: unsupported device {dev}")
    if cfg.preference not in PREFERENCES:
        raise ValueError(f"unknown preference form {cfg.preference!r}")
    windows, v = _check(normal, abnormal)
    t_n, t_a = normal.kind.shape[-1], abnormal.kind.shape[-1]
    index = dev.index
    plan = _plan(t_n, t_a, windows, v, index, first_design)
    # pref, rv0 (t_pad each), sv0 (v) per partition, then the tile nodes
    # (the grid form's and the first design's), the grid form's words
    # (32 bits each: the flag design's, one a tree item and two a block;
    # else with a warm init or scales, kKeys a row and block) and the
    # scales.
    words = 0
    if plan.form == "grid" and init is not None and warm_flags:
        words = plan.tree_items + 2 * plan.grid
    elif plan.form == "grid" and (init is not None or scale_group is not None):
        words = 2 * windows * kernel_config(index).keys * plan.grid
    n_scales = 4 * windows if scale_group is not None else 0
    sizes = (windows * t_n, windows * t_n, windows * v, windows * t_a, windows * t_a,
             windows * v, 0 if plan.form == "rows" else 2 * plan.tree_items, words, n_scales)
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    views = torch.split_with_sizes(flat, sizes)
    if normal.kind.dim() > 1:  # the vectors and scales [B, .]
        widths = (t_n, t_n, v, t_a, t_a, v, None, None, 4 if n_scales else None)
        views = [t if n is None else t.view(windows, n) for t, n in zip(views, widths)]
    at = flat.data_ptr()
    ptrs = []
    for n in sizes:
        ptrs.append(at)
        at += 4 * n
    # The fields as the kernel reads them (a converted copy is held here
    # until the call has taken its pointer).
    words_, fields = [], []
    for g, out, t_pad in ((normal, ptrs[0:3], t_n), (abnormal, ptrs[3:6], t_a)):
        part = [as_kernel_field(g.kind), as_kernel_field(g.tracelen), as_kernel_field(g.n_cols),
                as_kernel_field(g.n_traces), as_kernel_field(g.n_ops),
                as_kernel_field(g.op_present, torch.bool)]
        fields += part
        words_ += [f.data_ptr() for f in part] + [out[0], out[1], out[2], t_pad]
    weights = ([0] * 4 if scale_group is None else
               [w.data_ptr() for p in scale_group.parts for w in (p.w_len, p.w_cov)])
    lib = load_library()
    rc = lib.mr_rank_setup_launch(ARGS.pack(
        *words_, windows, v, f32_bits(cfg.phi), int(cfg.preference == "paper"),
        FORMS.index(plan.form), plan.cluster, plan.grid, plan.hold,
        ptrs[6] if sizes[6] else 0, 0 if stamps is None else stamps.data_ptr(), index,
        torch._C._cuda_getCurrentRawStream(index),
        *([0] * 4 if init is None else [t.data_ptr() for t in init]),
        ptrs[7] if words else 0, *weights, ptrs[8] if n_scales else 0, int(warm_flags)))
    if rc != 0:
        raise RuntimeError(
            f"rank_setup launch failed: {lib.mr_rank_setup_error_string(rc).decode()}"
        )
    rank_setup.launches += 1
    if init is not None:
        rank_setup.warm_launches += 1
    out = (views[0], views[2], views[1]), (views[3], views[5], views[4])
    if scale_group is None:
        return out
    rank_setup.scale_launches += 1
    return out + (views[8],)


# Launches of the set-up kernel, of those its warm instance (K19), and
# of those that gave the first step's int8 scales (plain ints;
# rank_setup is the one place that launches it).
rank_setup.launches = 0
rank_setup.warm_launches = 0
rank_setup.scale_launches = 0


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
    lib.mr_rank_setup_config.restype = ctypes.c_int
    lib.mr_rank_setup_config.argtypes = [ctypes.c_int, ctypes.POINTER(i32)]
    lib.mr_rank_setup_launch.restype = ctypes.c_int
    lib.mr_rank_setup_launch.argtypes = [ctypes.c_char_p]  # ARGS, packed
    lib.mr_rank_setup_error_string.restype = ctypes.c_char_p
    lib.mr_rank_setup_error_string.argtypes = [ctypes.c_int]
    return lib
