"""K5: the power-iteration step's elementwise tail, as a hand-written
CUDA kernel (``csrc/power_step.cu``) with its plain PyTorch version
beside it.

It replaces the iteration driver that XLA compiled for the TPU in
``microrank_tpu/rank_backends/jax_tpu.py``: ``_partition_step`` (one
partition's step) and the step / ``part_delta`` / residual body of
``window_weights_full``'s loop, with the ``tol`` freeze of its
while_loop. From the step's products of both partitions (``y_sr =
p_sr @ rv``, ``y_ss = p_ss @ sv``, ``y_rs = p_rs @ sv``; K1, the pcsr
kernel, or the pattern pair and K1) one step computes, per partition:

    sv' = d * (y_sr + alpha * y_ss)
    rv' = d * y_rs + (1 - d) * pref
    sv' /= max(sv'), rv' /= max(rv')     (max_normalize_each_iter)
    residuals[p, i] = max(max|sv' - sv|, max|rv' - rv|)

With ``tol`` (the port issues every step and branches on no device
value): the carry is ``where(running, new, old)``, the residual 0 when
not running, ``n_iters += running`` and ``running &= max(residuals[:,
i]) > tol``, all on the device. On the kind route with int8 operands the
step also gives the next step's four quantization scales
(``ops.pattern.quantize_scales_plain`` of the vectors it carries).

* ``step_plan`` — once per window: the preference vectors, the f32
  scalars (host floats; the plain version makes them 0-d tensors), and
  the kernel's scratch (``STEP_SCRATCH`` int32, allocated with the
  window's layouts by ``rank_backends.torch_cuda.device_subset``).
* ``grid_plan`` — a pure function of the four vectors' lengths, the
  windows B, the cooperative grid's limit and the family's largest slot
  count: the least ``per_thread`` whose units (chunks of per_thread x
  256 elements of one vector of one window) fit the grid, the
  instantiation's slots, the units, the grid, each vector's first unit
  and units a window, and the values a group's thread holds past its
  slots in shared memory. The C library checks it at set-up.
* ``StepWindow`` — once per window: checks the plan, the first carry,
  the residual trace and the tol state, allocates two carry buffers
  that the steps alternate between (a step never writes the carry it
  reads) and, on the card, sets up the kernel's arguments, grid plan
  and stream in the C library. ``StepWindow.step`` then passes only the
  step's six product pointers, the carry slots and the step index: one
  cooperative launch a step on a grid sized by occupancy, a block a
  unit, the values in registers across one grid barrier, counted in
  ``power_step.launches`` and by instantiation in
  ``power_step.by_kernel``. A card that refuses the launch raises; there
  is no other path. On CPU tensors it runs ``power_step_plain`` into
  the same buffers.
  One window launches ``step_grid<S>``. A stacked group of B windows
  (K18) passes [B, n] vectors and launches ``step_grid_group<S>``, the
  same design with a (vector, window) a unit: 2B partitions, each
  window with its own maxima, residuals, n_iters, running flag and int8
  scales ([B, 4]; scratch ``step_scratch_size(B)``). PR 13's group
  kernel (``step_grid_units``: units of 256 elements that every block
  walks) stays as ``mode="group_units"`` for chip_smoke's comparison
  only; nothing on the main path reaches it.
* ``power_step`` — one step with fresh outputs (the tests' and
  chip_smoke's signature): a ``StepWindow`` of its own, the same launch;
  on CPU tensors ``power_step_plain``, the port's eager code as it
  stood, op for op, so the kernel is held bitwise to it on the card.
"""

from __future__ import annotations

import ctypes
import threading
import weakref
from collections import Counter
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.build import BUILD_DIR, is_stale, run_build, tmp_output
from .pattern import PatternGroup, quantize_scales_plain
from .spmv import nvcc

# The kernel's scratch of one window, int32: four vector maxima, two
# residuals, four int8 amax slots and an arrival count (csrc kScratch),
# 0 between steps. A group of B windows holds the maxima, residuals and
# amax slots of each window: step_scratch_size(B).
STEP_SCRATCH = 11
SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "power_step.cu"
LIB_PATH = BUILD_DIR / "libmr_power_step.so"
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def step_scratch_size(windows: int = 1) -> int:
    """int32 slots of the step kernel's scratch for ``windows`` windows."""
    return (STEP_SCRATCH - 1) * windows + 1


# Threads a block of every step kernel (csrc kThreads).
THREADS = 256
# The vectors a step carries: rv_n, sv_n, rv_a, sv_a (csrc kVecs).
VECS = 4
# The kernels a grid plan names (csrc kWindowKernel, kGroupKernel,
# kUnitsKernel).
KERNEL_WINDOW, KERNEL_GROUP, KERNEL_UNITS = 0, 1, 2


class GridPlan(NamedTuple):
    """One window's (or group's) grid, as the C library takes it
    (``mr_step_window_create``'s ``plan``, these fields in order)."""

    kernel: int        # KERNEL_WINDOW, KERNEL_GROUP or KERNEL_UNITS
    per_thread: int    # elements of a vector a thread takes in a unit
    slots: int         # the instantiation's register slots (0: PR 13's kernel)
    units: int         # chunks of per_thread x THREADS elements, every vector and window
    grid: int          # blocks
    grid_windows: int  # the grid's rows: a group's grid is its units a window x this
    held: int          # values a group's thread holds past its slots in shared memory
    first: Tuple[int, ...]   # each vector's first unit in a window
    blocks: Tuple[int, ...]  # each vector's units in one window

    @property
    def kernel_name(self) -> str:
        if self.kernel == KERNEL_UNITS:
            return "step_grid_units"
        family = "step_grid_group" if self.kernel == KERNEL_GROUP else "step_grid"
        return f"{family}<{self.slots}>"


def slots_for(per_thread: int, most: int) -> int:
    """The least of 1, 2, 4, 8 that holds ``per_thread`` elements, else
    ``most``: the instantiation a thread runs (csrc ``slots_for``)."""
    return next((s for s in (1, 2, 4, 8) if per_thread <= s), most)


def grid_plan(ns: Sequence[int], windows: int, max_blocks: int, most_slots: int,
              held_max: int = 0, units_kernel: bool = False) -> GridPlan:
    """The grid of a step over four vectors of lengths ``ns`` (rv_n,
    sv_n, rv_a, sv_a) in each of ``windows`` windows, on at most
    ``max_blocks`` blocks: the least per_thread whose units, summed over
    the vectors and windows, fit max(max_blocks, 4 * windows); the least
    instantiation of 1, 2, 4, 8 and ``most_slots`` that holds it; the
    group's kernel holds up to ``held_max`` values a thread past its
    slots. One window plans ``step_grid<S>`` on a grid of its units; a
    group ``step_grid_group<S>`` on a grid of its units a window by the
    windows that fit (all of them, unless every (vector, window) is one
    unit and the windows outnumber max_blocks / 4: the blocks then walk
    the rest). ``units_kernel``: PR 13's plan (per_thread 1, every block
    walking units of 256)."""
    ns = [int(n) for n in ns]
    if len(ns) != VECS or min(ns) < 1 or windows < 1 or max_blocks < VECS:
        raise ValueError(f"grid_plan: four lengths >= 1, windows >= 1 and at least {VECS} "
                         f"blocks (got {ns}, {windows}, {max_blocks})")

    def units_at(per):
        return windows * sum(-(-n // (THREADS * per)) for n in ns)

    if units_kernel:
        kernel, per = KERNEL_UNITS, 1
    else:
        kernel = KERNEL_WINDOW if windows == 1 else KERNEL_GROUP
        cap = max(max_blocks, VECS * windows)
        # No per_thread below total / (THREADS * cap) fits: start there.
        per = max(windows * sum(ns) // (THREADS * cap), 1)
        while units_at(per) > cap:
            per += 1
    blocks = tuple(-(-n // (THREADS * per)) for n in ns)
    first = tuple(sum(blocks[:i]) for i in range(VECS))
    slots = 0 if kernel == KERNEL_UNITS else slots_for(per, most_slots)
    units = units_at(per)
    rows, grid = 1, min(units, max_blocks)
    held = 0
    if kernel == KERNEL_GROUP:
        held = min(max(per - slots, 0), held_max)
        rows = min(windows, max_blocks // sum(blocks))
        grid = sum(blocks) * rows
    return GridPlan(kernel, per, slots, units, grid, rows, held, first, blocks)


# A partition's carry (sv, rv) and a step's products (y_sr, y_ss, y_rs).
Carry = Tuple[Tuple[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]
Products = Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], ...]


def f32_value(value: float) -> float:
    """``value`` rounded to float32, as ``torch.tensor(value,
    dtype=torch.float32)`` rounds it."""
    return float(np.float32(value))


class StepPlan(NamedTuple):
    """What every step of one window reads beside its products and its
    carry. The scalars are host floats holding float32 values
    (``f32_value``): the kernel takes them by value, and the plain
    version makes them 0-d float32 tensors of the carry's device."""

    prefs: Tuple[torch.Tensor, torch.Tensor]  # float32[T_p] per partition
    alpha: float                              # the call weight
    d: float                                  # the damping
    tol: Optional[float]                      # None: every step runs
    normalize: bool                           # max_normalize_each_iter
    scratch: torch.Tensor                     # int32[STEP_SCRATCH], the kernel's
    # int8 (kind): the pattern group whose operands the next step
    # quantizes (each partition's w_len for rv, w_cov for sv; [B, n] for
    # a stacked group, which gets [B, 4] scales).
    scale_group: Optional[PatternGroup] = None


def step_scratch(device, windows: int = 1) -> torch.Tensor:
    """A window's (or a group of ``windows`` windows') scratch of the step
    kernel, zeroed."""
    return torch.zeros(step_scratch_size(windows), dtype=torch.int32, device=device)


def step_plan(
    prefs: Sequence[torch.Tensor],
    call_weight: float,
    damping: float,
    tol: Optional[float],
    normalize: bool,
    scratch: torch.Tensor,
    scale_group: Optional[PatternGroup] = None,
) -> StepPlan:
    """One window's plan. Touches no device memory: the rank program
    issues it without waiting on the stream."""
    if len(prefs) != 2:
        raise ValueError("step_plan: one preference vector per partition (2)")
    return StepPlan(
        prefs=tuple(prefs),
        alpha=f32_value(call_weight),
        d=f32_value(damping),
        tol=None if tol is None else f32_value(tol),
        normalize=bool(normalize),
        scratch=scratch,
        scale_group=scale_group,
    )


def _partition_step(products, alpha, pref, normalize: bool, d):
    """One power-iteration step (pagerank.py:122-127) from the step's
    products (p_sr @ rv, p_ss @ sv, p_rs @ sv):
    sv' = d*(p_sr @ rv + alpha * p_ss @ sv);
    rv' = d*(p_rs @ sv) + (1-d) * pref; both max-normalized (over the
    last axis: a stacked group's rows are its windows)."""
    y_sr, y_ss, y_rs = products
    sv_new = d * (y_sr + alpha * y_ss)
    rv_new = d * y_rs + (1.0 - d) * pref
    if normalize:
        sv_new = sv_new / sv_new.amax(-1, keepdim=True)
        rv_new = rv_new / rv_new.amax(-1, keepdim=True)
    return sv_new, rv_new


def _part_delta(new, old):
    return torch.maximum(
        (new[0] - old[0]).abs().amax(-1), (new[1] - old[1]).abs().amax(-1)
    )


def power_step_plain(
    plan: StepPlan,
    products: Products,
    carry: Carry,
    residuals: torch.Tensor,
    i: int,
    n_iters: Optional[torch.Tensor] = None,
    running: Optional[torch.Tensor] = None,
    want_scales: bool = False,
) -> Tuple[Carry, Optional[torch.Tensor]]:
    """Step ``i`` in plain PyTorch: returns (the new carry, the next
    step's int8 scales or None) and writes ``residuals[..., i]``; with
    ``plan.tol``, updates ``n_iters`` (int32) and ``running`` (bool) in
    place. One window: 1-d vectors, residuals [2, I], 0-d n_iters and
    running; a group of B: [B, n] vectors, residuals [B, 2, I], [B]
    n_iters and running, each window frozen on its own."""
    dev = carry[0][0].device

    def scalar(value):
        # Filled on the device (no copy from host memory, which would
        # wait for the stream), the same float32 value.
        return torch.full((), value, dtype=torch.float32, device=dev)

    alpha, d = scalar(plan.alpha), scalar(plan.d)
    new = tuple(
        _partition_step(ys, alpha, pref, plan.normalize, d)
        for ys, pref in zip(products, plan.prefs)
    )
    deltas = torch.stack([_part_delta(pn, po) for pn, po in zip(new, carry)], -1)
    if plan.tol is None:
        residuals[..., i] = deltas
    else:
        new = tuple(
            tuple(torch.where(running[..., None], a, b) for a, b in zip(pn, po))
            for pn, po in zip(new, carry)
        )
        residuals[..., i] = torch.where(running[..., None], deltas, 0.0)
        n_iters += running.to(torch.int32)
        running &= deltas.amax(-1) > scalar(plan.tol)
    scales = None
    if want_scales:
        scales = quantize_scales_plain(
            plan.scale_group, [p[1] for p in new], [p[0] for p in new]
        )
    return new, scales


def _check_window(plan, carry, residuals, n_iters, running, dev) -> None:
    """A window's (or a stacked group's) step state, checked once at
    set-up: the plan's preference vectors and the first carry contiguous
    float32 on one device, of matching lengths, 1-d for one window and
    [B, n] for a group of B; the residual trace [2, n_steps] ([B, 2,
    n_steps]); the tol state (0-d, or [B]); the scratch; the int8 weights
    (the carry's shapes)."""
    if len(plan.prefs) != 2 or len(carry) != 2:
        raise ValueError("power_step: a carry and a preference vector per partition (2)")
    lead = tuple(carry[0][0].shape[:-1])
    if len(lead) > 1:
        raise ValueError("power_step: vectors are 1-d, or [B, n] for a group of B windows")
    for (sv, rv), pref in zip(carry, plan.prefs):
        if any(t.device != dev or t.dtype != torch.float32 or not t.is_contiguous()
               or t.shape[:-1] != lead for t in (sv, rv, pref)):
            raise ValueError(f"power_step: every vector must be contiguous float32 on {dev}")
        if pref.shape != rv.shape or not (sv.shape[-1] and rv.shape[-1]):
            raise ValueError("power_step: pref and carry of mismatched or empty lengths")
    if residuals.dtype != torch.float32 or residuals.shape[:-1] != lead + (2,) or (
        not residuals.is_contiguous() or residuals.device != dev or residuals.shape[-1] < 1
    ):
        raise ValueError(
            f"power_step: residuals must be contiguous float32 [{', '.join(map(str, lead + (2,)))}, "
            f"n_steps] on {dev}"
        )
    if (plan.tol is None) != (n_iters is None) or (n_iters is None) != (running is None):
        raise ValueError("power_step: n_iters and running go with a tol, and only then")
    if n_iters is not None and (
        n_iters.dtype != torch.int32 or running.dtype != torch.bool
        or n_iters.shape != lead or running.shape != lead
        or n_iters.device != dev or running.device != dev
    ):
        raise ValueError(f"power_step: n_iters int32 and running bool, one each a window, on {dev}")
    n_scratch = step_scratch_size(lead[0] if lead else 1)
    if plan.scratch.device != dev or plan.scratch.shape != (n_scratch,) or (
        plan.scratch.dtype != torch.int32
    ):
        raise ValueError(f"power_step: the plan's scratch must be int32[{n_scratch}] on {dev}")
    if plan.scale_group is not None:
        for part, (sv, rv) in zip(plan.scale_group.parts, carry):
            if part.w_len.shape != rv.shape or part.w_cov.shape != sv.shape or any(
                t.device != dev or t.dtype != torch.float32 or not t.is_contiguous()
                for t in (part.w_len, part.w_cov)
            ):
                raise ValueError("power_step: the scale group's weights must match the carry")


def _check_products(products, carry) -> None:
    """A step's products: three per partition, contiguous float32 on the
    carry's device, y_sr and y_ss of sv's length, y_rs of rv's."""
    dev = carry[0][0].device
    if len(products) != 2:
        raise ValueError("power_step: products of two partitions")
    for ys, (sv, rv) in zip(products, carry):
        if len(ys) != 3 or any(
            t.device != dev or t.dtype != torch.float32 or not t.is_contiguous() for t in ys
        ):
            raise ValueError(f"power_step: every product must be contiguous float32 on {dev}")
        if (ys[0].shape, ys[1].shape, ys[2].shape) != (sv.shape, sv.shape, rv.shape):
            raise ValueError("power_step: products and carry of mismatched lengths")


class KernelConfig(NamedTuple):
    """What the step kernels get on one card (``mr_power_step_config``)."""

    cooperative: bool     # the card takes a cooperative launch
    blocks_per_sm: int    # resident blocks of every step kernel an SM (occupancy)
    sms: int
    slots: int            # register slots a thread at most, across the barrier (a window)
    threads: int          # threads a block
    group_slots: int      # the same, step_grid_group's largest instantiation
    held_max: int         # values a group's thread at most holds past its slots

    @property
    def max_blocks(self) -> int:
        """The largest grid the card holds resident: the cooperative limit."""
        return self.blocks_per_sm * self.sms


_configs: Dict[int, KernelConfig] = {}


def kernel_config(device) -> KernelConfig:
    """The step kernels' occupancy on ``device`` (a CUDA device), asked
    once per card and kept."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _configs:
        lib = load_library()
        out = (ctypes.c_int32 * 7)()
        rc = lib.mr_power_step_config(index, out)
        if rc != 0:
            raise RuntimeError(
                f"power_step: device query failed: {lib.mr_power_step_error_string(rc).decode()}"
            )
        _configs[index] = KernelConfig(bool(out[0]), *out[1:])
    return _configs[index]


# The ways a window's steps can run: the kernel its grid plan names (the
# main path; on CPU tensors its plain version), the plain step on any
# device, PR 13's group kernel (comparison only).
STEP_MODES = ("kernel", "plain", "group_units")


class StepWindow:
    """One window's K5 state, set up once from the plan, the first carry,
    the residual trace and (with a tol) the n_iters / running state, all
    checked here, once.

    Three carries: slot 0 is the window's first (the caller's tensors),
    slots 1 and 2 two buffers of one allocation that the steps alternate
    between, 0 -> 1 -> 2 -> 1 -> ..., so no step writes the carry it
    reads (the residual and the freeze read it). Every window has its
    own buffers: the carry a window's last step leaves is never written
    again. With a scale group, the int8 scales a step gives go to one
    buffer of the window's, which the next step's products read before
    that step overwrites it (stream order). On the card the steps launch
    on the stream that was current at set-up, on ``grid`` blocks of
    ``per_thread`` elements a thread, of which ``slots`` (the kernel's
    instantiation) stay in registers. ``max_blocks`` caps the grid below
    the card's cooperative limit (the tests' way to a window past the
    register slots) or, above it, asks for a grid the card refuses.
    ``mode`` is one of STEP_MODES. ``hold``: a group's thread holds its
    values past the slots in shared memory across the barrier (False:
    it recomputes them from the products, chip_smoke's comparison).

    A stacked group of B windows passes [B, n] carries and preference
    vectors, residuals [B, 2, n_steps] and [B] n_iters / running: one
    launch a step of ``step_grid_group<S>`` for all of them
    (``windows``; a block a unit of one vector of one window; or the
    plain step, or PR 13's kernel; int8 scales [B, 4], each window's
    own). ``grid_plan`` (a ``GridPlan``) is the plan the kernel runs."""

    def __init__(self, plan: StepPlan, carry: Carry, residuals: torch.Tensor,
                 n_iters: Optional[torch.Tensor] = None, running: Optional[torch.Tensor] = None,
                 mode: str = "kernel", max_blocks: Optional[int] = None, hold: bool = True):
        if mode not in STEP_MODES:
            raise ValueError(f"power_step: unknown mode {mode!r}; known: {STEP_MODES}")
        dev = carry[0][0].device
        _check_window(plan, carry, residuals, n_iters, running, dev)
        self.plan, self.residuals, self.n_iters, self.running = plan, residuals, n_iters, running
        self.mode = "plain" if dev.type == "cpu" else mode
        lead = tuple(carry[0][0].shape[:-1])
        self.windows = lead[0] if lead else None
        sizes = []
        for sv, rv in carry:
            sizes += [rv.shape[-1], sv.shape[-1]]
        n_win = self.windows or 1
        flat = torch.empty(2 * n_win * sum(sizes), dtype=torch.float32, device=dev)
        bufs = [b.view(*lead, -1) for b in flat.split_with_sizes([n_win * n for n in sizes] * 2)]
        # Slot s's carry as the loop holds it: ((sv_n, rv_n), (sv_a, rv_a)).
        self.carries = [tuple(tuple(carry[p]) for p in range(2))] + [
            ((bufs[4 * s + 1], bufs[4 * s]), (bufs[4 * s + 3], bufs[4 * s + 2])) for s in (0, 1)
        ]
        self.slot = 0
        self.scales = None
        if plan.scale_group is not None:
            self.scales = torch.empty(lead + (4,), dtype=torch.float32, device=dev)
        self._products_checked = False
        self.grid_plan: Optional[GridPlan] = None
        self.grid = self.per_thread = self.slots = self.units = None
        self._handle = None
        if self.mode != "plain":
            self._set_up_kernel(dev, max_blocks, hold)

    def _set_up_kernel(self, dev, max_blocks, hold) -> None:
        cfg = kernel_config(dev)
        if not cfg.cooperative:
            raise RuntimeError(
                f"power_step: {torch.cuda.get_device_name(dev)} refuses a cooperative launch "
                "(cudaDevAttrCooperativeLaunch is 0); the step kernel's grid barrier needs one"
            )
        if cfg.blocks_per_sm < 1:
            raise RuntimeError(
                f"power_step: the step kernel fits no block on an SM at {cfg.slots} register "
                "slots (occupancy 0); no cooperative grid can launch"
            )
        plan, lib = self.plan, load_library()
        ptrs = []
        for p in range(2):
            weights = (None, None)
            if self.scales is not None:
                part = plan.scale_group.parts[p]
                weights = (part.w_len.data_ptr(), part.w_cov.data_ptr())
            for v, pref in ((1, plan.prefs[p].data_ptr()), (0, None)):  # rv, then sv
                ptrs += [pref] + [c[p][v].data_ptr() for c in self.carries] + [weights[1 - v]]
        ns = [self.carries[0][p][v].shape[-1] for p in range(2) for v in (1, 0)]
        cap = cfg.max_blocks if max_blocks is None else int(max_blocks)
        windows = self.windows or 1
        gp = grid_plan(ns, windows, cap, cfg.slots if windows == 1 else cfg.group_slots,
                       cfg.held_max if hold else 0, units_kernel=self.mode == "group_units")
        fields = [*gp[:-2], *gp.first, *gp.blocks]
        handle = ctypes.c_void_p()
        r, n = self.residuals, self.n_iters
        rc = lib.mr_step_window_create(
            (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int64 * 4)(*ns),
            plan.alpha, plan.d, 0.0 if plan.tol is None else plan.tol, int(plan.normalize),
            r.shape[-1], windows, plan.scratch.data_ptr(), r.data_ptr(),
            None if n is None else n.data_ptr(),
            None if n is None else self.running.data_ptr(),
            None if self.scales is None else self.scales.data_ptr(),
            dev.index if dev.index is not None else torch.cuda.current_device(),
            torch.cuda.current_stream(dev).cuda_stream, cap,
            (ctypes.c_int64 * len(fields))(*fields), ctypes.byref(handle),
        )
        if rc != 0:
            raise ValueError(
                f"power_step: set-up refused: {lib.mr_power_step_error_string(rc).decode()}"
            )
        self._handle = handle.value
        weakref.finalize(self, lib.mr_step_window_free, self._handle)
        self._run = lib.mr_step_window_run
        self.grid_plan = gp
        self.grid, self.per_thread = gp.grid, gp.per_thread
        self.slots, self.units = gp.slots, gp.units

    @property
    def carry(self) -> Carry:
        """The carry the next step reads."""
        return self.carries[self.slot]

    def step(self, products: Products, i: int,
             want_scales: bool = False) -> Tuple[Carry, Optional[torch.Tensor]]:
        """Step ``i`` from its products: returns (the new carry, the next
        step's int8 scales or None) and writes ``residuals[:, i]`` (with a
        tol, n_iters and running). The products are checked at the
        window's first step only: every later step's come from the same
        kernels at the same shapes."""
        if not 0 <= i < self.residuals.shape[-1]:
            raise ValueError(f"power_step: step {i} outside the trace of "
                             f"{self.residuals.shape[-1]}")
        if not self._products_checked:
            _check_products(products, self.carries[0])
            self._products_checked = True
        if want_scales and self.scales is None:
            raise ValueError("power_step: int8 scales need the plan's scale_group")
        src, dst = self.slot, 2 if self.slot == 1 else 1
        if self.grid_plan is not None:
            (sr_n, ss_n, rs_n), (sr_a, ss_a, rs_a) = products
            rc = self._run(self._handle, sr_n.data_ptr(), ss_n.data_ptr(), rs_n.data_ptr(),
                           sr_a.data_ptr(), ss_a.data_ptr(), rs_a.data_ptr(), src, dst, i,
                           int(want_scales))
            if rc != 0:
                raise RuntimeError(
                    f"power_step launch failed: "
                    f"{load_library().mr_power_step_error_string(rc).decode()}"
                )
            power_step.launches += 1
            power_step.by_kernel[self.grid_plan.kernel_name] += 1
        else:
            new, scales = power_step_plain(self.plan, products, self.carries[src], self.residuals,
                                           i, self.n_iters, self.running, want_scales)
            for part_new, part_out in zip(new, self.carries[dst]):
                for t_new, t_out in zip(part_new, part_out):
                    t_out.copy_(t_new)
            if want_scales:
                self.scales.copy_(scales)
        self.slot = dst
        return self.carries[dst], self.scales if want_scales else None


def power_step(
    plan: StepPlan,
    products: Products,
    carry: Carry,
    residuals: torch.Tensor,
    i: int,
    n_iters: Optional[torch.Tensor] = None,
    running: Optional[torch.Tensor] = None,
    want_scales: bool = False,
) -> Tuple[Carry, Optional[torch.Tensor]]:
    """``power_step_plain``'s results: CPU tensors run it; CUDA tensors
    launch the step kernel once (a window of one step, set up for
    this call) or raise — there is no fallback for a CUDA tensor. The new
    carry and the scales are fresh allocations; the plan's scratch is
    used by one stream at a time."""
    if carry[0][0].device.type == "cpu":
        return power_step_plain(plan, products, carry, residuals, i, n_iters, running,
                                want_scales)
    win = StepWindow(plan, carry, residuals, n_iters, running)
    return win.step(products, i, want_scales)


# Launches of the step kernels (a plain int; StepWindow.step is the one
# place that launches them: one a step, normalized or not), and the same
# by instantiation (``GridPlan.kernel_name``: step_grid<S>,
# step_grid_group<S>, step_grid_units).
power_step.launches = 0
power_step.by_kernel = Counter()


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
    i32 = ctypes.c_int32
    lib.mr_power_step_config.restype = ctypes.c_int
    lib.mr_power_step_config.argtypes = [ctypes.c_int, ctypes.POINTER(i32)]
    lib.mr_step_window_create.restype = ctypes.c_int
    lib.mr_step_window_create.argtypes = [
        ctypes.POINTER(ptr), ctypes.POINTER(ctypes.c_int64),  # ptrs, ns
        ctypes.c_float, ctypes.c_float, ctypes.c_float,       # alpha, d, tol
        i32, i32, i32,                                        # normalize, n_steps, n_windows
        ptr, ptr, ptr, ptr, ptr,                              # scratch, residuals, n_iters, running, scales
        ctypes.c_int, ptr, ctypes.c_int64,                    # device, stream, max_blocks
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ptr),  # plan, out handle
    ]
    lib.mr_step_window_free.restype = None
    lib.mr_step_window_free.argtypes = [ptr]
    lib.mr_step_window_run.restype = ctypes.c_int
    lib.mr_step_window_run.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr,                    # handle, the six products
        i32, i32, i32, i32,                                   # in_slot, out_slot, step, want_scales
    ]
    lib.mr_power_step_error_string.restype = ctypes.c_char_p
    lib.mr_power_step_error_string.argtypes = [ctypes.c_int]
    return lib


__all__ = [
    "KERNEL_GROUP",
    "KERNEL_UNITS",
    "KERNEL_WINDOW",
    "STEP_MODES",
    "STEP_SCRATCH",
    "GridPlan",
    "KernelConfig",
    "StepPlan",
    "StepWindow",
    "f32_value",
    "grid_plan",
    "kernel_config",
    "power_step",
    "power_step_plain",
    "slots_for",
    "step_plan",
    "step_scratch",
    "step_scratch_size",
]
